"""The pieces of ``jax.random`` that the port reproduces, in plain torch
integer ops, bit for bit: those the int8 KV pool's stochastic rounding uses
and those the on-disk image path's augmentation draws (data/ondisk.py).

The reference quantises a K or V row at stream position p with the uniform
draws ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), tag), p),
(H, dh))`` (``ddlbench_tpu/ops/paged_decode.py`` ``_kv_quantize``). To
write the same int8 bytes, the port computes the same bits: Threefry-2x32
with 20 rounds (Salmon et al., SC'11) as JAX implements it, with JAX's
partitionable counter layout (``jax_threefry_partitionable``, the default
since jax 0.5). Values are int64 tensors holding 32-bit words; every
addition is masked back to 32 bits.

* ``prng_key(s)`` is the key ``(0, s)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, 0, d)``;
* ``uniform(key, shape)`` hashes the flat index i of each element as the
  counter ``(i >> 32, i & 0xffffffff)``, XORs the two output words, and
  maps the top 23 bits to a float32 in [0, 1);
* ``split(key, n)`` is the n keys ``threefry2x32(key, 0, i)``;
* ``randint(key, shape, lo, hi)`` (int32) hashes two words per element,
  one under each key of ``split(key)``, and folds them into [lo, hi) with
  JAX's uint32 arithmetic: ``((a % span) * m + b % span) % span`` with
  ``m = (2^16 % span)^2 % span``, every product wrapped to 32 bits;
* ``bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``.

Keys broadcast: a key may be a pair of ``[N]`` tensors, which gives N
independent streams in one call (the engine's per-position table).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Key = Tuple[torch.Tensor, torch.Tensor]


def _word(x: Word) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0: Word, k1: Word, x0: Word,
                 x1: Word) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds: the key (k0, k1) hashes the counter
    (x0, x1) to two 32-bit words. Arguments broadcast."""
    k0, k1, x0, x1 = (_word(t) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    return _word(0), _word(seed)


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` may be a tensor of
    counters, which gives one key per element."""
    return threefry2x32(key[0], key[1], 0, data)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` as a list of ``num`` keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of 32-bit
    words: the flat index i of each element hashed as the counter
    ``(i >> 32, i & 0xffffffff)``, the two output words XORed. A key of
    ``[N]`` word tensors gives ``[N, *shape]``."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=key[1].device)
    k0, k1 = (k.reshape(-1, 1) if k.dim() else k for k in key)
    a, b = threefry2x32(k0, k1, i >> 32, i & _MASK)
    lead = tuple(key[0].shape)
    return (a ^ b).reshape(*lead, *shape)


def uniform(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``. A key of ``[N]`` word
    tensors gives ``[N, *shape]``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: Key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, the
    default type; ``minval <= maxval <= 2^31 - 1``) as an int64 tensor."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = max(maxval - minval, 1) & _MASK
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    return minval + (off & _MASK) % span


def bernoulli(key: Key, p: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (float32 draws): a bool
    tensor."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
