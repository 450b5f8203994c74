"""The three pieces of ``jax.random`` that the int8 KV pool's stochastic
rounding uses, in plain torch integer ops, bit for bit.

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
  maps the top 23 bits to a float32 in [0, 1).

Keys broadcast: a key may be a pair of ``[N]`` tensors, which gives N
independent streams in one call (the engine's per-position table).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

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


def uniform(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``. A key of ``[N]`` word
    tensors gives ``[N, *shape]``."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=key[1].device)
    k0, k1 = (k.reshape(-1, 1) if k.dim() else k for k in key)
    a, b = threefry2x32(k0, k1, i >> 32, i & _MASK)
    bits = ((a ^ b) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lead = tuple(key[0].shape)
    return f.reshape(*lead, *shape)
