"""The port's sequence parallelism held to the reference's.

* ``flash_attention_lse`` (ops/flash_attention.py; on the CPU the plain
  versions of B1-B3) against the reference's in interpret mode: o, lse
  and the gradients of q, k and v under random cotangents of both
  outputs (a nonzero lse cotangent shifts delta), for a causal block, the
  ring's fully visible block at absolute offsets, and a prefix block;
  within rtol 1e-5, atol 1e-5.
* ``ring_attention`` (models/transformer.py) on gloo ranks of
  tests/torch_dp_ranks.RankPool at worlds 2 and 4 against the
  reference's ``ring_attention`` under shard_map on 2 and 4 virtual CPU
  devices, causal and prefix-LM, under the ``xla`` backend (both sides'
  online-softmax einsum ring) and ``flash`` (the port's
  ``flash_attention_lse`` ring; the reference's flash ring where it has
  one, causal, and its einsum ring for the prefix): the output and the
  q/k/v gradients within rtol 1e-4, atol 1e-5.
* The sp step (parallel/sp.py) on transformer_t, on the MoE model
  (capacity factor 8, aux weight 0.01: the aux term is each shard's,
  averaged over the ranks) and on a tiny seq2seq (the prefix ring) against
  the reference's ``SPStrategy`` at 2 and 4 ranks and devices, from the
  same weights (convert.from_jax_params) and batches: two steps' losses
  and accuracies, every parameter after them, and the eval sums, within
  rtol 1e-4, atol 1e-6 (test_torch_dp.py's bar).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ddlbench_tpu.models import transformer as jax_tr
from ddlbench_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_lse)
from ddlbench_tpu.parallel.gpipe import _shard_map
from ddlbench_tpu.parallel.sp import SPStrategy as JaxSP
from torch_dp_ranks import RankPool
from torch_shard_ref import compare_step
from torch_shard_ranks import TINY_SRC

from ddlbench_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torchport

LSE_TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("Tq,Tk,qo,ko,pre", [
    (16, 16, 0, 0, 0),  # the diagonal block
    (8, 8, 8, 0, 0),  # the ring's fully visible block, absolute offsets
    (16, 16, 0, 0, 5),  # prefix-LM
])
def test_flash_attention_lse_matches_reference(Tq, Tk, qo, ko, pre):
    rng = np.random.default_rng(0)
    q, do = _normal(rng, 1, 2, Tq, 8), _normal(rng, 1, 2, Tq, 8)
    k, v = _normal(rng, 1, 2, Tk, 8), _normal(rng, 1, 2, Tk, 8)
    g_lse = _normal(rng, 1, 2, Tq)

    def ref(q, k, v):
        return jax_flash_lse(q, k, v, qo, ko, pre, interpret=True)

    with jax.default_matmul_precision("highest"):
        (o_r, lse_r), vjp = jax.vjp(ref, q, k, v)
        grads_r = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention_lse(qt, kt, vt, qo, ko, pre)
    grads = torch.autograd.grad((o, lse), (qt, kt, vt),
                                (torch.from_numpy(do),
                                 torch.from_numpy(g_lse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_r),
                               **LSE_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_r),
                               **LSE_TOL)
    for got, want in zip(grads, grads_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LSE_TOL)
    # the lse cotangent moved the gradients
    plain = torch.autograd.grad(fa.flash_attention_lse(qt, kt, vt, qo, ko,
                                                       pre)[0], qt,
                                torch.from_numpy(do))[0]
    assert not np.allclose(plain.numpy(), grads[0].numpy(), atol=1e-4)


def _jax_ring(q, k, v, g, n, prefix_len, backend):
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, None, "seq")

    def ringed(q, k, v):
        return _shard_map(
            lambda a, b, c: jax_tr.ring_attention(a, b, c, "seq",
                                                  prefix_len=prefix_len),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)(q, k, v)

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(ringed, q, k, v)
        return (out, *vjp(g))

    jax_tr.set_attention_backend(backend)
    try:
        with jax.default_matmul_precision("highest"):
            return out_and_grads(q, k, v, g)
    finally:
        jax_tr.set_attention_backend("auto")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("prefix_len", [0, 12])
@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_ring_attention_matches_reference(ranks, backend, prefix_len,
                                          world):
    rng = np.random.default_rng(1)
    q, k, v, g = (_normal(rng, 1, 2, 32, 8) for _ in range(4))
    want = _jax_ring(q, k, v, g, world, prefix_len, backend)
    got = ranks.run("torch_shard_ranks:ring", world, q=q, k=k, v=v, g=g,
                    prefix_len=prefix_len, backend=backend)
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        full = np.concatenate([r[i] for r in got], axis=2)
        np.testing.assert_allclose(full, np.asarray(want[i]), **RING_TOL,
                                   err_msg=name)


SP_CFG = dict(benchmark="synthtext", compute_dtype="float32", momentum=0.5,
              weight_decay=0.0, batch_size=2)


@pytest.mark.parametrize("model,world", [
    ("transformer_t", 2), ("transformer_t", 4), ("moe_t", 2), ("moe_t", 4),
    ("seq2seq_t", 4),
])
def test_sp_step_matches_reference(ranks, model, world):
    cfg = dict(SP_CFG)
    if model == "moe_t":
        cfg.update(arch="transformer_moe_t", moe_aux_weight=0.01)
    if model == "seq2seq_t":
        cfg.update(benchmark="synthmt", arch="seq2seq_s",
                   label_smoothing=0.1, optimizer="sgd")
    compare_step(ranks, "sp", JaxSP, model, world, cfg, 2,
                 src_len=TINY_SRC if model == "seq2seq_t" else 0)


def test_sp_refuses_what_the_reference_refuses():
    from ddlbench_tpu_torch.config import RunConfig

    with pytest.raises(ValueError, match="token or seq2seq"):
        RunConfig(strategy="sp", num_devices=2,
                  benchmark="mnist").validate()
    with pytest.raises(ValueError, match="one-apply"):
        RunConfig(strategy="sp", num_devices=2, benchmark="synthtext",
                  arch="transformer_s", remat_layers=True).validate()
    with pytest.raises(ValueError, match="grad_accum_steps"):
        RunConfig(strategy="sp", num_devices=2, benchmark="synthtext",
                  arch="transformer_s", grad_accum_steps=2).validate()
