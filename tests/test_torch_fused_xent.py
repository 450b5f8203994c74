"""The port's fused LM-head loss (ddlbench_tpu_torch/ops/fused_xent.py) held
against the JAX reference (ddlbench_tpu/ops/fused_xent.py).

The reference runs as its own tests run it (tests/test_fused_xent.py): the
Pallas kernels in interpret mode (``backend="pallas", interpret=True``) and
the chunked XLA scan (``backend="xla"``). The port runs its wrappers on CPU
tensors, which take the kernels' plain versions (the kernels themselves are
held against those on the card in test_torch_cuda_kernels.py). Inputs come
from numpy with a seed and go to both packages.

Tolerances in float32: the sums within rtol 1e-5 and ``correct`` exact
(the reference's own bar); gradients within rtol 1e-4, atol 1e-5 (its
gradient bar). Both sides run the same float32 math in other summation
orders. The bfloat16 case has its own stated tolerance.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.ops import fused_xent as jfx

from ddlbench_tpu_torch.ops import fused_xent as fx

pytestmark = pytest.mark.torchport

VAL = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _inputs(n, D, V, seed, mask_every=5, w_scale=0.3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * w_scale).astype(np.float32)
    labels = rng.integers(0, V, n).astype(np.int32)
    if mask_every:
        labels[::mask_every] = -1
    return h, w, labels


def _jax(h, w, labels, smoothing, backend, chunk=8):
    interpret = backend == "pallas"
    return jfx.fused_linear_xent(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(labels), smoothing, chunk,
                                 backend, interpret)


def _port(h, w, labels, smoothing, grad=False):
    ht = torch.from_numpy(h).requires_grad_(grad)
    wt = torch.from_numpy(w).requires_grad_(grad)
    out = fx.fused_linear_xent(ht, wt, torch.from_numpy(labels).long(),
                               smoothing)
    return out, ht, wt


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("V", [40, 96])
@pytest.mark.parametrize("n", [7, 24, 25, 70])
def test_values_match_jax(n, V, smoothing):
    h, w, labels = _inputs(n, 16, V, seed=n + V)
    (obj, ce, corr), _, _ = _port(h, w, labels, smoothing)
    for backend in ("pallas", "xla"):
        jo, jc, jk = _jax(h, w, labels, smoothing, backend)
        np.testing.assert_allclose(obj.item(), float(jo), **VAL)
        np.testing.assert_allclose(ce.item(), float(jc), **VAL)
        assert int(corr) == int(jk), backend
    if not smoothing:
        assert obj.item() == ce.item()


def _grads(f, h, w):
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))


@pytest.mark.parametrize("which", ["obj", "ce", "combined"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_grads_match_jax(smoothing, which):
    """dh and dW of the objective sum, the ce sum, and 0.7 obj + 0.3 ce
    (both cotangents non-zero) against both reference backends."""
    h, w, labels = _inputs(70, 16, 96, seed=3, mask_every=7)
    weights = {"obj": (1.0, 0.0), "ce": (0.0, 1.0),
               "combined": (0.7, 0.3)}[which]
    (obj, ce, _), ht, wt = _port(h, w, labels, smoothing, grad=True)
    (weights[0] * obj + weights[1] * ce).backward()
    for backend in ("pallas", "xla"):
        def f(hh, ww, backend=backend):
            o, c, _ = jfx.fused_linear_xent(hh, ww, jnp.asarray(labels),
                                            smoothing, 8, backend,
                                            backend == "pallas")
            return weights[0] * o + weights[1] * c

        gh, gw = _grads(f, h, w)
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **GRAD)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **GRAD)


def test_multiblock_vocab_matches_jax(monkeypatch):
    """The reference's Pallas kernels over several vocab and row blocks
    (V_BLOCK 32, ROW_BLOCK 16: 5 vocab blocks, 3 row blocks, the last
    padded), as tests/test_fused_xent.py forces them."""
    monkeypatch.setattr(jfx, "V_BLOCK", 32)
    monkeypatch.setattr(jfx, "ROW_BLOCK", 16)
    h, w, labels = _inputs(33, 8, 160, seed=4, mask_every=0, w_scale=0.5)
    labels[5] = -1
    (obj, ce, corr), ht, wt = _port(h, w, labels, 0.1, grad=True)
    jo, jc, jk = _jax(h, w, labels, 0.1, "pallas", chunk=512)
    np.testing.assert_allclose(obj.item(), float(jo), **VAL)
    np.testing.assert_allclose(ce.item(), float(jc), **VAL)
    assert int(corr) == int(jk)
    obj.backward()
    gh, gw = _grads(lambda hh, ww: jfx.fused_linear_xent(
        hh, ww, jnp.asarray(labels), 0.1, 512, "pallas", True)[0], h, w)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **GRAD)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **GRAD)


def test_all_masked_rows_give_zero_sums_and_grads():
    h = np.ones((8, 4), np.float32)
    w = np.ones((4, 10), np.float32)
    labels = np.full(8, -1, np.int32)
    (obj, ce, corr), ht, wt = _port(h, w, labels, 0.1, grad=True)
    assert obj.item() == 0.0 and ce.item() == 0.0 and int(corr) == 0
    (obj + ce).backward()
    assert torch.count_nonzero(ht.grad) == 0
    assert torch.count_nonzero(wt.grad) == 0
    jo, jc, jk = jfx.fused_linear_xent(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(labels))
    assert float(jo) == float(jc) == 0.0 and int(jk) == 0


def test_zero_head_ties_take_the_first_index():
    """W = 0: every logit ties, the argmax is class 0 (the first index),
    so ``correct`` counts the valid rows labelled 0 — as the reference's
    Pallas kernel (first occurrence within a block, strict > across)."""
    h, _, labels = _inputs(40, 16, 48, seed=6)
    labels[1:12:2] = 0
    w = np.zeros((16, 48), np.float32)
    (_, _, corr), _, _ = _port(h, w, labels, 0.0)
    want = int(((labels == 0)).sum())
    assert want > 0 and int(corr) == want
    _, _, jk = _jax(h, w, labels, 0.0, "pallas")
    assert int(jk) == want


def test_bf16_matches_jax():
    """bfloat16 h and W against the reference's Pallas kernels on the same
    bfloat16 values. Both compute z from exact products in float32 and
    round dz to bfloat16 before the products, so the sums agree to float32
    summation order (rtol 1e-5); dh and dW are rounded to bfloat16 once at
    the end, so each element may differ by one bfloat16 ulp where the two
    float32 sums straddle a rounding boundary: within 2^-7 relative of its
    own magnitude plus atol 1e-5."""
    h, w, labels = _inputs(70, 32, 96, seed=8, mask_every=7)
    hb = torch.from_numpy(h).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    hj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    wj = jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16)
    ht, wt = hb.clone().requires_grad_(), wb.clone().requires_grad_()
    obj, ce, corr = fx.fused_linear_xent(ht, wt,
                                         torch.from_numpy(labels).long(), 0.1)
    (0.7 * obj + 0.3 * ce).backward()
    assert ht.grad.dtype == wt.grad.dtype == torch.bfloat16

    def f(hh, ww):
        o, c, _ = jfx.fused_linear_xent(hh, ww, jnp.asarray(labels), 0.1,
                                        512, "pallas", True)
        return 0.7 * o + 0.3 * c

    jo, jc, jk = jfx.fused_linear_xent(hj, wj, jnp.asarray(labels), 0.1, 512,
                                       "pallas", True)
    np.testing.assert_allclose(obj.item(), float(jo), **VAL)
    np.testing.assert_allclose(ce.item(), float(jc), **VAL)
    assert int(corr) == int(jk)
    gh, gw = jax.grad(f, argnums=(0, 1))(hj, wj)
    for got, want in ((ht.grad, gh), (wt.grad, gw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("zero_head", [False, True])
def test_eval_matches_jax(zero_head):
    """(ce_sum, correct, correct_topk, valid) against the reference's
    chunked eval scan; the zero head makes every logit tie, pinning the
    torch.topk tie order of correct_topk."""
    h, w, labels = _inputs(37, 12, 50, seed=5, mask_every=6)
    if zero_head:
        w[:] = 0.0
    got = fx.fused_linear_xent_eval(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(labels).long(), 5, 8)
    want = jfx.fused_linear_xent_eval(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(labels), 5, 8)
    np.testing.assert_allclose(got[0].item(), float(want[0]), **VAL)
    for g, j in zip(got[1:], want[1:]):
        assert int(g) == int(j)
    assert int(got[3]) == int((labels >= 0).sum())


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: after a forward and a backward
    the three launch counters have not moved."""
    counters = (fx.fxent_fwd, fx.fxent_dh, fx.fxent_dw)
    before = [f.launches for f in counters]
    h, w, labels = _inputs(20, 16, 40, seed=9)
    (obj, ce, _), ht, wt = _port(h, w, labels, 0.1, grad=True)
    (obj + ce).backward()
    assert ht.grad is not None and wt.grad is not None
    assert [f.launches for f in counters] == before


def test_plain_versions_chunk_rows():
    """The plain versions give the same per-row outputs and gradients
    whatever their row chunk (they bound CPU memory by chunking)."""
    h, w, labels = _inputs(70, 16, 96, seed=10)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    lt = torch.from_numpy(labels)
    coef = torch.tensor([1.0, 0.9, 0.1 / 96])
    whole = fx._fxent_fwd_ref(ht, wt, lt, row_chunk=512)
    parts = fx._fxent_fwd_ref(ht, wt, lt, row_chunk=16)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    lse = whole[0]
    torch.testing.assert_close(fx._fxent_dh_ref(ht, wt, lt, lse, coef, 512),
                               fx._fxent_dh_ref(ht, wt, lt, lse, coef, 16))
    torch.testing.assert_close(fx._fxent_dw_ref(ht, wt, lt, lse, coef, 512),
                               fx._fxent_dw_ref(ht, wt, lt, lse, coef, 16))
