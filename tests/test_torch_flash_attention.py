"""The port's flash attention (ddlbench_tpu_torch/ops/flash_attention.py)
held against the JAX reference's Pallas kernels in interpret mode.

On the CPU the port's wrappers take their plain versions (the CUDA kernels
are held against those on the card: tests/test_torch_cuda_kernels.py), so
this pins the semantics both share: o, the row logsumexp, and dq/dk/dv
through the autograd Function, over causal, offset, prefix-LM, fully
masked and uneven-length cases. The JAX side runs
``flash_attention(..., interpret=True)`` with 16-blocks under
``jax.default_matmul_precision("highest")``.

Tolerance: rtol 1e-4, atol 1e-5 in float32 (as tests/test_flash_attention.py
holds the reference's kernel against its own einsum): the two sides sum
in different orders, the reference blockwise with an online softmax.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.ops.flash_attention import _flash_fwd_impl
from ddlbench_tpu.ops.flash_attention import flash_attention as jax_flash

from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.ops import flash_attention as port

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK = 16


def _inputs(seed, B, H, Tq, Tk, dh=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, Tq, dh), f(B, H, Tk, dh), f(B, H, Tk, dh), f(B, H, Tq, dh)


def _port(q, k, v, g, q_offset, k_offset, prefix_len):
    """(o, lse, dq, dk, dv) of the port, as numpy."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = port.flash_attention(qt, kt, vt, q_offset, k_offset, prefix_len)
    o.backward(torch.from_numpy(g))
    _, lse = port.flash_fwd(qt.detach(), kt.detach(), vt.detach(), q_offset,
                            k_offset, prefix_len)
    return (o.detach().numpy(), lse.numpy(), qt.grad.numpy(),
            kt.grad.numpy(), vt.grad.numpy())


def _jax(fn, q, k, v, g):
    """(o, dq, dk, dv) of a JAX attention fn(q, k, v)."""
    with jax.default_matmul_precision("highest"):
        args = tuple(jnp.asarray(a) for a in (q, k, v))
        o, vjp = jax.vjp(fn, *args)
        return (np.asarray(o),) + tuple(np.asarray(d)
                                        for d in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("B,H,Tq,Tk,q_offset,k_offset,prefix_len", [
    (2, 3, 64, 64, 0, 0, 0),     # causal
    (1, 2, 32, 64, 32, 0, 0),    # the second half's queries over all keys
    (1, 2, 64, 64, 0, 0, 8),     # prefix-LM, prefix on a block edge
    (1, 2, 64, 64, 0, 0, 24),    # prefix-LM, prefix inside a block
])
def test_flash_matches_jax_interpret(B, H, Tq, Tk, q_offset, k_offset,
                                     prefix_len):
    q, k, v, g = _inputs(B * Tq + prefix_len, B, H, Tq, Tk)
    fn = lambda q, k, v: jax_flash(q, k, v, q_offset, k_offset, prefix_len,
                                   BLOCK, BLOCK, True)
    want = _jax(fn, q, k, v, g)
    with jax.default_matmul_precision("highest"):
        _, want_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), q_offset, k_offset,
                                      prefix_len, BLOCK, BLOCK, True, None)
    o, lse, dq, dk, dv = _port(q, k, v, g, q_offset, k_offset, prefix_len)
    np.testing.assert_allclose(o, want[0], **TOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse).reshape(B, H, Tq),
                               **TOL)
    for got, ref in zip((dq, dk, dv), want[1:]):
        np.testing.assert_allclose(got, ref, **TOL)


def test_fully_masked_rows_give_zero_output_and_finite_grads():
    """Keys at absolute positions 16..47 against queries 0..31: queries
    0..15 see no key. Their output is 0, their lse ~-1e30, and every
    gradient is finite (the mask selects before the multiply)."""
    q, k, v, g = _inputs(5, 1, 2, 32, 32)
    fn = lambda q, k, v: jax_flash(q, k, v, 0, 16, 0, BLOCK, BLOCK, True)
    want = _jax(fn, q, k, v, g)
    o, lse, dq, dk, dv = _port(q, k, v, g, 0, 16, 0)
    assert (o[:, :, :16] == 0).all()
    assert (lse[:, :, :16] < -1e29).all()
    for got, ref in zip((o, dq, dk, dv), want):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **TOL)
    assert (dq[:, :, :16] == 0).all()


def test_uneven_length_matches_jax_causal_attention():
    """T 40, which no 16-block divides: the port has no divisor rule; held
    against the reference's plain causal_attention."""
    q, k, v, g = _inputs(6, 2, 2, 40, 40)
    want = _jax(jtr.causal_attention, q, k, v, g)
    got = _port(q, k, v, g, 0, 0, 0)
    for a, b in zip((got[0],) + got[2:], want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("q_offset,k_offset,prefix_len",
                         [(0, 0, 0), (8, 0, 0), (0, 0, 12)])
def test_plain_causal_attention_matches_jax(q_offset, k_offset, prefix_len):
    """The port's plain (xla) path, prefix_len included, against the
    reference's plain causal_attention, values and gradients."""
    q, k, v, g = _inputs(7, 1, 2, 24, 32)
    fn = lambda q, k, v: jtr.causal_attention(q, k, v, q_offset, k_offset,
                                              prefix_len)
    want = _jax(fn, q, k, v, g)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ttr.set_attention_backend("xla")
    try:
        o = ttr.causal_attention(qt, kt, vt, q_offset, k_offset, prefix_len)
    finally:
        ttr.set_attention_backend("auto")
    o.backward(torch.from_numpy(g))
    for a, b in zip((o.detach(), qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_backend_dispatch_and_counters_on_cpu():
    """"flash" routes through the autograd Function (its plain versions on
    the CPU); "auto" takes the plain einsum for CPU tensors; the kernels'
    launch counters do not move on the CPU."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(8, 1, 2, 16, 16))
    before = (port.flash_fwd.launches, port.flash_dq.launches,
              port.flash_dkv.launches)
    try:
        ttr.set_attention_backend("flash")
        flash = ttr.causal_attention(q.requires_grad_(), k, v)
        assert flash.grad_fn.name().endswith("_FlashAttentionBackward")
        ttr.set_attention_backend("auto")
        plain = ttr.causal_attention(q, k, v)
        assert "Flash" not in plain.grad_fn.name()
        with pytest.raises(ValueError, match="unknown attention backend"):
            ttr.set_attention_backend("pallas")
    finally:
        ttr.set_attention_backend("auto")
    torch.testing.assert_close(flash, plain, **TOL)
    flash.sum().backward()
    assert (port.flash_fwd.launches, port.flash_dq.launches,
            port.flash_dkv.launches) == before
