"""The port's transformer (ddlbench_tpu_torch/models/transformer.py) held
against the JAX reference (ddlbench_tpu/models/transformer.py) on the tiny
LM of tests/tiny_models.py, with the reference's weights carried over by
ddlbench_tpu_torch/convert.py.

Tolerance: f32 atol/rtol 1e-5 — the two sides run the same math but reduce
matrix products in different orders. The reference's numerics traps (tanh
GELU, one-pass LayerNorm, q|k|v thirds, NaN-filled out-of-range position
gathers) are pinned by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.ops.paged_decode import serve_pool_init as jax_pool_init
from tiny_models import TINY_LM, tiny_transformer

from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models.transformer import (build_transformer,
                                                   layer_norm)
from ddlbench_tpu_torch.ops.paged_decode import serve_pool_init

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB = TINY_LM.num_classes
D = 32


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model with the same weights)."""
    jm = tiny_transformer()
    params, _, _ = init_model(jm, jax.random.key(0))
    params_np = jax.device_get(params)
    tm = build_transformer("transformer_t", TINY_LM.image_size, VOCAB)
    from_jax_params(tm, params_np)
    return jm, params, params_np, tm


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_from_jax_params_round_trips(pair):
    jm, _, params_np, tm = pair
    assert len(tm.layers) == len(params_np) == 4
    for layer, tree in zip(tm.layers, params_np):
        own = dict(layer.named_parameters())
        given = dict(_flat(tree))
        assert set(own) == set(given)
        for name, arr in given.items():
            # dense weights stay [in, out]: copied as they are
            np.testing.assert_array_equal(own[name].detach().numpy(), arr)
    with pytest.raises(ValueError, match="do not match"):
        from_jax_params(tm, [params_np[0]] * 4)


def test_full_forward_logits_match_jax(pair):
    jm, params, _, tm = pair
    x = np.random.default_rng(0).integers(0, VOCAB, (2, 16)).astype(np.int32)
    h = jnp.asarray(x)
    for layer, p in zip(jm.layers, params):
        h, _ = layer.apply(p, {}, h, False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).long())
    assert got.shape == (2, 16, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    want = jtr.layer_norm({"scale": jnp.asarray(scale),
                           "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_trap_layer_norm_is_one_pass():
    """The reference's variance is one-pass, mean(x^2) - mean(x)^2, which
    cancellation can drive NEGATIVE in f32 at a large offset; it is
    clamped at 0 before the eps. Here the f32 one-pass variance is below
    -eps, so the unclamped formula gives NaN, and the port — like the
    reference — stays finite. (Away from such offsets the two agree at
    f32 tolerance: test_layer_norm_matches_jax.)"""
    x = torch.full((2, D), 3000.7) + torch.linspace(0.0, 1e-3, D)
    one, zero = torch.ones(D), torch.zeros(D)
    var1 = (x * x).mean(-1) - x.mean(-1) ** 2
    assert (var1 < -1e-5).all()  # the case the clamp exists for
    unclamped = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        var1[:, None] + 1e-5)
    assert torch.isnan(unclamped).all()
    got = layer_norm(x, one, zero)
    want = jtr.layer_norm({"scale": jnp.ones(D), "bias": jnp.zeros(D)},
                          jnp.asarray(x.numpy()))
    assert torch.isfinite(got).all() and np.isfinite(np.asarray(want)).all()


def test_trap_gelu_is_tanh_approximation():
    """jax.nn.gelu defaults to the tanh approximation: the block's MLP
    must match it, and the exact (erf) GELU measurably does not. Unit-scale
    weights make the activation's difference visible in the output."""
    from ddlbench_tpu_torch.models.transformer import TransformerBlock

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    w1 = rng.standard_normal((D, 4 * D)).astype(np.float32)
    b1 = rng.standard_normal(4 * D).astype(np.float32)
    w2 = rng.standard_normal((4 * D, D)).astype(np.float32) / 8
    ln = {"scale": jnp.ones(D), "bias": jnp.zeros(D)}
    pre = jtr.layer_norm(ln, jnp.asarray(x)) @ w1 + b1
    want = np.asarray(jnp.asarray(x) + jax.nn.gelu(pre) @ w2)
    blk = TransformerBlock(D, 4, torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.w1.copy_(torch.from_numpy(w1))
        blk.b1.copy_(torch.from_numpy(b1))
        blk.w2.copy_(torch.from_numpy(w2))
        got = blk.mlp(torch.from_numpy(x)).numpy()
        erf = (torch.from_numpy(x)
               + F.gelu(torch.from_numpy(np.array(pre))) @ blk.w2).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(erf, want, **TOL)


@pytest.mark.parametrize("prefix_len", [0, 5])
def test_block_forward_matches_jax(prefix_len):
    """A block's training forward, the prefix-LM mask included (seq2seq's),
    against the reference's transformer_block with the same weights; the
    prefix block measurably differs from the causal one."""
    from ddlbench_tpu_torch.models.transformer import TransformerBlock

    T = 12
    jb = jtr.transformer_block("b", D, 4, prefix_len=prefix_len)
    p, _, _ = jb.init(jax.random.key(1), (T, D))
    x = np.random.default_rng(10).standard_normal((2, T, D)).astype(np.float32)
    want, _ = jb.apply(p, {}, jnp.asarray(x), False)
    blocks = [TransformerBlock(D, 4, torch.Generator().manual_seed(0),
                               prefix_len=n) for n in (prefix_len, 0)]
    with torch.no_grad():
        for blk in blocks:
            for name, arr in _flat(jax.device_get(p)):
                blk.get_parameter(name).copy_(torch.from_numpy(np.array(arr)))
        got, causal = (blk(torch.from_numpy(x)).numpy() for blk in blocks)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.allclose(causal, np.asarray(want), **TOL) == (prefix_len == 0)


def test_trap_qkv_split_is_contiguous_thirds(pair):
    """wqkv's output splits into contiguous thirds q | k | v, each viewed
    [B, T, H, dh] (not interleaved per head)."""
    jm, params, _, tm = pair
    x = np.random.default_rng(4).standard_normal((1, 3, D)).astype(np.float32)
    want = jtr._qkv_heads(params[1], jnp.asarray(x), 4)
    with torch.no_grad():
        got = tm.layers[1]._qkv_heads(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_trap_out_of_range_prefill_positions_are_clamped(pair):
    """A padded prefill chunk running past the position table: the
    reference's jnp.take fills those rows with NaN, torch indexing would
    fault; the port clamps (the rows are discarded either way) and agrees
    with the reference on every in-range position."""
    jm, params, _, tm = pair
    T = TINY_LM.seq_len
    x = np.random.default_rng(5).integers(0, VOCAB, (1, 8)).astype(np.int32)
    start = T - 4
    want = np.asarray(jm.layers[0].serve.prefill(
        params[0], {}, None, None, jnp.asarray(x), start, 1, 4)[0])
    with torch.no_grad():
        got = tm.layers[0].serve_prefill(None, None,
                                         torch.from_numpy(x).long(), start,
                                         1, 4).numpy()
    assert np.isnan(want[:, 4:]).all()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :4], want[:, :4])


def _pool_pair(seed, n_pages, page, heads, dh):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((n_pages, page, heads, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, heads, dh)).astype(np.float32)
    jp = jax_pool_init(n_pages, page, heads, dh, jnp.float32)
    jp = {"pool_k": jp["pool_k"] + pk, "pool_v": jp["pool_v"] + pv}
    tp = serve_pool_init(n_pages, page, heads, dh, torch.float32,
                         torch.device("cpu"))
    tp["pool_k"] += torch.from_numpy(pk)
    tp["pool_v"] += torch.from_numpy(pv)
    return jp, tp


@pytest.mark.parametrize("start,npl", [(0, 2), (4, 3), (8, 4)])
def test_block_serve_prefill_matches_jax(pair, start, npl):
    jm, params, _, tm = pair
    page, C = 4, 8
    jp, tp = _pool_pair(6, 9, page, 4, 8)
    table = np.array([[3, 7, 1, 5, 2, 8]], np.int32)
    x = np.random.default_rng(7).standard_normal((1, C, D)).astype(np.float32)
    want, jp = jm.layers[1].serve.prefill(
        params[1], {}, jp, jnp.asarray(table), jnp.asarray(x),
        jnp.int32(start), npl, page)
    with torch.no_grad():
        got = tm.layers[1].serve_prefill(tp, torch.from_numpy(table),
                                         torch.from_numpy(x), start, npl,
                                         page)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("pool_k", "pool_v"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   **TOL)


@pytest.mark.parametrize("pos,npl", [((0, 5, 9), 3), ((3, 3, 0), 1)])
def test_block_serve_decode_matches_jax(pair, pos, npl):
    jm, params, _, tm = pair
    page = 4
    jp, tp = _pool_pair(8, 9, page, 4, 8)
    # row 2 is inactive: routed to the scratch slot, as the engine does
    table = np.array([[3, 7, 1], [5, 2, 8], [0, 0, 0]], np.int32)
    x = np.random.default_rng(9).standard_normal((3, 1, D)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want, jp = jm.layers[1].serve.decode(
        params[1], {}, jp, jnp.asarray(table), jnp.asarray(x),
        jnp.asarray(pos), npl, page)
    with torch.no_grad():
        got = tm.layers[1].serve_decode(tp, torch.from_numpy(table),
                                        torch.from_numpy(x),
                                        torch.from_numpy(pos), npl, page)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("pool_k", "pool_v"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   **TOL)
