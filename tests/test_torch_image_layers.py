"""The port's image layers (ddlbench_tpu_torch/models/layers.py) held
against the JAX reference's primitives (ddlbench_tpu/models/layers.py).

Each primitive is built in both packages at a tiny size (8x8 or 7x7 maps,
widths 4-16), the port's carrying the reference's weights and BatchNorm
state (convert.from_jax_params, convert.from_jax_state). One numpy batch
goes through both, NHWC into the reference and its NCHW transpose into
the port, in float32, with a fixed random cotangent on the output:

* train mode: the output, the input gradient and every parameter gradient
  within rtol 1e-4, atol 1e-5; the updated running mean and variance
  within rtol 1e-5 (both sides reduce the same float32 values, in
  different orders);
* eval mode (the running statistics of a train step): the output within
  rtol 1e-4, atol 1e-5.

Also pinned: XLA's SAME padding (asymmetric on stride 2 of an even size)
for convolutions and max pools, VGG's (H, W, C) flatten order,
MobileNetV2's ReLU/ReLU6 split and residual rule, the refusal of a map
that vanishes (the reference's VGG on mnist), and the refusal of per-layer
remat over BatchNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.layers as jl
from ddlbench_tpu.models.layers import LayerModel as JaxLayerModel
from ddlbench_tpu.models.layers import init_model

import ddlbench_tpu_torch.models.layers as tl
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        to_port_layout)
from ddlbench_tpu_torch.models.layers import LayerModel, apply_slice

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-5)
STATS_RTOL = 1e-5
B = 2


def _gen():
    return torch.Generator().manual_seed(0)


# name -> (reference constructor, port constructor (in_shape) -> layer)
PRIMITIVES = {
    "conv_bn_s1": (lambda: jl.conv_bn("c", 8, kernel=3, stride=1),
                   lambda s: tl.ConvBN("c", s, 8, 3, 1, gen=_gen())),
    "conv_bn_s2": (lambda: jl.conv_bn("c", 8, kernel=3, stride=2),
                   lambda s: tl.ConvBN("c", s, 8, 3, 2, gen=_gen())),
    "conv_bn_7x7_s2_norelu": (
        lambda: jl.conv_bn("c", 8, kernel=7, stride=2, relu=False),
        lambda s: tl.ConvBN("c", s, 8, 7, 2, relu=False, gen=_gen())),
    "max_pool_same": (
        lambda: jl.max_pool("p", window=3, stride=2, padding="SAME"),
        lambda s: tl.MaxPool("p", s, 3, 2, "SAME")),
    "max_pool_valid": (lambda: jl.max_pool("p", window=2, stride=2),
                       lambda s: tl.MaxPool("p", s, 2, 2)),
    "gap": (lambda: jl.global_avg_pool(),
            lambda s: tl.GlobalAvgPool("gap", s)),
    "basic_identity": (lambda: jl.basic_block("b", 4, 1),
                       lambda s: tl.BasicBlock("b", s, 4, 1, gen=_gen())),
    "basic_projection": (lambda: jl.basic_block("b", 8, 2),
                         lambda s: tl.BasicBlock("b", s, 8, 2, gen=_gen())),
    "bottleneck_projection": (
        lambda: jl.bottleneck_block("b", 4, 2),
        lambda s: tl.Bottleneck("b", s, 4, 2, gen=_gen())),
    "bottleneck_identity": (
        lambda: jl.bottleneck_block("b", 1, 1),
        lambda s: tl.Bottleneck("b", s, 1, 1, gen=_gen())),
    "inverted_e1_residual": (
        lambda: jl.inverted_residual("i", 4, 1, 1),
        lambda s: tl.InvertedResidual("i", s, 4, 1, 1, gen=_gen())),
    "inverted_e6_residual": (
        lambda: jl.inverted_residual("i", 4, 1, 6),
        lambda s: tl.InvertedResidual("i", s, 4, 1, 6, gen=_gen())),
    "inverted_e6_s2": (
        lambda: jl.inverted_residual("i", 8, 2, 6),
        lambda s: tl.InvertedResidual("i", s, 8, 2, 6, gen=_gen())),
    "inverted_e1_widen": (
        lambda: jl.inverted_residual("i", 8, 1, 1),
        lambda s: tl.InvertedResidual("i", s, 8, 1, 1, gen=_gen())),
}


def _pair(make_j, make_t, in_shape, seed=0):
    """(reference model, params, state, port model) of one layer, the
    port's carrying the reference's weights and state."""
    jm = JaxLayerModel("one", [make_j()], tuple(in_shape), 10)
    params, states, shapes = init_model(jm, jax.random.key(seed))
    tm = LayerModel("one", [make_t(tuple(in_shape))], in_shape, 10)
    from_jax_params(tm, jax.device_get(params))
    from_jax_state(tm, jax.device_get(states))
    assert tm.layers[0].out_shape == tuple(shapes[-1])
    return jm, params, states, tm


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _check_layer(jm, params, states, tm, x, train):
    """Forward and backward of one layer on both sides, in ``train`` or
    eval mode; the port's layer updates its running statistics in place
    (train mode) and they are compared with the reference's new state."""
    y_shape = jax.eval_shape(
        lambda p, s, a: jm.layers[0].apply(p, s, a, train)[0], params[0],
        states[0], jnp.asarray(x)).shape
    g = np.random.default_rng(1).standard_normal(y_shape).astype(np.float32)

    def jloss(p, a):
        y, s2 = jm.layers[0].apply(p, states[0], a, train)
        return jnp.sum(y * g), (y, s2)

    (_, (want_y, want_s)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params[0], jnp.asarray(x))
    layer = tm.layers[0]
    layer.train(train)
    xt = _nchw(x).requires_grad_(True)
    y = apply_slice(tm.layers, xt, None)
    gt = _nchw(g) if g.ndim == 4 else torch.from_numpy(g)
    (y * gt).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_gx), **TOL)
    want_g = dict(_flat(want_gp))
    own = dict(layer.named_parameters())
    assert set(own) == set(want_g)
    for name, p in own.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   to_port_layout(want_g[name]), **TOL,
                                   err_msg=name)
    want_state = dict(_flat(want_s))
    bufs = dict(layer.named_buffers())
    assert set(bufs) == set(want_state)
    for name, b in bufs.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(want_state[name]),
                                   rtol=STATS_RTOL, atol=0, err_msg=name)
    return want_s


# the strided primitives also run on an odd size (SAME pads (1, 1) there)
STRIDED = ("conv_bn_s2", "conv_bn_7x7_s2_norelu", "max_pool_same",
           "max_pool_valid", "basic_projection", "bottleneck_projection",
           "inverted_e6_s2")


@pytest.mark.parametrize("name,hw", [(n, 8) for n in sorted(PRIMITIVES)]
                         + [(n, 7) for n in STRIDED])
def test_primitive_matches_jax(name, hw):
    """Train mode, then eval mode on the running statistics the train
    step left (the same on both sides)."""
    c = 4 if name.startswith(("basic_identity", "inverted_e1_residual",
                              "inverted_e6_residual")) else 3
    if name == "bottleneck_identity":
        c = 4
    jm, params, states, tm = _pair(*PRIMITIVES[name], (hw, hw, c))
    x = np.random.default_rng(0).standard_normal((B, hw, hw, c)).astype(
        np.float32)
    new_s = _check_layer(jm, params, states, tm, x, train=True)
    for layer in tm.layers:
        layer.zero_grad(set_to_none=True)
    _check_layer(jm, params, [new_s], tm, x, train=False)


@pytest.mark.parametrize("k,stride,n,groups", [
    (3, 1, 8, 1), (3, 2, 8, 1), (3, 1, 7, 1), (3, 2, 7, 1), (7, 2, 16, 1),
    (7, 2, 15, 1), (1, 2, 8, 1), (1, 1, 7, 1), (3, 2, 8, 4), (3, 1, 7, 4),
])
def test_conv2d_same_matches_jax(k, stride, n, groups):
    """The bare SAME convolution, forward and backward (the input and the
    kernel), stride 1 and 2 on even and odd sizes, and depthwise (groups
    = channels)."""
    rng = np.random.default_rng(k * 100 + stride * 10 + n)
    c, cout = 4, 4 if groups > 1 else 6
    x = rng.standard_normal((B, n, n, c)).astype(np.float32)
    w = rng.standard_normal((k, k, c // groups, cout)).astype(np.float32)
    m = -(-n // stride)
    g = rng.standard_normal((B, m, m, cout)).astype(np.float32)

    def jloss(x_, w_):
        y = jl.conv2d(x_, w_, stride, groups=groups)
        return jnp.sum(y * g), y

    (_, want), (gx, gw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(to_port_layout(w).copy()).requires_grad_(True)
    y = tl.conv2d(xt, wt, stride, groups)
    (y * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), to_port_layout(gw), **TOL)


@pytest.mark.parametrize("n,k,stride,want", [
    (56, 3, 2, (0, 1)), (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
    (57, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
    (8, 2, 2, (0, 0)),
])
def test_same_pads_are_xla_s(n, k, stride, want):
    """XLA pads total // 2 before and the rest after: more at the bottom
    and right where the total is odd (stride 2 on an even size)."""
    assert tl.same_pads(n, k, stride) == want
    pads = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")
    assert tuple(pads[0]) == want


def test_symmetric_padding_would_differ():
    """A stride-2 3x3 convolution with torch's symmetric padding=1 has the
    SAME output's shape but not its values: the trap the explicit pad
    avoids."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 2)).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(w), 2))
    wt = torch.from_numpy(to_port_layout(w).copy())
    sym = torch.nn.functional.conv2d(_nchw(x), wt, stride=2, padding=1)
    assert _nhwc(sym).shape == want.shape
    assert not np.allclose(_nhwc(sym), want, **TOL)
    np.testing.assert_allclose(_nhwc(tl.conv2d(_nchw(x), wt, 2)), want,
                               **TOL)


def test_max_pool_same_pads_with_minus_inf():
    """The stem pool (3x3/2 SAME) on an all-negative 8x8 map: the padded
    border never wins, as with XLA's -inf init."""
    x = -1.0 - np.random.default_rng(4).random((1, 8, 8, 2)).astype(
        np.float32)
    pool = jl.max_pool("p", 3, 2, "SAME")
    want, _ = pool.apply({}, {}, jnp.asarray(x), True)
    got = tl.MaxPool("p", (8, 8, 2), 3, 2, "SAME")(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    assert float(got.max()) < 0


def test_flatten_dense_keeps_the_nhwc_row_order():
    """flatten + dense on a spatial map (VGG's classifier above 64 px):
    the reference flattens (H, W, C), so its first dense rows are in that
    order; the port flattens the same way and uses the rows as given."""
    in_shape = (3, 3, 4)
    jm = JaxLayerModel("fd", [jl.flatten(), jl.dense("fc1", 5, relu=True),
                              jl.dense("fc2", 3)], in_shape, 3)
    params, states, _ = init_model(jm, jax.random.key(1))
    gen = _gen()
    tm = LayerModel("fd", [tl.Flatten("flatten", in_shape),
                           tl.Dense("fc1", (36,), 5, relu=True, gen=gen),
                           tl.Dense("fc2", (5,), 3, gen=gen)], in_shape, 3)
    from_jax_params(tm, jax.device_get(params))
    x = np.random.default_rng(5).standard_normal((B, *in_shape)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, a: jl.apply_model(jm, p, states, a,
                                                  True))(params,
                                                         jnp.asarray(x))
    got = apply_slice(tm.layers, _nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    # an NCHW flatten gives other features to the same rows
    nchw = _nchw(x).reshape(B, -1) @ tm.layers[1].w + tm.layers[1].b
    assert not np.allclose(torch.relu(nchw).detach().numpy(),
                           torch.relu(_nchw(x).permute(0, 2, 3, 1).reshape(
                               B, -1) @ tm.layers[1].w
                               + tm.layers[1].b).detach().numpy())


def test_mobilenet_relu_and_relu6():
    """A tiny MobileNetV2 chain (stem, blocks with expand 6 and 1, head
    conv) in eval mode on running variances of 0.01, so activations run
    far past 6: the port matches the reference only with ReLU after the
    stem and the head conv and ReLU6 inside the blocks. The residual is
    added only at stride 1 with matching widths."""
    in_shape = (8, 8, 3)
    chain = [("stem", 8, None), ("block1", 8, 6), ("block2", 16, 1),
             ("head_conv", 12, None)]
    jlayers, tlayers, shape = [], [], in_shape
    for name, c, t in chain:
        if t is None:
            jlayers.append(jl.conv_bn(name, c, kernel=3 if name == "stem"
                                      else 1))
            tlayers.append(tl.ConvBN(name, shape, c, 3 if name == "stem"
                                     else 1, gen=_gen()))
        else:
            jlayers.append(jl.inverted_residual(name, c, 1, t))
            tlayers.append(tl.InvertedResidual(name, shape, c, 1, t,
                                               gen=_gen()))
        shape = tlayers[-1].out_shape
    jm = JaxLayerModel("m", jlayers, in_shape, 12)
    params, states, _ = init_model(jm, jax.random.key(2))
    states = jax.tree.map(lambda a: a, states)
    for s in states:
        for bn in s.values():
            bn["var"] = jnp.full_like(bn["var"], 0.1)
    tm = LayerModel("m", tlayers, in_shape, 12)
    from_jax_params(tm, jax.device_get(params))
    from_jax_state(tm, jax.device_get(states))
    tm.eval()
    x = 2 * np.random.default_rng(6).standard_normal((B, *in_shape)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, s, a: jl.apply_model(jm, p, s, a, False))(
        params, states, jnp.asarray(x))
    with torch.no_grad():
        stem = tm.layers[0](_nchw(x))
        got = apply_slice(tm.layers, _nchw(x))
    assert float(stem.max()) > 6.0
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    assert tm.layers[1].residual and not tm.layers[2].residual
    assert not tl.InvertedResidual("i", (4, 4, 4), 4, 2, 6,
                                   gen=_gen()).residual


def test_a_vanishing_map_raises():
    """A window that takes the map to 0x0 raises at build, where the
    reference carries the empty map into a NaN mean."""
    with pytest.raises(ValueError, match="0x0"):
        tl.MaxPool("pool5", (1, 1, 512), 2, 2)
    jm = JaxLayerModel("v", [jl.max_pool("pool5", 2, 2)], (1, 1, 4), 4)
    _, _, shapes = init_model(jm, jax.random.key(0))
    assert tuple(shapes[-1]) == (0, 0, 4)


def test_remat_over_batchnorm_raises():
    """torch.utils.checkpoint would recompute BatchNorm and update its
    running statistics twice: a layer with BatchNorm refuses remat."""
    layer = tl.ConvBN("c", (8, 8, 3), 4, gen=_gen())
    with pytest.raises(NotImplementedError, match="running statistics"):
        apply_slice([layer], torch.randn(1, 3, 8, 8), None, remat=True)
    assert torch.equal(layer.bn.mean, torch.zeros(4))


def test_bf16_batchnorm_takes_f32_weights_and_stats():
    """Under a bfloat16 apply the BatchNorm call gets bfloat16 activations
    with float32 weights (the widened casts) and float32 running
    statistics, which stay float32 after the update; the output is
    bfloat16 and within bfloat16 rounding of the float32 result."""
    layer = tl.ConvBN("c", (8, 8, 3), 4, gen=_gen())
    x = torch.randn(2, 3, 8, 8)
    ref = tl.ConvBN("c", (8, 8, 3), 4, gen=_gen())
    y32 = apply_slice([ref], x, None)
    y16 = apply_slice([layer], x.bfloat16(), torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    assert layer.bn.mean.dtype == layer.bn.var.dtype == torch.float32
    assert layer.bn.scale.dtype == torch.float32
    err = (y16.float() - y32).norm() / y32.norm()
    assert err < 2 ** -6
