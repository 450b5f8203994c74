"""The rest of the image zoo (lenet, alexnet, squeezenet, resnext50,
densenet121, inception, nasnet) held against the JAX reference on the CPU.

* Structure: each arch on each image benchmark has the reference's layer
  names (a branchy model's composite layers too), per-layer output
  shapes, parameter and state names and shapes (in the port's layout; a
  composite layer's k-th node's as ``<k>.<name>``) and parameter count,
  from ``jax.eval_shape`` and a meta-device build.
* The new primitives (plain convolution with bias, AvgPool, the
  separable convolution, the fire module, the grouped bottleneck, the
  dense block, the transition, the final BN-ReLU), in train and eval
  mode, on an even and an odd size: the output and the input's gradient
  within test_torch_image_layers' tolerances (rtol 1e-4, atol 1e-5);
  each parameter's gradient within 1e-4 relative L2, with
  test_torch_image_train's floor, and each running statistic within 1e-5
  relative L2. A block's inner BatchNorms see several layers' rounding:
  resnext's bn1.scale gradient is 2e-4 (the port) and 5e-4 (the
  reference) from the port's float64 gradient, so it is not held element
  by element.
* The traps, each with a planted fault that must break the match:
  AvgPool counts the padding (not excluding it, and not padded
  symmetrically); the channel concatenations keep the reference's order
  (squeezenet's fire module, densenet's block); resnext's grouped kernel
  keeps its group layout (not with the group axes swapped).
* One float32 SGD step and an eval of each arch at cifar10 width, batch
  2, from the reference's weights (imagenet's SGD: lr 0.1, momentum 0.9,
  weight decay 1e-4). The loss, each gradient leaf and each running
  statistic within max(1e-5 absolute / 1e-4 relative L2 with
  test_torch_image_train's floor, 5x the reference's own spread): the
  most the reference's value moves when its input is nudged by 2^-22 (a
  float32 rounding-level change), as the bfloat16 check of
  test_torch_image_train measures it. Measured on the CPU against the
  port's float64 step, the reference's float32 gradients are 1e-2
  (inception), 3e-2 (resnext50) and 2e-3 (densenet121) away where the
  port's are 1e-6, 8e-3 and 4e-6: its BatchNorm takes the variance in
  one float32 pass (E[x^2] - E[x]^2), which cancels on these maps, so a
  fixed 1e-4 bar would measure the reference's rounding. Each parameter
  after the step within 1e-4; the eval's loss within 1e-5 relative
  (absolute below 1: squeezenet's eval loss after that step is about
  6e12) and its counts equal, the eval run on the reference's updated
  weights and statistics on both sides.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ddlbench_tpu.models.extra as jx
import ddlbench_tpu.models.layers as jl
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.models.zoo import get_model as jax_get_model
import ddlbench_tpu.parallel.common as jcommon
from ddlbench_tpu.parallel.common import loss_and_grads as jax_loss_and_grads

import ddlbench_tpu_torch.models.extra as tx
import ddlbench_tpu_torch.models.layers as tl
from ddlbench_tpu_torch import config
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        to_port_layout)
from ddlbench_tpu_torch.models import branchy
from ddlbench_tpu_torch.models.zoo import EXTRA_ARCHS, get_model
from ddlbench_tpu_torch.parallel.common import loss_and_grads

from test_torch_image_layers import TOL, _nchw, _nhwc, _pair
from test_torch_image_train import (FLOOR, LEAF_RTOL, LOSS_ATOL, _batch,
                                    _pair_strategies, _rel_l2, _to_port)

pytestmark = pytest.mark.torchport

IMAGE_BENCHMARKS = ("mnist", "cifar10", "imagenet", "highres")


def _gen():
    return torch.Generator().manual_seed(0)


def _flat(tree, prefix=""):
    """Dotted leaf names of a param tree; a list's k-th entry is "k" (a
    composite layer's nodes)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _port_shape(shape):
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 \
        else tuple(shape)


@pytest.mark.parametrize("benchmark", IMAGE_BENCHMARKS)
@pytest.mark.parametrize("arch", EXTRA_ARCHS)
def test_model_structure_matches_jax(arch, benchmark):
    jm = jax_get_model(arch, benchmark)
    traced = {}

    def init(key):
        params, states, shapes = init_model(jm, key)
        traced["shapes"] = shapes
        return params, states

    params, states = jax.eval_shape(init, jax.random.key(0))
    shapes = traced["shapes"]
    with torch.device("meta"):
        tm = get_model(arch, benchmark)
    assert tm.in_shape == tuple(config.DATASETS[benchmark].image_size)
    assert [layer.name for layer in tm.layers] == \
        [layer.name for layer in jm.layers]
    n_ref = 0
    for i, layer in enumerate(tm.layers):
        assert layer.out_shape == tuple(shapes[i + 1]), layer.name
        for own, tree in ((dict(layer.named_parameters()), params[i]),
                          (dict(layer.named_buffers()), states[i])):
            ref = {n: _port_shape(a.shape) for n, a in _flat(tree)}
            assert {n: tuple(t.shape) for n, t in own.items()} == ref, \
                layer.name
        n_ref += sum(math.prod(a.shape) for _, a in _flat(params[i]))
    assert sum(p.numel() for p in tm.parameters()) == n_ref


def test_branchy_cuts_and_spans_match_jax():
    """The DAG forms' articulation cuts, spans, inputs and join rules."""
    from ddlbench_tpu.models import branchy as jb

    for arch in branchy.BRANCHY_ARCHS:
        jd = jb.get_dag(arch, (32, 32, 3), 10)
        with torch.device("meta"):
            td = branchy.get_dag(arch, (32, 32, 3), 10)
        assert [n.name for n in td.layers] == [n.name for n in jd.layers]
        assert td.inputs == [tuple(i) for i in jd.inputs]
        assert td.combine == jd.combine
        assert branchy.cut_positions(td) == jb.cut_positions(jd)
        assert branchy.block_spans(td) == jb.block_spans(jd)
    assert branchy.get_dag("resnet18", (32, 32, 3), 10) is None


# name -> (reference constructor, port constructor (in_shape) -> layer)
NEW_PRIMITIVES = {
    "conv_relu": (lambda: jx._conv_relu("c", 6, kernel=5),
                  lambda s: tl.ConvReLU("c", s, 6, 5, gen=_gen())),
    "conv_relu_s2": (lambda: jx._conv_relu("c", 6, kernel=3, stride=2),
                     lambda s: tl.ConvReLU("c", s, 6, 3, 2, gen=_gen())),
    "avg_pool_s1": (lambda: jl.avg_pool("a"),
                    lambda s: tl.AvgPool("a", s)),
    "avg_pool_s2": (lambda: jl.avg_pool("a", 3, 2),
                    lambda s: tl.AvgPool("a", s, 3, 2)),
    "sep_conv_bn_3": (lambda: jl.sep_conv_bn("s", 6, 3),
                      lambda s: tl.SepConvBN("s", s, 6, 3, gen=_gen())),
    "sep_conv_bn_5_s2": (lambda: jl.sep_conv_bn("s", 6, 5, 2),
                         lambda s: tl.SepConvBN("s", s, 6, 5, 2,
                                                gen=_gen())),
    "fire": (lambda: jx._fire("f", 3, 4),
             lambda s: tx.Fire("f", s, 3, 4, gen=_gen())),
    "resnext_projection": (
        lambda: jx._resnext_block("r", 64, 2),
        lambda s: tx.ResNeXtBlock("r", s, 64, 2, gen=_gen())),
    "resnext_identity": (
        lambda: jx._resnext_block("r", 32, 1),
        lambda s: tx.ResNeXtBlock("r", s, 32, 1, gen=_gen())),
    "dense_block": (lambda: jx._dense_block("d", 3, growth=4, bn_size=2),
                    lambda s: tx.DenseBlock("d", s, 3, 4, 2, gen=_gen())),
    "transition": (lambda: jx._transition("t", 4),
                   lambda s: tx.Transition("t", s, 4, gen=_gen())),
    "bn_relu": (lambda: jx._bn_relu("n"), lambda s: tx.BNReLU("n", s)),
}
# the input channels each primitive needs
_CHANNELS = {"resnext_projection": 32, "resnext_identity": 64}


STATS_REL_L2 = 1e-5


def _check_block(jm, params, states, tm, x, train):
    """Forward and backward of one layer on both sides in ``train`` or
    eval mode (module docstring); returns the reference's new state."""
    layer, jlayer = tm.layers[0], jm.layers[0]
    y_shape = jax.eval_shape(lambda p, s, a: jlayer.apply(p, s, a, train)[0],
                             params[0], states[0], jnp.asarray(x)).shape
    g = np.random.default_rng(1).standard_normal(y_shape).astype(np.float32)

    def jloss(p, a):
        y, s2 = jlayer.apply(p, states[0], a, train)
        return jnp.sum(y * g), (y, s2)

    (_, (want_y, want_s)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params[0], jnp.asarray(x))
    layer.train(train)
    layer.zero_grad(set_to_none=True)
    xt = _nchw(x).requires_grad_(True)
    y = layer(xt)
    (y * (_nchw(g) if g.ndim == 4 else torch.from_numpy(g))).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_gx), **TOL)
    want_g = dict(_flat(want_gp))
    own = dict(layer.named_parameters())
    assert set(own) == set(want_g)
    if own:
        pairs = [(p.grad, to_port_layout(want_g[n])) for n, p in own.items()]
        floor = FLOOR * max(np.linalg.norm(w) for _, w in pairs)
        for (name, _), (got, want) in zip(own.items(), pairs):
            assert _rel_l2(got, want, floor) <= LEAF_RTOL, name
    want_stats = dict(_flat(want_s))
    bufs = dict(layer.named_buffers())
    assert set(bufs) == set(want_stats)
    for name, b in bufs.items():
        w = np.asarray(want_stats[name], np.float64)
        err = np.linalg.norm(b.numpy() - w) / np.linalg.norm(w)
        assert err <= STATS_REL_L2, (name, err)
    return want_s


@pytest.mark.parametrize("hw", [8, 7])
@pytest.mark.parametrize("name", sorted(NEW_PRIMITIVES))
def test_new_primitive_matches_jax(name, hw):
    in_shape = (hw, hw, _CHANNELS.get(name, 5))
    x = np.random.default_rng(0).standard_normal(
        (2, *in_shape)).astype(np.float32)
    jm, params, states, tm = _pair(*NEW_PRIMITIVES[name], in_shape)
    new_s = _check_block(jm, params, states, tm, x, train=True)
    # eval mode on the running statistics the train step left
    _check_block(jm, params, [new_s], tm, x, train=False)


def _forward_pair(name, in_shape, seed=0):
    """The reference's train-mode output and the port's layer on the same
    input (NHWC numpy, NCHW tensor)."""
    jm, params, states, tm = _pair(*NEW_PRIMITIVES[name], in_shape)
    x = np.random.default_rng(seed).standard_normal(
        (2, *in_shape)).astype(np.float32)
    want = np.asarray(jm.layers[0].apply(params[0], states[0],
                                         jnp.asarray(x), True)[0])
    return want, tm.layers[0], _nchw(x)


def _close(got, want):
    return np.allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("name,hw", [("avg_pool_s2", 8), ("avg_pool_s1", 8),
                                     ("avg_pool_s2", 7)])
def test_avg_pool_counts_the_padding(name, hw):
    """The reference divides each window's sum by window² (padding
    counted), with XLA's SAME sides; excluding the padding breaks every
    case, padding symmetrically breaks the even stride-2 case."""
    want, layer, x = _forward_pair(name, (hw, hw, 3))
    assert _close(layer(x), want)
    k, s = layer.window, layer.stride
    excluding = F.avg_pool2d(x, k, s, padding=k // 2,
                             count_include_pad=False)
    assert not _close(excluding, want)
    if s == 2 and hw % 2 == 0:
        assert not _close(F.avg_pool2d(x, k, s, padding=k // 2), want)


def test_concat_order_is_the_references():
    """Fire: [1x1, 3x3]; the dense block: [running map, new channels]. The
    same layers concatenating the other way round do not match."""
    want, fire, x = _forward_pair("fire", (6, 6, 5))
    assert _close(fire(x), want)
    sq = F.relu(tl.conv2d(x, fire.sq))
    swapped = torch.cat([F.relu(tl.conv2d(sq, fire.e3)),
                         F.relu(tl.conv2d(sq, fire.e1))], dim=1)
    assert not _close(swapped, want)

    want, block, x = _forward_pair("dense_block", (6, 6, 5))
    assert _close(block(x), want)
    real = torch.cat
    torch.cat = lambda ts, dim=0: real(ts[::-1], dim=dim)
    try:
        block.train()
        with torch.no_grad():
            reversed_out = block(x)
    finally:
        torch.cat = real
    assert not _close(reversed_out, want)


def test_grouped_kernel_keeps_its_group_layout():
    """resnext's (width, width / 32, 3, 3) kernel, groups = 32: the port's
    layout matches; the same weights with the group axes swapped (the
    output channels regrouped as (width / 32, 32)) do not."""
    want, block, x = _forward_pair("resnext_projection", (8, 8, 32))
    assert block.c2.shape == (64, 2, 3, 3)
    assert _close(block(x), want)
    w = block.c2.detach()
    with torch.no_grad():
        block.c2.copy_(w.reshape(32, 2, 2, 3, 3).transpose(0, 1)
                       .reshape(64, 2, 3, 3))
    assert not _close(block(x), want)


def _leaves(model, tree, buffers=False):
    out = []
    for layer, ltree in zip(model.layers, tree):
        flat = dict(_flat(ltree))
        own = dict(layer.named_buffers() if buffers
                   else layer.named_parameters())
        assert set(own) == set(flat), layer.name
        out.extend((t, to_port_layout(jax.device_get(flat[n])))
                   for n, t in own.items())
    return out


F64_RTOL = 1e-9


def _batchnorm64(p, s, x, train: bool):
    """The reference's batchnorm (ddlbench_tpu/models/layers.py) with its
    batch statistics in the input's type, so a float64 apply is float64
    throughout (the reference takes them in float32)."""
    axes = tuple(range(x.ndim - 1))
    if train:
        mean = jnp.mean(x, axis=axes)
        var = jnp.maximum(jnp.mean(jnp.square(x), axis=axes)
                          - jnp.square(mean), 0.0)
        n = x.size // x.shape[-1]
        new_s = {"mean": (1 - jl.BN_MOMENTUM) * s["mean"]
                 + jl.BN_MOMENTUM * mean,
                 "var": (1 - jl.BN_MOMENTUM) * s["var"]
                 + jl.BN_MOMENTUM * var * (n / max(1, n - 1))}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    inv = jax.lax.rsqrt(var + jl.BN_EPS) * p["scale"]
    return x * inv + (p["bias"] - mean * inv), new_s


def _cross_entropy64(logits, labels, smoothing=0.0):
    """The reference's cross_entropy_loss in the logits' type (it takes
    float32)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def _reference64(monkeypatch, jm, jcfg, ts, x, y, tm):
    """The reference's training step applied in float64 (statistics and
    loss too): (loss, gradient leaves, updated running statistics), the
    leaves per port parameter and buffer in the port's layout."""
    monkeypatch.setattr(jl, "batchnorm", _batchnorm64)
    monkeypatch.setattr(jx, "batchnorm", _batchnorm64)
    monkeypatch.setattr(jcommon, "cross_entropy_loss", _cross_entropy64)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), jax.device_get(t))
        ce, _, state, g = jax.jit(lambda p, s, xb, yb: jax_loss_and_grads(
            jm, jcfg, p, s, xb, yb, jnp.float64, 0.0))(
            to64(ts.params), to64(ts.model_state),
            jnp.asarray(x, jnp.float64), jnp.asarray(y))
        return (float(ce), [np.asarray(w) for _, w in _leaves(tm, g)],
                [np.asarray(w) for _, w in _leaves(tm, state, True)])


def _within(got, want, ref32, floor_of):
    """Each ``got`` leaf within max(LEAF_RTOL, 2x ``ref32``'s distance)
    of ``want`` in relative L2, with the FLOOR of the kind; returns the
    violations."""
    if not want:
        return []
    floor = FLOOR * max(np.linalg.norm(w) for w in floor_of)
    bad = []
    for i, (a, w, r) in enumerate(zip(got, want, ref32)):
        bar = max(LEAF_RTOL, 2 * _rel_l2(torch.from_numpy(np.asarray(r)),
                                         w, floor))
        err = _rel_l2(a, w, floor)
        if err > bar:
            bad.append((i, err, bar))
    return bad


@pytest.mark.parametrize("arch", EXTRA_ARCHS)
def test_cifar10_step_and_eval_match_jax(arch, monkeypatch):
    jm = jax_get_model(arch, "cifar10")
    tm = get_model(arch, "cifar10")
    js, jcfg, ts0, ps = _pair_strategies(jm, tm)
    x, y = _batch(0, 2, (32, 32, 3))
    lr, wd = jcfg.resolved_lr(), jcfg.resolved_weight_decay()
    loss64, g64, stats64 = _reference64(monkeypatch, jm, jcfg, ts0, x, y, tm)
    monkeypatch.undo()
    p0 = [np.asarray(w, np.float64) for _, w in _leaves(tm, ts0.params)]
    p1_64 = [a - lr * (g + wd * a) for a, g in zip(p0, g64)]
    # float64: the port's step against the reference's
    m64 = copy.deepcopy(tm).double()
    ce, _, grads = loss_and_grads(m64, jcfg, _to_port(x, y)[0].double(),
                                  _to_port(x, y)[1], None, 0.0)
    assert abs(ce.item() - loss64) <= F64_RTOL * abs(loss64)
    for got, want in ((grads, g64), (list(m64.buffers()), stats64)):
        if want:
            floor = FLOOR * max(np.linalg.norm(w) for w in want)
            assert max(np.linalg.norm(a.detach().numpy() - w)
                       / max(np.linalg.norm(w), floor)
                       for a, w in zip(got, want)) <= F64_RTOL
    # float32: the port's step no further from the float64 step than the
    # reference's float32 step is, twice over
    g32 = [w for _, w in _leaves(tm, jax.jit(
        lambda p, s, xb, yb: jax_loss_and_grads(
            jm, jcfg, p, s, xb, yb, jnp.float32, 0.0)[3])(
        ts0.params, ts0.model_state, jnp.asarray(x), jnp.asarray(y)))]
    ts, jmet = js.train_step(ts0, jnp.asarray(x), jnp.asarray(y),
                             jnp.float32(lr))  # donates ts0
    m = ps.train_step(*_to_port(x, y), lr)
    ref_loss = float(jmet["loss"])
    assert abs(m["loss"].item() - loss64) <= max(
        LOSS_ATOL, 2 * abs(ref_loss - loss64))
    params = list(ps.model.parameters())
    bad = {
        "grad": _within([p.grad for p in params], g64, g32, g64),
        "stat": _within(list(ps.model.buffers()), stats64,
                        [w for _, w in _leaves(tm, ts.model_state, True)],
                        stats64),
        "param": _within(params, p1_64,
                         [w for _, w in _leaves(tm, ts.params)],
                         [b - a for a, b in zip(p0, p1_64)])}
    assert not any(bad.values()), bad
    # the eval step on the reference's updated weights and statistics
    from_jax_params(ps.model, jax.device_get(ts.params))
    from_jax_state(ps.model, jax.device_get(ts.model_state))
    x, y = _batch(5, 4, (32, 32, 3))
    want = js.eval_step(ts, jnp.asarray(x), jnp.asarray(y))
    got = ps.eval_step(*_to_port(x, y))
    want_loss = float(want["loss"])
    assert abs(got["loss"].item() - want_loss) <= LOSS_ATOL * max(
        1.0, abs(want_loss))
    for key in ("correct", "correct5", "count"):
        assert int(got[key]) == int(want[key]), key
