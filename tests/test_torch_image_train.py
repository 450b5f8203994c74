"""The port's image training step held against the JAX reference.

``ddlbench_tpu_torch``'s SingleStrategy (train mode: batch statistics and
one running-statistics update; eval mode: the running statistics) against
``ddlbench_tpu.parallel.single.SingleStrategy``, with the imagenet
resolvers (SGD, lr 0.1, momentum 0.9, weight decay 1e-4), from the same
weights and BatchNorm state (convert.from_jax_params, from_jax_state) and
the same numpy batches (NHWC into the reference, NCHW into the port), on
a tiny ResNet (stem, SAME stem pool, basic blocks with identity and
projection shortcuts, a bottleneck, 8x8 inputs) and a tiny MobileNetV2
(stride-2 stem, inverted residuals with expand 1 and 6, with and without
the residual), and one step of the full-width resnet18 on cifar10 at
batch 2.

Tolerances, float32: after each of two steps the loss within 1e-5
absolute and the accuracy equal; every gradient leaf, every parameter and
every running statistic within 1e-4 relative L2 (a leaf under 1e-3 of the
largest leaf of its kind is measured against that floor: it is zero up to
rounding, as the bias of a BatchNorm that feeds another one is). The eval
step's loss within 1e-5 absolute, its three counts equal. bfloat16 (one
step of each tiny model, float32 masters, against the reference's
bfloat16 step): the loss within 1e-2 absolute; each gradient leaf, each
parameter's update and each running statistic within 5x the most the
reference's own leaf moves when its input is nudged below bfloat16's
rounding step, or 5e-2 relative L2 where that is larger
(test_bf16_step_matches_jax says why); two planted BatchNorm faults must
break those bars.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.layers as jl
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import LayerModel as JaxLayerModel
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.parallel.common import loss_and_grads as jax_loss_and_grads
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle

import ddlbench_tpu_torch.models.layers as tl
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        to_port_layout)
from ddlbench_tpu_torch.models.layers import LayerModel
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

LOSS_ATOL = 1e-5
LEAF_RTOL = 1e-4
BF16_LOSS_ATOL, BF16_LEAF_RTOL = 1e-2, 5e-2
# bfloat16 gradients and updates: the port's distance from the reference's
# bfloat16 step, as a multiple of the reference's own spread under
# sub-rounding nudges of the input (_bf16_reference)
BF16_SPREAD_FACTOR = 5
BF16_NUDGE, BF16_NUDGES = 2.0 ** -12, 4
# a leaf whose norm is below this share of the largest leaf of its kind is
# held against that floor: such leaves are zero up to rounding (the bias
# of a BatchNorm whose output only feeds another BatchNorm)
FLOOR = 1e-3
NUM_CLASSES = 10
IN_SHAPE = (8, 8, 3)

# (reference constructor, port constructor (name, in_shape, gen) -> layer)
TINY = {
    "resnet": [
        (lambda: jl.conv_bn("stem", 8, kernel=3, stride=1),
         lambda s, g: tl.ConvBN("stem", s, 8, 3, 1, gen=g)),
        (lambda: jl.max_pool("stem_pool", 3, 2, "SAME"),
         lambda s, g: tl.MaxPool("stem_pool", s, 3, 2, "SAME")),
        (lambda: jl.basic_block("b1", 8, 1),
         lambda s, g: tl.BasicBlock("b1", s, 8, 1, gen=g)),
        (lambda: jl.basic_block("b2", 16, 2),
         lambda s, g: tl.BasicBlock("b2", s, 16, 2, gen=g)),
        (lambda: jl.bottleneck_block("b3", 4, 1),
         lambda s, g: tl.Bottleneck("b3", s, 4, 1, gen=g)),
        (lambda: jl.global_avg_pool(),
         lambda s, g: tl.GlobalAvgPool("gap", s)),
        (lambda: jl.dense("fc", NUM_CLASSES),
         lambda s, g: tl.Dense("fc", s, NUM_CLASSES, gen=g)),
    ],
    "mobilenet": [
        (lambda: jl.conv_bn("stem", 8, kernel=3, stride=2),
         lambda s, g: tl.ConvBN("stem", s, 8, 3, 2, gen=g)),
        (lambda: jl.inverted_residual("block1", 8, 1, 1),
         lambda s, g: tl.InvertedResidual("block1", s, 8, 1, 1, gen=g)),
        (lambda: jl.inverted_residual("block2", 12, 2, 6),
         lambda s, g: tl.InvertedResidual("block2", s, 12, 2, 6, gen=g)),
        (lambda: jl.inverted_residual("block3", 12, 1, 6),
         lambda s, g: tl.InvertedResidual("block3", s, 12, 1, 6, gen=g)),
        (lambda: jl.conv_bn("head_conv", 16, kernel=1, stride=1),
         lambda s, g: tl.ConvBN("head_conv", s, 16, 1, 1, gen=g)),
        (lambda: jl.global_avg_pool(),
         lambda s, g: tl.GlobalAvgPool("gap", s)),
        (lambda: jl.dense("fc", NUM_CLASSES),
         lambda s, g: tl.Dense("fc", s, NUM_CLASSES, gen=g)),
    ],
}


def tiny_pair(name, in_shape=IN_SHAPE):
    """(reference LayerModel, port LayerModel) of a tiny image model."""
    gen = torch.Generator().manual_seed(0)
    jlayers, tlayers, shape = [], [], in_shape
    for make_j, make_t in TINY[name]:
        jlayers.append(make_j())
        tlayers.append(make_t(shape, gen))
        shape = tlayers[-1].out_shape
    return (JaxLayerModel(name, jlayers, in_shape, NUM_CLASSES),
            LayerModel(name, tlayers, in_shape, NUM_CLASSES))


def _batch(seed, b, in_shape=IN_SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *in_shape)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, b).astype(np.int32)
    return x, y


def _to_port(x, y):
    return (torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
            torch.from_numpy(y).long())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaves(model, tree, buffers=False):
    """(port tensor, reference leaf in the port's layout) for every
    parameter (or buffer) of ``model``, matched by name."""
    out = []
    for layer, ltree in zip(model.layers, tree):
        flat = dict(_flat(ltree))
        own = dict(layer.named_buffers() if buffers
                   else layer.named_parameters())
        assert set(own) == set(flat)
        out.extend((t, to_port_layout(jax.device_get(flat[n])))
                   for n, t in own.items())
    return out


def _rel_l2(got, want, floor=1e-30):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor)


def _pair_strategies(jm, tm, dtype="float32", seed=0):
    jcfg = JaxRunConfig(benchmark="imagenet", arch="resnet50",
                        compute_dtype=dtype)
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(seed))
    from_jax_params(tm, jax.device_get(ts.params))
    from_jax_state(tm, jax.device_get(ts.model_state))
    cfg = RunConfig(benchmark="imagenet", arch="resnet50",
                    compute_dtype=dtype)
    cfg.validate()
    assert (cfg.resolved_lr(), cfg.resolved_momentum(),
            cfg.resolved_weight_decay()) == (0.1, 0.9, 1e-4) == (
        jcfg.resolved_lr(), jcfg.resolved_momentum(),
        jcfg.resolved_weight_decay())
    ps = SingleStrategy(tm, cfg)
    ps.init()
    return js, jcfg, ts, ps


def _jax_grads(jm, jcfg, dtype):
    cdt = jnp.dtype(dtype)
    return jax.jit(lambda p, s, x, y: jax_loss_and_grads(
        jm, jcfg, p, s, x, y, cdt, 0.0)[3])


def _check_leaves(ps, ts, want_g, step, leaf_rtol):
    """Every gradient leaf, parameter and running statistic of the port
    against the reference's, in relative L2 (with the FLOOR)."""
    for what, pairs in (
            ("grad", [(p.grad, g) for p, g in _leaves(ps.model, want_g)]),
            ("param", _leaves(ps.model, ts.params)),
            ("stat", _leaves(ps.model, ts.model_state, True))):
        assert pairs
        floor = FLOOR * max(np.linalg.norm(w) for _, w in pairs)
        for got, want in pairs:
            assert got.dtype == torch.float32
            err = _rel_l2(got, want, floor)
            assert err <= leaf_rtol, (what, step, tuple(got.shape), err)


def _train_and_compare(jm, tm, steps, b, in_shape=IN_SHAPE):
    """``steps`` float32 SGD steps on both sides, each held against the
    other; returns the reference's strategy and state and the port's."""
    js, jcfg, ts, ps = _pair_strategies(jm, tm)
    jgrads = _jax_grads(jm, jcfg, "float32")
    lr = jcfg.resolved_lr()
    for step in range(steps):
        x, y = _batch(step, b, in_shape)
        want_g = jgrads(ts.params, ts.model_state, jnp.asarray(x),
                        jnp.asarray(y))
        ts, jmet = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                                 jnp.float32(lr))
        m = ps.train_step(*_to_port(x, y), lr)
        assert abs(m["loss"].item() - float(jmet["loss"])) <= LOSS_ATOL
        assert m["accuracy"].item() == float(jmet["accuracy"])
        _check_leaves(ps, ts, want_g, step, LEAF_RTOL)
    return js, ts, ps


@pytest.mark.parametrize("name", sorted(TINY))
def test_two_sgd_steps_and_eval_match_jax(name):
    """Two SGD steps, then (the running statistics moved off their
    init) the eval step in eval mode: {loss, correct, correct5, count},
    which leaves the running statistics as they were."""
    js, ts, ps = _train_and_compare(*tiny_pair(name), steps=2, b=8)
    x, y = _batch(50, 16)
    want = js.eval_step(ts, jnp.asarray(x), jnp.asarray(y))
    stats = [b.clone() for b in ps.model.buffers()]
    got = ps.eval_step(*_to_port(x, y))
    assert set(got) == set(want) == {"loss", "correct", "correct5", "count"}
    assert abs(got["loss"].item() - float(want["loss"])) <= LOSS_ATOL
    for key in ("correct", "correct5", "count"):
        assert int(got[key]) == int(want[key]), key
    assert int(got["count"]) == 16
    assert all(torch.equal(a, b) for a, b in zip(stats, ps.model.buffers()))


def test_full_width_resnet18_cifar10_step_matches_jax():
    """One step of the real resnet18 on cifar10 (32x32, batch 2)."""
    jm = jax_get_model("resnet18", "cifar10")
    tm = get_model("resnet18", "cifar10")
    _train_and_compare(jm, tm, steps=1, b=2, in_shape=(32, 32, 3))


# BatchNorm forwards with a planted fault the bfloat16 check must reject
def _bn_update(bn, mean, var, n):
    with torch.no_grad():
        bn.mean.mul_(1 - tl.BN_MOMENTUM).add_(tl.BN_MOMENTUM * mean)
        bn.var.mul_(1 - tl.BN_MOMENTUM).add_(
            tl.BN_MOMENTUM * var * n / (n - 1))


def _bn_statistics_summed_in_bf16(self, x):
    """The batch statistics summed one value at a time in bfloat16 (the
    sums stall once they outgrow the values added to them)."""
    c = x.shape[1]
    rows = x.detach().transpose(0, 1).reshape(c, -1)
    n = rows.shape[1]
    s = s2 = torch.zeros(c, dtype=x.dtype)
    for i in range(n):
        s, s2 = s + rows[:, i], s2 + rows[:, i] * rows[:, i]
    mean = s.float() / n
    var = torch.clamp(s2.float() / n - mean * mean, min=0)
    _bn_update(self, mean, var, n)
    inv = torch.rsqrt(var + tl.BN_EPS) * self.scale.float()
    y = ((x.float() - mean[None, :, None, None]) * inv[None, :, None, None]
         + self.bias.float()[None, :, None, None])
    return y.to(x.dtype)


def _bn_without_mean_gradient(self, x):
    """The batch mean taken as a constant: BatchNorm's backward loses its
    -mean(g) term; the forward and the running statistics are right."""
    n = x.numel() // x.shape[1]
    xf = x.float()
    mean = xf.mean((0, 2, 3)).detach()
    var = ((xf - mean[None, :, None, None]) ** 2).mean((0, 2, 3))
    _bn_update(self, mean, var.detach(), n)
    inv = torch.rsqrt(var + tl.BN_EPS) * self.scale.float()
    y = ((xf - mean[None, :, None, None]) * inv[None, :, None, None]
         + self.bias.float()[None, :, None, None])
    return y.to(x.dtype)


BF16_FAULTS = {"statistics_summed_in_bf16": _bn_statistics_summed_in_bf16,
               "batchnorm_without_mean_gradient": _bn_without_mean_gradient}


@functools.lru_cache(maxsize=None)
def _bf16_reference(name, seed=0, b=8, in_shape=IN_SHAPE):
    """The reference's bfloat16 step of a tiny model on ``_batch(seed, b,
    in_shape)`` (the tests: seed 0, batch 8, 8x8): its
    initial weights and state, the batch, the loss, per port parameter the
    initial value, the gradient, the updated value and the gradient's
    spread, and per buffer the updated running statistic and its spread.
    The spread of a leaf is the most it moves, in relative L2 (with the
    FLOOR of its kind),
    over BF16_NUDGES reruns of the reference on the batch scaled by
    1 + BF16_NUDGE * N(0, 1): a nudge below bfloat16's rounding step
    (2^-8), so only the inputs that lie near a rounding boundary round
    the other way, the kind of difference two packages rounding at
    different places make. ``spread_all`` is the same over all gradient
    leaves together (no floor)."""
    jm, tm = tiny_pair(name, in_shape)
    js, jcfg, ts, _ = _pair_strategies(jm, tm, "bfloat16")
    params0 = jax.device_get(ts.params)
    state0 = jax.device_get(ts.model_state)
    x, y = _batch(seed, b, in_shape)
    step = jax.jit(lambda p, s, xb, yb: jax_loss_and_grads(
        jm, jcfg, p, s, xb, yb, jnp.bfloat16, 0.0)[2:])

    def leaves(tree, buffers=False):
        return [np.asarray(w, np.float64)
                for _, w in _leaves(tm, tree, buffers)]

    def grads_and_stats(xb):
        state, g = step(ts.params, ts.model_state, jnp.asarray(xb),
                        jnp.asarray(y))
        return leaves(g), leaves(state, True)

    def spread(want, got):
        floor = FLOOR * max(np.linalg.norm(w) for w in want)
        return floor, [max(_rel_l2(torch.from_numpy(n[i]), want[i], floor)
                           for n in got) for i in range(len(want))]

    g, stats = grads_and_stats(x)
    rng = np.random.default_rng(1000 + seed)
    nudged = [grads_and_stats((x * (1 + BF16_NUDGE * rng.standard_normal(
        x.shape))).astype(np.float32)) for _ in range(BF16_NUDGES)]
    floor, g_spread = spread(g, [n[0] for n in nudged])
    flat = [np.concatenate([w.ravel() for w in n[0]]) for n in nudged]
    g_flat = np.concatenate([w.ravel() for w in g])
    spread_all = max(np.linalg.norm(f - g_flat) for f in flat) \
        / np.linalg.norm(g_flat)
    stat_floor, stat_spread = spread(stats, [n[1] for n in nudged])
    p0 = leaves(params0)
    ts, met = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                            jnp.float32(jcfg.resolved_lr()))
    assert all(np.array_equal(a, b) for a, b in zip(
        leaves(ts.model_state, True), stats))
    return types.SimpleNamespace(
        params0=params0, state0=state0, x=x, y=y, loss=float(met["loss"]),
        p0=p0, g=g, p1=leaves(ts.params), floor=floor, spread=g_spread,
        spread_all=spread_all, stats=stats, stat_floor=stat_floor,
        stat_spread=stat_spread)


def _bf16_violations(name, fault=None, every=False, **batch):
    """One bfloat16 step of the port (float32 masters) against the
    reference's (_bf16_reference), with BatchNorm.forward replaced by
    ``fault`` when one is given. Returns what breaks a bar (everything
    measured, if ``every``), as (kind, shape, err, bar, spread): the loss
    within BF16_LOSS_ATOL; each gradient leaf, each parameter's update
    and each running statistic within max(BF16_SPREAD_FACTOR x the leaf's
    spread, BF16_LEAF_RTOL) relative L2 (with the FLOOR; an update has
    the spread of its gradient); every leaf float32. ``batch`` (seed, b,
    in_shape) picks another batch than the tests'."""
    ref = _bf16_reference(name, **batch)
    tm = tiny_pair(name, batch.get("in_shape", IN_SHAPE))[1]
    from_jax_params(tm, ref.params0)
    from_jax_state(tm, ref.state0)
    ps = SingleStrategy(tm, RunConfig(benchmark="imagenet", arch="resnet50",
                                      compute_dtype="bfloat16"))
    ps.init()
    original = tl.BatchNorm.forward
    if fault is not None:
        tl.BatchNorm.forward = fault
    try:
        m = ps.train_step(*_to_port(ref.x, ref.y), 0.1)
    finally:
        tl.BatchNorm.forward = original
    params = list(tm.parameters())
    assert len(params) == len(ref.g) and all(
        t.dtype == torch.float32 for t in [*params, *tm.buffers()])
    out = [("loss", (), abs(m["loss"].item() - ref.loss), BF16_LOSS_ATOL,
            None)]
    step_floor = FLOOR * max(np.linalg.norm(b - a)
                             for a, b in zip(ref.p0, ref.p1))
    for i, p in enumerate(params):
        bar = max(BF16_SPREAD_FACTOR * ref.spread[i], BF16_LEAF_RTOL)
        for kind, got, want, fl in (
                ("grad", p.grad, ref.g[i], ref.floor),
                ("update", p.detach().double()
                 - torch.from_numpy(ref.p0[i]), ref.p1[i] - ref.p0[i],
                 step_floor)):
            out.append((kind, tuple(p.shape), _rel_l2(got, want, fl), bar,
                        ref.spread[i]))
    for b, want, sp in zip(tm.buffers(), ref.stats, ref.stat_spread):
        out.append(("stat", tuple(b.shape), _rel_l2(b, want, ref.stat_floor),
                    max(BF16_SPREAD_FACTOR * sp, BF16_LEAF_RTOL), sp))
    return out if every else [o for o in out if o[2] > o[3]]


def test_bf16_step_matches_jax():
    """One bfloat16 step of the tiny ResNet on float32 masters against
    the reference's (_bf16_violations says what is held). A bar of 5e-2
    on each gradient leaf between the two packages would measure rounding,
    not the port: through BatchNorm's backward (g - mean(g) - xhat *
    mean(g * xhat), cancellation at every layer) the reference's own
    bfloat16 gradient moves by 11-24 % (all leaves together, relative L2,
    the most over four nudges) when its input is nudged below bfloat16's
    rounding step, at 8x8 (batch 8) and at 16x16 (batch 16) alike; so
    each leaf is held to BF16_SPREAD_FACTOR times the most the
    reference's own leaf moves under such nudges. Over both tiny models,
    both sizes and batch seeds 0-5, the port's worst leaf of any kind
    comes to 0.81 of its bar (0.49 at the tests' batch); running this
    file as a script prints those numbers."""
    assert _bf16_violations("resnet") == []


def test_bf16_mobilenet_step_matches_jax():
    """The same bfloat16 check on the tiny MobileNetV2."""
    assert _bf16_violations("mobilenet") == []


@pytest.mark.parametrize("fault", sorted(BF16_FAULTS))
def test_bf16_check_rejects_planted_faults(fault):
    """The bfloat16 bars have teeth: BatchNorm's statistics summed in
    bfloat16, or its backward without the mean term (a fault the loss and
    the running statistics cannot see), each breaks a gradient leaf's
    bar (by 3.4x on the tiny ResNet, 19x on the tiny MobileNet)."""
    bad = _bf16_violations("resnet", BF16_FAULTS[fault])
    assert any(kind == "grad" for kind, *_ in bad), bad


if __name__ == "__main__":
    # The bfloat16 numbers the docstrings quote: per tiny model, input size
    # and batch seed, the reference's own spread over all gradient leaves,
    # the port's worst gradient leaf as a multiple of its leaf's spread,
    # and the worst err / bar of each kind at the tests' bars (<= 1
    # passes); then how far each planted fault breaks the bars.
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_image_train.py
    for name in sorted(TINY):
        for b, hw in ((8, 8), (16, 16)):
            for seed in range(6):
                batch = {"seed": seed, "b": b, "in_shape": (hw, hw, 3)}
                rows = _bf16_violations(name, every=True, **batch)
                worst = {}
                for kind, _, err, bar, _ in rows:
                    worst[kind] = max(worst.get(kind, 0.0), err / bar)
                spread = _bf16_reference(name, **batch).spread_all
                per_spread = max(err / sp for kind, _, err, _, sp in rows
                                 if kind == "grad")
                print(f"{name} {hw}x{hw} B {b} seed {seed}: reference "
                      f"spread {spread:.3f}, port grad/spread "
                      f"{per_spread:.2f}, err/bar " + ", ".join(
                          f"{k} {v:.2f}" for k, v in sorted(worst.items())),
                      flush=True)
        for fault in sorted(BF16_FAULTS):
            bad = _bf16_violations(name, BF16_FAULTS[fault])
            print(f"{name} {fault}: {len(bad)} leaves over their bar, worst "
                  f"{max(o[2] / o[3] for o in bad):.2f}x", flush=True)
