"""The port's explicit dp engines held to its replicated engine, and the dp
gates of RunConfig held to the reference's.

Ranks are gloo processes on the CPU (tests/torch_dp_ranks.py), started
once for the file. Against the port's replicated engine (parallel/dp.py):

* the sharded update, the bucketed replicated engine, the overlapped
  engine and shard_opt_state give the same losses and parameters bit for
  bit at world 2, where every collective adds two operands and so sums in
  one order. At world 4 gloo's all-reduce and reduce-scatter may add the
  four partials in different orders, so the bar there is 1e-6 relative L2
  on the parameters and rtol 1e-6 on the losses (float32 rounding of a
  reordered four-term sum, a few ulps, carried over 4 steps);
* the bf16 wire trains within rtol 0.05 of the f32 losses, and the int8
  wire finite and within rtol 0.05, replaying bit for bit (the
  reference's bars, tests/test_dp_shard.py::test_bf16_allreduce_trains,
  tests/test_comm_overlap.py::test_int8_trains_and_replays_bitwise).

Against the reference: the sharded update's trajectory against its
replicated engine (its explicit engine raises on this jax in every mode:
ROADMAP C.1), at test_torch_train.py's rtol 1e-4 and atol 1e-6 (the two
sides reduce in different orders); the validation gates of
tests/test_dp_shard.py::test_validate_gates and
tests/test_comm_overlap.py::test_comm_bucket_config_gates.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.dp import DPStrategy as JaxDP
from tiny_models import tiny_dense_model
from torch_dp_ranks import RankPool

from ddlbench_tpu_torch import distributed
from ddlbench_tpu_torch.config import RunConfig

pytestmark = pytest.mark.torchport

BASE = dict(benchmark="mnist", strategy="dp", compute_dtype="float32",
            batch_size=2, steps_per_epoch=2, momentum=0.5,
            weight_decay=1e-4)
STEPS, LR = 4, 0.2
WORLD4_REL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def dense_init():
    params, states, _ = init_model(tiny_dense_model(), jax.random.key(0))
    return jax.device_get(params), jax.device_get(states)


def _batches(B, steps=STEPS, seed=100):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, 4, 4, 1)).astype(np.float32),
             rng.integers(0, 4, B).astype(np.int32)) for _ in range(steps)]


def _run(ranks, dense_init, world, steps=STEPS, **kw):
    cfg = dict(BASE, **kw)
    B = RunConfig(num_devices=world, **cfg).global_batch()
    out = ranks.run("train", world, model="dense", cfg=cfg,
                    batches=_batches(B, steps), lr=LR,
                    params=dense_init[0], states=dense_init[1])
    for other in out[1:]:  # every rank holds the same replicated result
        np.testing.assert_array_equal(other["losses"], out[0]["losses"])
        for k, v in out[0]["params"].items():
            np.testing.assert_array_equal(other["params"][k], v)
    return out


def _flat(res):
    return np.concatenate([v.ravel() for v in res["params"].values()])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


ENGINES = {
    "sharded": dict(dp_shard_update=True),
    "bucketed": dict(comm_buckets=3),
    "overlapped": dict(dp_shard_update=True, comm_buckets=3),
    "shard_opt_state": dict(shard_opt_state=True),
}


@pytest.mark.parametrize("optimizer,accum", [("sgd", 1), ("adam", 2)])
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("world", [2, 4])
def test_engine_matches_replicated(ranks, dense_init, world, engine,
                                   optimizer, accum):
    kw = dict(optimizer=optimizer, grad_accum_steps=accum,
              label_smoothing=0.1)
    rep = _run(ranks, dense_init, world, **kw)[0]
    got = _run(ranks, dense_init, world, **kw, **ENGINES[engine])[0]
    if world == 2:
        np.testing.assert_array_equal(got["losses"], rep["losses"])
        np.testing.assert_array_equal(_flat(got), _flat(rep))
    else:
        np.testing.assert_allclose(got["losses"], rep["losses"],
                                   rtol=WORLD4_REL, atol=0)
        assert _rel_l2(_flat(got), _flat(rep)) <= WORLD4_REL


def test_sharded_trajectory_matches_jax(ranks, dense_init):
    """The sharded update over 8 steps (the dense model, SGD, K 1, f32,
    world 4) against the reference's replicated engine, to which the
    reference pins its explicit engine bit for bit: on this jax the
    explicit engine raises in every mode, this one included (ROADMAP
    C.1), so it is called nowhere here."""
    steps = 8
    jcfg = JaxRunConfig(num_devices=4, **BASE)
    jcfg.validate()
    strat = JaxDP(tiny_dense_model(), jcfg)
    ts = strat.init(jax.random.key(0))
    losses = []
    for x, y in _batches(jcfg.global_batch(), steps):
        ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                 jnp.float32(LR))
        losses.append(float(m["loss"]))
    got = _run(ranks, dense_init, 4, steps=steps, dp_shard_update=True)[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4, atol=1e-6)
    ref = {f"{i}.{k}": np.asarray(v) for i, layer in
           enumerate(jax.device_get(ts.params)) for k, v in layer.items()}
    for name, v in ref.items():
        np.testing.assert_allclose(got["params"][name], v, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shard", [False, True])
def test_bf16_wire_trains(ranks, dense_init, shard):
    ref = _run(ranks, dense_init, 4)[0]
    got = _run(ranks, dense_init, 4, allreduce_dtype="bf16",
               dp_shard_update=shard)[0]
    assert np.all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0.05)
    assert _flat(got).tolist() != _flat(ref).tolist()  # the wire was bf16


def test_int8_wire_trains_and_replays_bitwise(ranks, dense_init):
    ref = _run(ranks, dense_init, 4, dp_shard_update=True)[0]
    kw = dict(dp_shard_update=True, allreduce_dtype="int8", comm_buckets=2)
    a = _run(ranks, dense_init, 4, **kw)
    b = _run(ranks, dense_init, 4, **kw)[0]
    a = a[0]
    assert np.all(np.isfinite(a["losses"]))
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=0.05)
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_array_equal(_flat(a), _flat(b))
    assert a["qstep"] == STEPS  # the rounding stream advanced each step


def test_int8_replicated_update_trains(ranks, dense_init):
    got = _run(ranks, dense_init, 2, steps=3, allreduce_dtype="int8")[0]
    assert np.all(np.isfinite(got["losses"]))
    assert got["qstep"] == 3


@pytest.mark.parametrize("world", [2, 4])
def test_optimizer_state_bytes_shrink_by_world(ranks, dense_init, world):
    """ZeRO-1's memory criterion: each rank holds padded / world float32
    elements of m and of v; the replicated engine holds all of both (the
    packed vector, padded to the world)."""
    rep = _run(ranks, dense_init, world, steps=1, optimizer="adam")[0]
    sh = _run(ranks, dense_init, world, steps=1, optimizer="adam",
              dp_shard_update=True)
    for r in sh:
        assert r["opt_bytes"] == 2 * 4 * r["padded"] // world
    assert rep["opt_bytes"] == 2 * 4 * rep["padded"]
    assert rep["padded"] - world < sum(v.size for v in
                                       rep["params"].values()) <= \
        rep["padded"]


def test_shard_opt_state_slices_the_leaves(ranks, dense_init):
    """shard_opt_state keeps a 1/world slice of each leaf the world
    divides (fc1's w [16, 9] along 16) and the whole of the others."""
    out = _run(ranks, dense_init, 2, steps=1, optimizer="adam",
               shard_opt_state=True)
    sizes = {k: v.shape for k, v in out[0]["params"].items()}
    want = sum((np.prod(s) // 2 if any(d % 2 == 0 for d in s)
                else np.prod(s)) for s in sizes.values())
    assert all(r["opt_bytes"] == 2 * 4 * want for r in out)


def test_eval_step_is_the_global_batch(ranks, dense_init):
    """Each rank's eval sums, all-reduced, are the global batch's: the
    same at world 2 and 4."""
    batch = _batches(8, 1)[0]
    cfg = dict(BASE)
    a = ranks.run("evaluate", 2, model="dense", cfg=cfg, batch=batch,
                  params=dense_init[0])
    b = ranks.run("evaluate", 4, model="dense", cfg=cfg, batch=batch,
                  params=dense_init[0])
    assert a[0]["count"] == b[0]["count"] == 8
    assert a[0]["correct"] == b[0]["correct"]
    np.testing.assert_allclose(a[0]["loss"], b[0]["loss"], rtol=1e-6)


# ---- config gates ----------------------------------------------------------


def _cfg(**kw):
    base = dict(benchmark="mnist", strategy="dp", num_devices=8,
                compute_dtype="float32", batch_size=2, steps_per_epoch=2,
                momentum=0.5, weight_decay=1e-4)
    base.update(kw)
    cfg = RunConfig(**base)
    cfg.validate()
    return cfg


def _jax_cfg(**kw):
    base = dict(benchmark="mnist", strategy="dp", num_devices=8,
                compute_dtype="float32", batch_size=2, steps_per_epoch=2,
                momentum=0.5, weight_decay=1e-4)
    base.update(kw)
    cfg = JaxRunConfig(**base)
    cfg.validate()
    return cfg


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="fsdp", dp_shard_update=True), "dp strategy"),
    (dict(dp_shard_update=True, shard_opt_state=True), "supersedes"),
    (dict(arch="transformer_moe_s", benchmark="synthtext",
          dp_shard_update=True), "MoE"),
    (dict(allreduce_dtype="fp4"), "allreduce_dtype"),
    (dict(strategy="single", num_devices=1, allreduce_dtype="bf16"),
     "dp strategy"),
    (dict(comm_buckets=0), "comm_buckets"),
    (dict(strategy="single", num_devices=1, comm_buckets=4), "dp strategy"),
    (dict(shard_opt_state=True, allreduce_dtype="bf16"), "placement"),
    (dict(remat_layers=True, arch="transformer_t", benchmark="synthtext",
          dp_shard_update=True), "remat_layers"),
    (dict(strategy="single", num_devices=2), "exactly 1 device"),
])
def test_validate_gates_as_the_reference(kw, match):
    """Each gate raises ValueError with the reference's words, on both
    sides."""
    with pytest.raises(ValueError, match=match):
        _jax_cfg(**kw)
    with pytest.raises(ValueError, match=match):
        _cfg(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(allreduce_dtype="bf16"), dict(allreduce_dtype="int8"),
    dict(comm_buckets=4), dict(dp_shard_update=True),
    dict(dp_shard_update=True, comm_buckets=4),
    dict(allreduce_dtype="bf16", comm_buckets=4),
])
def test_engine_predicates_as_the_reference(kw):
    ours, theirs = _cfg(**kw), _jax_cfg(**kw)
    assert ours.resolved_allreduce_dtype() == \
        theirs.resolved_allreduce_dtype()
    assert ours.dp_explicit_collectives() == \
        theirs.dp_explicit_collectives()
    assert ours.dp_overlap_engine() == theirs.dp_overlap_engine()
    assert ours.global_batch() == theirs.global_batch()
    assert dataclasses.replace(ours, grad_accum_steps=2).global_batch() == \
        dataclasses.replace(theirs, grad_accum_steps=2).global_batch()


def test_world_beyond_the_cards_raises():
    """-g 2 on cuda needs two cards: an error naming the count, never a
    fall back to gloo or the CPU (this machine has fewer than two)."""
    with pytest.raises(RuntimeError, match="needs 2 CUDA device"):
        distributed.check_world("cuda", 2)
    with pytest.raises(RuntimeError, match="needs 2 CUDA device"):
        distributed.spawn(print, 2, "cuda")
    from ddlbench_tpu_torch import cli

    with pytest.raises(RuntimeError, match="needs 2 CUDA device"):
        cli.main(["-f", "dp", "-g", "2", "--device", "cuda"])
