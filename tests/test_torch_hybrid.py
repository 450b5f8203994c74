"""Hybrid PP x DP (``dp_replicas`` > 1 on every pipeline runtime) and
hybrid PP x ZeRO-1 (``dp_shard_update`` on gpipe) held to the
reference's strategies on the CPU.

The port runs one gloo rank a replica (tests/torch_dp_ranks.RankPool,
cases in tests/torch_hybrid_ranks.py), each walking its two stages;
the reference runs the same config on 4 of the 8 virtual CPU devices
(its ``('data', 'stage')`` mesh). Both start from the reference's
initial weights (convert.py) and take the same numpy global batches of
M x mb x 2 rows:

* dp 2 x S 2 for fill-drain, ``1f1b``, interleaved V 2 and pipedream at
  ``update_interval`` 1 and 2, on "dense", "bn" (a convolution with
  BatchNorm: running statistics averaged over the replicas) and
  "transformer_t" (the fused LM head's plain versions): each step's
  loss (rtol 1e-5) and accuracy, the first step's change of every
  chunk's packed row (relative L2 1e-4: it is -lr x the replica-averaged
  gradient plus the decay at the first step, or pipedream's per-event
  summed updates), the rows after both steps (rtol 1e-4, atol 1e-6),
  BatchNorm's state rows (rtol 1e-4, atol 1e-6), the eval step's sums;
  both ranks end with the same rows (exactly);
* the batch layout: replica d's microbatch m is rows [m*2*mb + d*mb,
  m*2*mb + (d+1)*mb) of the global batch, not a contiguous block;
* ZeRO-1 at K 1 and 2 (fill-drain and 1f1b) against the reference's
  (tests/test_pipe_shard.py's construction) and the port's replicated
  hybrid, its rows device-major and 1/2 a rank, its optimizer bytes
  half the replicated (within each chunk's pad), and the shard's
  gradient divided by R then M in that order;
* uniform ``stage_replication`` (2, 2) routing to the hybrid at mb // 2;
* the reference's validation errors; 3-D tpp's configs validate
  (tests/test_torch_tpp3d.py runs them).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
import torch_hybrid_ranks as hr
from ddlbench_tpu.config import DatasetSpec as JaxDatasetSpec
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.gpipe import GPipeStrategy as JaxGPipe
from ddlbench_tpu.parallel.pipedream import PipeDreamStrategy as JaxPD
from ddlbench_tpu.parallel.pipeline_rt import (
    ScheduledPipelineStrategy as JaxRT)
from test_torch_dp import JAX_MODELS
from tiny_models import TINY_LM
from torch_dp_ranks import RankPool

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import load_packed_rows, zero1_plain_rows

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-4, atol=1e-6)
DELTA_REL = 1e-4
LR = 0.05
IMG_JAX = JaxDatasetSpec("tinyhybimg", (4, 4, 1), 4, 64, 16)
JAX_CLS = {"gpipe": JaxGPipe, "rt": JaxRT, "pipedream": JaxPD}


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(2)
    yield pool
    pool.close()


def _cfg(model, engine, **kw):
    base = dict(benchmark="tinylm" if model == "transformer_t"
                else "tinyhybimg",
                strategy="pipedream" if engine == "pipedream" else "gpipe",
                num_devices=4, num_stages=2, dp_replicas=2,
                micro_batch_size=2, num_microbatches=2,
                compute_dtype="float32", attention_backend="xla",
                label_smoothing=0.0, arch="transformer_t")
    if model != "transformer_t":
        base.update(momentum=0.5, weight_decay=1e-4)
    if engine == "rt":
        base["pipe_schedule"] = "1f1b"
    if engine == "pipedream":
        base["batch_size"] = 4  # a replica's mb x M
    base.update(kw)
    return base


def _batches(model, B, steps=2, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        if model == "transformer_t":
            seq = rng.integers(0, TINY_LM.num_classes,
                               (B, TINY_LM.seq_len + 1)).astype(np.int32)
            y = seq[:, 1:].copy()
            y[1, :5] = -1  # a masked stretch on one replica's rows
            out.append((seq[:, :-1], y))
        else:
            out.append((rng.standard_normal((B, 4, 4, 1)).astype(np.float32),
                        rng.integers(0, 4, B).astype(np.int32)))
    return out


def _ref(model, engine, cfg, batches):
    """The reference's run: (initial params, states, per-step losses and
    accuracies, plain rows after each step, state rows, eval sums, its
    strategy)."""
    with mock.patch.dict(jconfig.DATASETS, {"tinylm": TINY_LM,
                                            "tinyhybimg": IMG_JAX}):
        jcfg = JaxRunConfig(**cfg)
        jcfg.validate()
        strat = JAX_CLS[engine](JAX_MODELS[model](), jcfg)
        ts = strat.init(jax.random.key(0))
        params, states, _ = init_model(strat.model, jax.random.key(0))
        out = {"losses": [], "accuracy": [], "params": [],
               "p0": np.asarray(strat.materialize_params(ts))}
        for x, y in batches:
            ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                     jnp.float32(LR))
            out["losses"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append(np.asarray(strat.materialize_params(ts)))
        C = strat.num_chunks
        out["states"] = np.asarray(ts.model_state).reshape(C, -1)
        em = strat.eval_step(ts, *strat.shard_batch(*batches[0]))
        out["eval"] = {k: float(v) for k, v in em.items()}
        out["bounds"] = list(strat.bounds)
        out["raw"] = np.asarray(ts.params)
        if strat.pipe_shard:
            out["row_length"] = strat._row_meta.length
    return (jax.device_get(params), jax.device_get(states), out)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _port(ranks, model, engine, cfg, params, states, batches):
    got = ranks.run("torch_hybrid_ranks:train", 2, model=model,
                    engine=engine, cfg=cfg, params=params, states=states,
                    batches=batches, lr=LR)
    for a, b in zip(got[0]["params"], got[1]["params"]):
        np.testing.assert_array_equal(a, b)  # one model on both replicas
    assert got[0]["losses"] == got[1]["losses"]
    return got[0]


def _hold(mine, ref, cfg):
    assert mine["bounds"] == ref["bounds"]
    np.testing.assert_allclose(mine["losses"], ref["losses"], **LOSS)
    np.testing.assert_allclose(mine["accuracy"], ref["accuracy"], atol=1e-6)
    d_mine = mine["params"][0] - mine["p0"]
    d_ref = (ref["params"][0] - ref["p0"]).reshape(d_mine.shape)
    for c in range(d_mine.reshape(-1, d_mine.shape[-1]).shape[0]):
        rows = d_mine.reshape(-1, d_mine.shape[-1])
        want = d_ref.reshape(-1, d_ref.shape[-1])[c]
        if np.any(want):
            assert _rel(rows[c], want) <= DELTA_REL, c
    for got, want in zip(mine["params"], ref["params"]):
        np.testing.assert_allclose(got, want.reshape(got.shape), **PARAM)
    np.testing.assert_allclose(mine["states"], ref["states"], **STATE)
    for k in ("correct", "correct5", "count"):
        assert mine["eval"][k] == ref["eval"][k], k
    np.testing.assert_allclose(mine["eval"]["loss"], ref["eval"]["loss"],
                               **LOSS)
    assert ref["losses"][0] != ref["losses"][-1]  # the steps moved


HYBRID = [(m, e, kw) for m in ("dense", "bn", "transformer_t")
          for e, kw in (("gpipe", {}), ("rt", {}),
                        ("rt", dict(pipe_schedule="interleaved",
                                    virtual_stages=2)),
                        ("pipedream", {}),
                        ("pipedream", dict(update_interval=2)))]


@pytest.mark.parametrize(
    "model,engine,kw", HYBRID,
    ids=[f"{m}-{e}" + ("-V2" if "virtual_stages" in kw else "")
         + ("-K2" if "update_interval" in kw else "") for m, e, kw in HYBRID])
def test_hybrid_matches_the_reference(ranks, model, engine, kw):
    cfg = _cfg(model, engine, **kw)
    B = RunConfig(**cfg).global_batch()
    assert B == 2 * 2 * 2
    batches = _batches(model, B)
    params, states, ref = _ref(model, engine, cfg, batches)
    _hold(_port(ranks, model, engine, cfg, params, states, batches), ref,
          cfg)


def test_batch_layout_interleaves_the_replicas():
    """Replica d's microbatch m is rows [m*R*mb + d*mb, ...+ mb): the
    reference's reshape to [M, R*mb] with the second axis sharded."""
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy

    cfg = RunConfig(**_cfg("dense", "gpipe", num_microbatches=3))
    x = torch.arange(12, dtype=torch.float32).reshape(12, 1, 1, 1)
    y = torch.arange(12)

    class _Rank:
        def __init__(self, rank):
            self.rank, self.world = rank, 2

        def broadcast(self, t, src=0):
            return t

    got = {}
    for d in range(2):
        s = GPipeStrategy(hr.build_model("dense"), cfg,
                          [torch.device("cpu")] * 2, dp_comm=_Rank(d))
        xs, ys = s.shard_batch(x.expand(12, 1, 4, 4), y)
        got[d] = [t.tolist() for t in ys]
        assert [t[:, 0, 0, 0].tolist() for t in xs] == got[d]
    assert got == {0: [[0, 1], [4, 5], [8, 9]], 1: [[2, 3], [6, 7],
                                                    [10, 11]]}


# ---- hybrid PP x ZeRO-1 ----------------------------------------------------

SHARD = [("dense", "gpipe", 1), ("dense", "gpipe", 2),
         ("transformer_t", "gpipe", 2), ("dense", "rt", 2)]


@pytest.mark.parametrize("model,engine,K", SHARD,
                         ids=[f"{m}-{e}-K{k}" for m, e, k in SHARD])
def test_zero1_matches_the_reference_and_the_replicated(ranks, model,
                                                       engine, K):
    cfg = _cfg(model, engine, dp_shard_update=True, comm_buckets=K)
    batches = _batches(model, RunConfig(**cfg).global_batch())
    params, states, ref = _ref(model, engine, cfg, batches)
    mine = _port(ranks, model, engine, cfg, params, states, batches)
    _hold(mine, ref, cfg)
    # the reference's sharded rows, made plain, are its materialized ones
    # and load into the port's chunks (convert.zero1_plain_rows)
    rows = zero1_plain_rows(ref["raw"], ref["row_length"], 2, K)
    np.testing.assert_array_equal(rows, ref["params"][-1])
    twin = hr.build_model(model)
    C = len(mine["bounds"]) - 1
    load_packed_rows([twin.layers[mine["bounds"][c]:mine["bounds"][c + 1]]
                      for c in range(C)], rows)
    np.testing.assert_allclose(
        np.concatenate([p.detach().numpy().ravel()
                        for p in twin.parameters()]),
        np.concatenate([p.detach().numpy().ravel() for p in
                        _loaded(model, mine["params"][-1],
                                mine["bounds"]).parameters()]),
        rtol=1e-4, atol=1e-6)
    plain = _port(ranks, model, engine, _cfg(model, engine), params,
                  states, batches)
    np.testing.assert_allclose(mine["losses"], plain["losses"], rtol=1e-6)
    for a, b in zip(mine["params"], plain["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # SGD: one momentum slab; each rank holds half of every chunk's
    # padded row, the replicated engine the whole unpadded row
    rows = ranks.run("torch_hybrid_ranks:rows_of", 2, model=model,
                     cfg=cfg, params=params)
    padded = rows[0]["padded"]
    assert mine["opt_bytes"] == sum(4 * p // 2 for p in padded)
    assert plain["opt_bytes"] / 2 <= mine["opt_bytes"] \
        <= plain["opt_bytes"] / 2 + 4 * len(padded) * (K + 1)


def _loaded(model, rows, bounds):
    """The port's ``model`` twin with its chunks loaded from ``rows``."""
    net = hr.build_model(model)
    load_packed_rows([net.layers[bounds[c]:bounds[c + 1]]
                      for c in range(len(bounds) - 1)], rows)
    return net


def test_zero1_rows_are_device_major_halves(ranks):
    cfg = _cfg("transformer_t", "gpipe", dp_shard_update=True,
               comm_buckets=3)
    params = jax.device_get(init_model(JAX_MODELS["transformer_t"](),
                                       jax.random.key(0))[0])
    got = ranks.run("torch_hybrid_ranks:rows_of", 2, model="transformer_t",
                    cfg=cfg, params=params)
    for c in range(len(got[0]["rows"])):
        np.testing.assert_array_equal(got[0]["rows"][c], got[0]["plain"][c])
        assert got[0]["shards"][c].size == got[0]["padded"][c] // 2
        assert not np.array_equal(got[0]["shards"][c], got[1]["shards"][c])


def test_zero1_divides_by_the_replicas_then_the_microbatches(monkeypatch):
    """The shard's gradient is (reduce-scattered sum / R) / M, the
    replicated engine's order (the reference's note: the trajectories
    pin only so), not sum / (R M): at R 3, M 3 the two differ."""
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy

    class _Triplets:
        """A replica group of 3 whose other ranks hold this one's
        tensors."""
        rank, world = 0, 3

        def broadcast(self, t, src=0):
            return t

        def reduce_scatter(self, t):
            return (t + t + t)[:t.numel() // 3]

        def all_gather(self, t):
            return torch.cat([t, t, t])

    cfg = RunConfig(**_cfg("dense", "rt", dp_shard_update=True,
                           dp_replicas=3, num_devices=6, momentum=0.0,
                           weight_decay=0.0))
    s = GPipeStrategy(hr.build_model("dense"), cfg,
                      [torch.device("cpu")] * 2, dp_comm=_Triplets())
    s.init()
    seen = []
    monkeypatch.setattr(s, "_opt_update", lambda p, g, st, lr:
                        seen.append(g[0].clone()))
    grads = [[torch.full_like(p, 0.7) for p in s.chunk_params(c)]
             for c in range(s.num_chunks)]
    M = 3
    s._finish_step(grads, 1.0, div=M)
    total = torch.tensor(0.7) + torch.tensor(0.7) + torch.tensor(0.7)
    assert not torch.equal(total / 3 / M, total / (3 * M))
    for c, g in enumerate(seen):
        n = sum(p.numel() for p in s.chunk_params(c))
        want = torch.zeros(s._row_meta[c].padded // 3)
        want[:n] = total / 3 / M
        assert torch.equal(g, want), c


# ---- routing and refusals --------------------------------------------------


def test_uniform_stage_replication_routes_to_the_hybrid():
    from ddlbench_tpu.parallel.api import make_strategy as jax_make

    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy

    class _Rank:
        rank, world = 0, 2

        def broadcast(self, t, src=0):
            return t

    kw = dict(strategy="gpipe", benchmark="mnist", arch="lenet",
              num_devices=4, stage_replication=(2, 2), micro_batch_size=4,
              num_microbatches=2, compute_dtype="float32")
    cfg = RunConfig(**kw)
    assert cfg.spawned_ranks() == 2 and cfg.global_batch() == 8
    s = make_strategy(cfg, torch.device("cpu"), _Rank())
    assert type(s) is GPipeStrategy
    assert (s.dp, s.num_stages, s.mb, s.num_microbatches) == (2, 2, 2, 2)
    js = jax_make(JaxRunConfig(**kw))
    assert (js.dp, js.num_stages, js.mb, js.num_microbatches) == (2, 2, 2, 2)
    assert list(js.bounds if hasattr(js, "bounds") else s.bounds) \
        == s.bounds


GATES = [
    (dict(stage_replication=(1, 2)), ValueError, "sums to"),
    (dict(stage_replication=(4,), micro_batch_size=6), ValueError,
     "divisible"),
    (dict(stage_replication=(1, 3), dp_replicas=2), ValueError,
     "mutually exclusive"),
    (dict(strategy="dp", stage_replication=(1, 3), micro_batch_size=None,
          num_microbatches=None), ValueError, "pipeline"),
    (dict(stage_replication=(1, 3), pipe_schedule="1f1b"), ValueError,
     "fill-drain schedule only"),
    (dict(stage_replication=(1, 3), virtual_stages=2), ValueError,
     "mutually exclusive"),
    (dict(stage_replication=(1, 3), dp_shard_update=True), ValueError,
     "uniform 2-D mesh"),
    (dict(strategy="pipedream", stage_replication=(1, 3),
          update_interval=2), ValueError, "uniform pipedream"),
    (dict(strategy="pipedream", dp_replicas=2, num_stages=2,
          dp_shard_update=True), ValueError, "dp strategy or to -f gpipe"),
    (dict(comm_buckets=2, dp_replicas=2, num_stages=2), ValueError,
     "comm_buckets > 1"),
]


@pytest.mark.parametrize("kw,err,match", GATES)
def test_hybrid_gates_worded_as_the_reference(kw, err, match):
    base = dict(strategy="gpipe", num_devices=4, micro_batch_size=6,
                num_microbatches=2)
    base.update(kw)
    for cls in (RunConfig, JaxRunConfig):
        with pytest.raises(err, match=match):
            cls(**base).validate()


@pytest.mark.parametrize("kw", [
    dict(dp_replicas=2, tp_size=2, num_devices=8),
    dict(dp_replicas=2, tp_size=2, num_devices=8, num_stages=2),
    dict(dp_replicas=4, tp_size=2, num_devices=8)])
def test_3d_tpp_stays_refused(kw):
    """3-D tpp was refused until it was ported (tests/test_torch_tpp3d.py):
    it now validates as the reference does, spawns a rank a shard of a
    replica and takes the reference's global batch, M x mb x R."""
    base = dict(strategy="gpipe", benchmark="synthtext",
                arch="transformer_t", micro_batch_size=2,
                num_microbatches=2, **kw)
    cfg = RunConfig(**base)
    cfg.validate()
    jcfg = JaxRunConfig(**base)
    jcfg.validate()
    assert cfg.spawned_ranks() == kw["dp_replicas"] * kw["tp_size"]
    assert cfg.global_batch() == jcfg.global_batch() == 2 * 2 * kw[
        "dp_replicas"]
    assert cfg.resolved_stages() == jcfg.resolved_stages()


@pytest.mark.parametrize("kw,ranks_,batch", [
    (dict(strategy="gpipe", dp_replicas=2, num_devices=4), 2, 16),
    (dict(strategy="pipedream", dp_replicas=2, num_devices=4,
          batch_size=8, micro_batch_size=None, num_microbatches=None),
     2, 16),
    (dict(strategy="gpipe", stage_replication=(2, 2), num_devices=4,
          micro_batch_size=4), 2, 8),
    (dict(strategy="gpipe", stage_replication=(1, 3), num_devices=4,
          micro_batch_size=6), 0, 12)])
def test_spawned_ranks_and_global_batch(kw, ranks_, batch):
    base = dict(benchmark="mnist", micro_batch_size=4, num_microbatches=2)
    base.update(kw)
    for cls in (RunConfig, JaxRunConfig):
        cfg = cls(**base)
        cfg.validate()
        assert cfg.global_batch() == batch
    assert RunConfig(**base).spawned_ranks() == ranks_


@pytest.mark.parametrize("engine,kw", [
    ("gpipe", {}), ("rt", {}), ("pipedream", {}),
    ("gpipe", dict(dp_shard_update=True, comm_buckets=2))],
    ids=["gpipe", "1f1b", "pipedream", "zero1"])
def test_hybrid_comm_volume_is_the_references(engine, kw):
    """The loop's comm volume line: each replica's boundaries and the
    replicas' gradient all-reduce (pipedream's once a microbatch), or
    ZeRO-1's reduce-scatter and all-gather, as the reference counts
    them."""
    from ddlbench_tpu.train.comm_stats import comm_stats as jax_comm_stats

    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
    from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy
    from ddlbench_tpu_torch.parallel.pipeline_rt import (
        ScheduledPipelineStrategy)
    from ddlbench_tpu_torch.train.comm_stats import comm_stats

    class _Rank:
        rank, world = 0, 2

        def broadcast(self, t, src=0):
            return t

    cfg = _cfg("transformer_t", engine, **kw)
    with mock.patch.dict(jconfig.DATASETS, {"tinylm": TINY_LM}):
        jstrat = JAX_CLS[engine](JAX_MODELS["transformer_t"](),
                                 JaxRunConfig(**cfg))
        jstrat.init(jax.random.key(0))
        want = jax_comm_stats(jstrat)
    cls = {"gpipe": GPipeStrategy, "rt": ScheduledPipelineStrategy,
           "pipedream": PipeDreamStrategy}[engine]
    s = cls(hr.build_model("transformer_t"), RunConfig(**cfg),
            [torch.device("cpu")] * 2, dp_comm=_Rank())
    got = comm_stats(s)
    for k in ("boundary_bytes", "allreduce_bytes", "reduce_scatter_bytes",
              "all_gather_bytes", "total_bytes"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["total_bytes"] > got["boundary_bytes"]


class _Twin:
    """A replica group of 2 whose other rank holds this one's tensors
    plus ``offset`` (its collectives run here, on the CPU)."""

    def __init__(self, offset=0.0):
        self.rank, self.world, self.offset = 0, 2, offset

    def broadcast(self, t, src=0):
        return t

    def all_reduce(self, t, op="sum"):
        if t.is_floating_point():
            t.copy_(t + (t + self.offset))
        else:
            t.copy_(t + t)
        return t


def _dense_pipedream(dp, comm=None):
    from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy

    cfg = RunConfig(**_cfg("dense", "pipedream", dp_replicas=dp,
                           num_devices=2 * dp, momentum=0.5,
                           weight_decay=0.0))
    s = PipeDreamStrategy(hr.build_model("dense"), cfg,
                          [torch.device("cpu")] * 2, dp_comm=comm)
    s.init()
    return s


def test_pipedream_sums_every_backward_over_the_replicas():
    """Two replicas on the same rows, each backward's gradient summed
    over them: the step is one replica's at twice the rate (SGD, no
    decay: linear in the gradient), not at the rate (a mean)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 1, 4, 4)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 4, 4))
    # the global batch: each microbatch's rows for replica 0, then the
    # same rows for replica 1
    xg = torch.cat([torch.cat([t, t]) for t in x.split(2)])
    yg = torch.cat([torch.cat([t, t]) for t in y.split(2)])
    two = _dense_pipedream(2, comm=_Twin())
    one = _dense_pipedream(1)
    two.train_step(xg, yg, LR)
    one.train_step(x, y, 2 * LR)
    mean = _dense_pipedream(1)
    mean.train_step(x, y, LR)
    a, b = two.materialize_params(), one.materialize_params()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert not np.allclose(a.numpy(), mean.materialize_params().numpy(),
                           rtol=1e-4)


def test_pipedream_averages_the_replicas_at_the_step_end():
    """The step's end: parameters and float optimizer state averaged over
    the replicas (the other holding each plus 1: the mean is each plus
    0.5), the integer Adam step kept."""
    from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy

    cfg = RunConfig(**_cfg("dense", "pipedream", optimizer="adam"))
    s = PipeDreamStrategy(hr.build_model("dense"), cfg,
                          [torch.device("cpu")] * 2, dp_comm=_Twin(1.0))
    s.init()
    for st in s.opt:
        st["step"] = 3
    before = [p.detach().clone() for p in s.model.parameters()]
    m_before = [t.clone() for st in s.opt for t in st["m"]]
    s._sync_replicas()
    for p, b in zip(s.model.parameters(), before):
        torch.testing.assert_close(p.detach(), b + 0.5, rtol=0, atol=1e-6)
    for t, b in zip([t for st in s.opt for t in st["m"]], m_before):
        torch.testing.assert_close(t, b + 0.5, rtol=0, atol=1e-6)
    assert all(st["step"] == 3 for st in s.opt)
