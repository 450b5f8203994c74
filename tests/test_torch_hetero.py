"""Uneven stage replication (parallel/hetero.py) held to the reference's
``HeteroGPipeStrategy`` and ``HeteroPipeDreamStrategy`` on the CPU.

The reference runs the plan on N = sum(r) virtual CPU devices over its
flat 'pipe' axis; the port in one process over N CPU "devices". Both
start from the reference's weights (convert.py) and take the same numpy
batches (tests/torch_pipes.py's tiny models and batches), micro-batch 6
x 2 microbatches, plans (1, 3) and (2, 1), two steps at lr 0.05:

* each step's loss (rtol 1e-5) and accuracy, every stage's packed
  parameter row after each step against the reference's rows at the
  stage's first device (rtol 1e-4, atol 1e-6; the reference's rows go
  back into a port model through convert.load_hetero_rows and give the
  port's rows), every replica of a stage equal (exactly), BatchNorm's
  state rows (rtol 1e-4, atol 1e-6: each replica's statistics over its
  rows, averaged over the stage's replicas), the eval step's sums;
* the MoE model (tests/torch_pipes.py "moe": a Switch MoE block, no
  token dropped), whose router losses are averaged over a stage's
  replicas: through the objective it moves every gradient, so the
  trajectory pins the averaging;
* fill-drain with ``remat_stages`` off (every replica's graph kept) on
  the BatchNorm and token models;
* the fill-drain plan against the port's uniform gpipe at the same
  global batch on the stateless models (rtol 1e-5: only the order of the
  row sums differs);
* the reference's comm volume for the plan.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
import ddlbench_tpu_torch.config as tconfig
import torch_pipes as tp
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.hetero import (HeteroGPipeStrategy as JaxHG,
                                          HeteroPipeDreamStrategy as JaxHP)
from ddlbench_tpu.train.comm_stats import comm_stats as jax_comm_stats

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        load_hetero_rows)
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
from ddlbench_tpu_torch.parallel.hetero import (HeteroGPipeStrategy,
                                                HeteroPipeDreamStrategy)
from ddlbench_tpu_torch.train.comm_stats import comm_stats

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)
LR = 0.05
MB, M = 6, 2
CPU = torch.device("cpu")
JAX = {"gpipe": JaxHG, "pipedream": JaxHP}
PORT = {"gpipe": HeteroGPipeStrategy, "pipedream": HeteroPipeDreamStrategy}


@pytest.fixture(autouse=True)
def tiny_datasets():
    jsets, tsets = tp.datasets()
    with mock.patch.dict(jconfig.DATASETS, jsets), \
            mock.patch.dict(tconfig.DATASETS, tsets):
        yield


def _kw(name, engine, repl, **kw):
    base = tp.config_kw(name, strategy=engine, num_devices=sum(repl),
                        stage_replication=tuple(repl), micro_batch_size=MB,
                        num_microbatches=M, **kw)
    if engine == "pipedream":
        base["batch_size"] = MB * M
    return base


def _pair(name, engine, repl, **kw):
    kw = _kw(name, engine, repl, **kw)
    jcfg, cfg = JaxRunConfig(**kw), RunConfig(**kw)
    jcfg.validate()
    cfg.validate()
    jstrat = JAX[engine](tp.jax_model(name), jcfg)
    ts = jstrat.init(jax.random.key(0))
    params, states, _ = init_model(jstrat.model, jax.random.key(0))
    model = tp.port_model(name)
    from_jax_params(model, jax.device_get(params))
    from_jax_state(model, jax.device_get(states))
    strat = PORT[engine](model, cfg, [CPU] * sum(repl))
    strat.init()
    assert strat.bounds == list(jstrat.bounds)
    return jstrat, ts, strat


def _state_rows(strat, s, k):
    from ddlbench_tpu_torch.parallel.common import _key_part

    vals = []
    for layer in strat.replicas[s][k]:
        named = sorted(layer.named_buffers(),
                       key=lambda kv: tuple(map(_key_part,
                                                kv[0].split("."))))
        vals += [b.detach().reshape(-1).numpy() for _, b in named]
    return np.concatenate(vals) if vals else np.zeros(0)


def _replicas_equal(strat):
    for s, reps in enumerate(strat.replicas):
        for k in range(1, len(reps)):
            for a, b in zip(strat.replica_params(s, 0),
                            strat.replica_params(s, k)):
                assert torch.equal(a, b), (s, k)
            for a, b in zip([t for layer in reps[0] for t in layer.buffers()],
                            [t for layer in reps[k]
                             for t in layer.buffers()]):
                assert torch.equal(a, b), (s, k)


def _run(name, engine, repl, steps=2, **kw):
    jstrat, ts, strat = _pair(name, engine, repl, **kw)
    data = tp.batches(name, MB * M, steps + 1)
    ref, mine = [], []
    for x, y in data[:steps]:
        ts, jm = jstrat.train_step(ts, *jstrat.shard_batch(x, y),
                                   jnp.float32(LR))
        pm = strat.train_step(tp.to_port(x), tp.to_port(y), LR)
        ref.append((float(jm["loss"]), float(jm["accuracy"]),
                    np.asarray(ts.params)))
        mine.append((float(pm["loss"]), float(pm["accuracy"]),
                     strat.materialize_params().numpy()))
    return jstrat, ts, strat, data, ref, mine


CASES = [(n, e, r, {}) for e, names in (
    ("gpipe", ("dense", "bn", "transformer_t", "moe")),
    ("pipedream", ("dense", "bn", "transformer_t")))
    for n in names for r in ((1, 3), (2, 1))] + [
    # every replica's graph kept instead of the recompute
    ("bn", "gpipe", (2, 1), {"remat_stages": False}),
    ("transformer_t", "gpipe", (1, 3), {"remat_stages": False})]


@pytest.mark.parametrize("name,engine,repl,kw", CASES,
                         ids=[f"{e}-{n}-{r[0]}_{r[1]}"
                              + ("-noremat" if kw else "")
                              for n, e, r, kw in CASES])
def test_hetero_matches_the_reference(name, engine, repl, kw):
    jstrat, ts, strat, data, ref, mine = _run(name, engine, repl, **kw)
    offs = strat._offsets[:-1]
    for (jl, ja, jp), (pl, pa, pp) in zip(ref, mine):
        np.testing.assert_allclose(pl, jl, **LOSS)
        assert abs(pa - ja) <= 1e-6
        want = jp[offs][:, :pp.shape[1]]
        np.testing.assert_allclose(pp, want, **PARAM)
    assert ref[0][0] != ref[-1][0]  # the steps moved
    _replicas_equal(strat)
    states = np.asarray(ts.model_state)
    for s in range(strat.num_stages):
        got = _state_rows(strat, s, 0)
        np.testing.assert_allclose(got, states[offs[s]][:got.size],
                                   rtol=1e-4, atol=1e-6)
    x, y = data[-1]
    jm = jstrat.eval_step(ts, *jstrat.shard_batch(x, y))
    pm = strat.eval_step(tp.to_port(x), tp.to_port(y))
    for k in ("correct", "correct5", "count"):
        assert int(pm[k]) == int(jm[k]), k
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), **LOSS)
    # the reference's rows, converted, give the port's
    twin = PORT[engine](tp.port_model(name), strat.cfg, [CPU] * strat.N)
    load_hetero_rows(twin, jax.device_get(ts.params))
    np.testing.assert_array_equal(
        twin.materialize_params().numpy(),
        np.asarray(ts.params)[offs][:, :mine[-1][2].shape[1]])
    _replicas_equal(twin)


@pytest.mark.parametrize("name,repl", [("dense", (1, 3)), ("dense", (2, 1)),
                                       ("transformer_t", (2, 1))])
def test_fill_drain_plan_equals_the_uniform_gpipe(name, repl):
    """Replication splits rows, so a plan's step is the uniform
    pipeline's at the same global batch (the stateless models; every
    label valid: the hetero objective's global mean over valid labels is
    then gpipe's mean of microbatch means)."""
    _, _, strat = _pair(name, "gpipe", repl)
    base = tp.config_kw(name, strategy="gpipe", num_devices=2,
                        micro_batch_size=MB, num_microbatches=M)
    model = tp.port_model(name)
    model.load_state_dict(strat.model.state_dict())
    uni = GPipeStrategy(model, RunConfig(**base), [CPU] * 2)
    uni.init()
    assert uni.bounds == strat.bounds
    for x, y in tp.batches(name, MB * M, 2):
        y = np.where(y < 0, 0, y)
        a = strat.train_step(tp.to_port(x), tp.to_port(y), LR)
        b = uni.train_step(tp.to_port(x), tp.to_port(y), LR)
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(strat.materialize_params().numpy(),
                               uni.materialize_params().numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("engine", ["gpipe", "pipedream"])
def test_hetero_comm_volume_is_the_references(engine):
    jstrat, _, strat = _pair("transformer_t", engine, (1, 3))
    want, got = jax_comm_stats(jstrat), comm_stats(strat)
    for k in ("boundary_bytes", "allreduce_bytes", "total_bytes",
              "physical_conveyor_bytes", "physical_allreduce_bytes"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_uneven_plans_run_in_one_process():
    cfg = RunConfig(**_kw("dense", "gpipe", (1, 3)))
    assert cfg.spawned_ranks() == 0 and cfg.global_batch() == MB * M
    from ddlbench_tpu_torch.parallel.api import make_strategy

    s = make_strategy(RunConfig(**{**_kw("dense", "pipedream", (2, 1)),
                                   "benchmark": "mnist", "arch": "lenet"}),
                      CPU)
    assert type(s) is HeteroPipeDreamStrategy and s.N == 3
    assert [len(r) for r in s.replicas] == [2, 1]
