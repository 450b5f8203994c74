"""The port's ``--plan auto`` solver (partition/planner.py) and the
cost-weighted timetables it and --auto-partition hand the runtime, held
to the reference's on the same inputs.

* ``solve_plan`` on the reference's own test graphs (tests/
  test_planner.py: light layers, the memory cap flipping the mix, ZB-H2's
  stash rejected under a cap, uneven costs forcing an unbalanced split,
  tp gated to token models, divisibility): the same winner, reason and
  candidate list, every candidate's step time, peak and stage bytes
  within 1e-9 relative.
* ``_pipe_ms``, ``_model_tp_widths`` and ``_rewrite_fields`` equal; the
  reference's --plan validation messages.
* ``chunk_cost_ms`` + ``quantize_cost_vectors_clipped`` on a profile
  graph over chosen bounds: equal vectors and clip counts.
* ``--plan auto`` end to end on gloo CPU ranks (the dp tests' rank pool,
  cases in tests/torch_plan_ranks.py), the profile stubbed as the
  reference's fixture stubs it: the resolved config equals the explicit
  flags' and the trained parameters are bitwise the explicit run's, for
  a dp winner, a one-process pipeline winner and a hybrid winner.
* A cost-weighted ``1f1b`` table (pipe_cost_vectors) trains to the unit
  table's loss and parameters within the pipeline tests' tolerances
  (loss rtol 1e-5; parameters rtol 1e-4, atol 1e-6), and the runtime
  builds the weighted table, not the unit one.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import dataclasses
import math

import numpy as np
import pytest
import torch

import torch_plan_ranks
from torch_dp_ranks import RankPool

from ddlbench_tpu.config import HardwareModel as JaxHW
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.graph.graph import Graph as JaxGraph, Node as JaxNode
from ddlbench_tpu.partition import planner as jplan
from ddlbench_tpu.partition.schedule import (
    quantize_cost_vectors_clipped as jax_quantize)
from ddlbench_tpu.profiler.profile import chunk_cost_ms as jax_chunk_cost

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import HardwareModel, RunConfig
from ddlbench_tpu_torch.graph.graph import Graph, Node
from ddlbench_tpu_torch.partition import planner as tplan
from ddlbench_tpu_torch.partition.schedule import (
    quantize_cost_vectors_clipped)
from ddlbench_tpu_torch.profiler.profile import chunk_cost_ms

pytestmark = pytest.mark.torchport

CPU = torch.device("cpu")
REL = 1e-9


@pytest.fixture(autouse=True)
def tinylm(monkeypatch):
    """"tinylm" in the port's registry for each test (the rank processes
    register it on import; another test file's fixture removes its own
    "tinylm" from this process's registry when it ends)."""
    monkeypatch.setitem(tconfig.DATASETS, "tinylm", torch_plan_ranks.TINY)


def chain_pair(times, params=None, acts=None):
    """The reference planner tests' chain: fwd+bwd ms split 1/3 : 2/3."""
    params = params or [0.0] * len(times)
    acts = acts or [0.0] * len(times)
    out = []
    for G, N in ((JaxGraph, JaxNode), (Graph, Node)):
        out.append(G.chain([N(str(i), f"layer{i}", t / 3.0, 2.0 * t / 3.0,
                              a, p)
                            for i, (t, p, a) in enumerate(
                                zip(times, params, acts))]))
    return out


def hw_pair(**kw):
    jh = JaxHW(**kw)
    return jh, HardwareModel(**dataclasses.asdict(jh))


def close(a, b):
    if a is None or b is None or a == b:
        return a == b
    return math.isclose(a, b, rel_tol=REL)


def same_candidate(got, want):
    return (
        (got.pp, got.dp, got.tp, got.schedule, got.bounds, got.feasible,
         got.reason) == (want.pp, want.dp, want.tp, want.schedule,
                         want.bounds, want.feasible, want.reason)
        and close(got.step_time_ms, want.step_time_ms)
        and close(got.peak_bytes_per_chip, want.peak_bytes_per_chip)
        and close(got.stash_bytes, want.stash_bytes)
        and (got.stage_mem is None) == (want.stage_mem is None)
        and all(close(a, b) for a, b in zip(got.stage_mem or (),
                                            want.stage_mem or ())))


# (graph args, solve_plan args, kwargs, hbm_bytes or None): the reference
# tests' fixtures
SOLVER_CASES = {
    "light_layers_h2": (([3.0] * 4, [1e4] * 4, [1e5] * 4), (4, 8, 8), {},
                        None),
    "memory_cap_roomy": (([3.0] * 4, [1e7] * 4, [1e5] * 4), (4, 8, 8), {},
                         64 * 1024**3),
    "memory_cap_flips": (([3.0] * 4, [1e7] * 4, [1e5] * 4), (4, 8, 8), {},
                         6e7),
    "h2_stash_roomy": (([3.0] * 4, [1e4] * 4, [4e7] * 4), (4, 8, 8), {},
                       64 * 1024**3),
    "h2_stash_rejected": (([3.0] * 4, [1e4] * 4, [4e7] * 4), (4, 8, 8), {},
                          7e7),
    "uneven_costs": (([1.0, 1.0, 10.0, 1.0], [1e4] * 4, [1e5] * 4),
                     (2, 8, 8), {"pin_pp": 2}, None),
    "tp_token": (([3.0] * 4, [1e4] * 4, [1e5] * 4), (4, 8, 8),
                 {"token_model": True}, None),
    "tp_image": (([3.0] * 4, [1e4] * 4, [1e5] * 4), (4, 8, 8),
                 {"token_model": False}, None),
    "divisibility": (([3.0] * 4, [1e4] * 4, [1e5] * 4), (4, 3, 8), {},
                     None),
    "adam_wide": (([2.0, 5.0, 1.0, 7.0, 3.0, 4.0], [3e8, 1e8, 2e8, 5e7, 4e8,
                                                    1e8], [2e6] * 6),
                  (8, 16, 16), {"optimizer": "adam", "token_model": True},
                  4 * 1024**3),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solve_plan_matches_the_reference(case):
    (times, params, acts), args, kw, hbm = SOLVER_CASES[case]
    jg, tg = chain_pair(times, params, acts)
    jh, th = hw_pair(**({} if hbm is None else {"hbm_bytes": hbm}))
    want = jplan.solve_plan(jg, *args, jh, **kw)
    got = tplan.solve_plan(tg, *args, th, **kw)
    assert same_candidate(got.winner, want.winner)
    assert got.reason == want.reason
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        assert same_candidate(g, w), (g, w)
        assert g.as_record() == w.as_record()


def test_the_reference_answers_hold():
    """The reference tests' hand-checked answers, on the port."""
    _, g = chain_pair([3.0] * 4, [1e7] * 4, [1e5] * 4)
    capped = tplan.solve_plan(g, 4, 8, 8, HardwareModel(hbm_bytes=6e7))
    assert capped.winner.pp > 1
    assert all(not c.feasible and "HBM" in c.reason
               for c in capped.candidates if c.pp == 1 and c.tp == 1)
    _, g = chain_pair([3.0] * 4, [1e4] * 4, [4e7] * 4)
    h2 = tplan.solve_plan(g, 4, 8, 8, HardwareModel(hbm_bytes=7e7))
    assert (h2.winner.pp, h2.winner.dp, h2.winner.schedule) == (
        2, 2, "searched")
    _, g = chain_pair([1.0, 1.0, 10.0, 1.0], [1e4] * 4, [1e5] * 4)
    assert tplan.solve_plan(g, 2, 8, 8, pin_pp=2).winner.bounds == (0, 2, 4)


@pytest.mark.parametrize("schedule", ["fill-drain", "1f1b", "zero-bubble",
                                      "zero-bubble-h2", "searched"])
def test_pipe_ms_matches(schedule):
    F, B = [10.0, 1.0, 3.5], [20.0, 2.0, 6.0]
    assert tplan._pipe_ms(schedule, 3, 4, F, B) == \
        jplan._pipe_ms(schedule, 3, 4, F, B)
    assert tplan._pipe_ms(schedule, 3, 400, F, B) == \
        jplan._pipe_ms(schedule, 3, 400, F, B)


def test_model_tp_widths_match():
    for arch in ("transformer_s", "transformer_m", "seq2seq_s",
                 "seq2seq_lstm_s", "transformer_moe_s", "lenet",
                 "resnet50"):
        for world in (2, 4, 8):
            assert tplan._model_tp_widths(arch, world) == \
                jplan._model_tp_widths(arch, world)


@pytest.mark.parametrize("world", [1, 4])
def test_rewrite_fields_match(world):
    kw = dict(strategy="gpipe", benchmark="mnist", num_devices=world,
              plan="auto", micro_batch_size=4, num_microbatches=2,
              compute_dtype="float32")
    tcfg, jcfg = RunConfig(**kw), JaxRunConfig(**kw)
    for w in [(1, 4, 1, "fill-drain", (0, 4)), (2, 2, 1, "1f1b", (0, 2, 4)),
              (1, 1, 4, "fill-drain", (0, 4)), (4, 1, 1, "zero-bubble",
                                                (0, 1, 2, 3, 4)),
              (2, 1, 2, "fill-drain", (0, 2, 4))]:
        got = tplan._rewrite_fields(tcfg, tplan.Candidate(*w, 1.0, 0.0, True),
                                    4, 2)
        want = jplan._rewrite_fields(jcfg, jplan.Candidate(*w, 1.0, 0.0,
                                                           True), 4, 2)
        assert got == want
        assert tcfg.replace(**got).global_batch() == tcfg.global_batch()


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="dp", micro_batch_size=None, num_microbatches=None,
          batch_size=8), "-f gpipe"),
    (dict(auto_partition=True), "supersedes"),
    (dict(pipe_schedule="1f1b"), "owns the parallelism mix"),
    (dict(num_stages=4), "owns the parallelism mix"),
    (dict(plan="sometimes"), "unknown plan mode")])
def test_validate_plan_flags(kw, match):
    base = dict(strategy="gpipe", benchmark="mnist", num_devices=4,
                plan="auto", micro_batch_size=4, num_microbatches=2,
                compute_dtype="float32")
    RunConfig(**base).validate()
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        JaxRunConfig(**base).validate()
    with pytest.raises(ValueError, match=match):
        RunConfig(**base).validate()


@pytest.mark.parametrize("kw,match", [
    (dict(pipe_costs="profile"), "needs --auto-partition"),
    (dict(pipe_costs="profile", auto_partition=True), "event schedule"),
    (dict(pipe_costs="sometimes"), "unknown pipe_costs"),
    (dict(pipe_cost_vectors=((1, 1), (1, 1), (1, 1))), "EVENT"),
    (dict(pipe_cost_vectors=((1, 1), (1, 1)), pipe_schedule="1f1b"),
     r"\(f, b, w\) vectors"),
    (dict(auto_partition=True, plan_bounds=(0, 1, 2)), "pick one")])
def test_validate_cost_flags(kw, match):
    base = dict(strategy="gpipe", benchmark="mnist", num_devices=2,
                micro_batch_size=4, num_microbatches=2)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        JaxRunConfig(**base).validate()
    with pytest.raises(ValueError, match=match):
        RunConfig(**base).validate()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_units", [8, 64])
def test_chunk_costs_quantize_to_equal_vectors(seed, max_units):
    rng = np.random.default_rng(seed)
    n = 10
    vals = [(str(i), f"l{i}", float(rng.uniform(0.05, 9.0)),
             float(rng.uniform(0.1, 18.0)), 1e3, 1e3) for i in range(n)]
    jg = JaxGraph.chain([JaxNode(*v) for v in vals])
    tg = Graph.chain([Node(*v) for v in vals])
    cuts = sorted(rng.choice(np.arange(1, n), 3, replace=False).tolist())
    bounds = [0] + cuts + [n]
    f, b = chunk_cost_ms(tg, bounds)
    assert (f, b) == jax_chunk_cost(jg, bounds)
    assert quantize_cost_vectors_clipped(f, b, max_units=max_units) == \
        jax_quantize(f, b, max_units=max_units)


# ---- --plan auto end to end on ranks ----------------------------------------


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _plan_graph(times, params, acts):
    return str(Graph.chain([Node(str(i), f"layer{i}", t / 3.0, 2.0 * t / 3.0,
                                 a, p) for i, (t, p, a) in enumerate(
                                     zip(times, params, acts))]))


AUTO = dict(strategy="gpipe", benchmark="tinylm", arch="transformer_t",
            plan="auto", compute_dtype="float32", epochs=1,
            steps_per_epoch=2, attention_backend="xla", seed=3)
# (pool world, stubbed graph, auto kwargs, the explicit flags, hbm, the
# winner's strategy)
E2E = {
    # light and unbalanced: no split keeps the pipeline busy, dp wins
    "dp": (2, ([1.0, 1.0, 1.0, 9.0], [1e4] * 4, [1e5] * 4),
           dict(num_devices=2, micro_batch_size=4, num_microbatches=2),
           dict(strategy="dp", batch_size=4, dp_shard_update=True,
                num_devices=2), 80e9, "dp"),
    # even: the deferred-W pipeline wins, one process walks both stages
    "pipeline": (2, ([3.0] * 4, [1e4] * 4, [1e5] * 4),
                 dict(num_devices=2, micro_batch_size=4,
                      num_microbatches=2),
                 dict(num_devices=2, num_stages=2, micro_batch_size=4,
                      num_microbatches=2, pipe_schedule="zero-bubble-h2",
                      plan_bounds=(0, 2, 4)), 80e9, "gpipe"),
    # the reference's light-layer fixture at world 4: pp 2 x dp 2, the
    # hybrid PP x ZeRO-1, one rank a replica
    "hybrid": (2, ([3.0] * 4, [1e4] * 4, [1e5] * 4),
               dict(num_devices=4, micro_batch_size=8, num_microbatches=8),
               dict(num_devices=4, num_stages=2, dp_replicas=2,
                    micro_batch_size=4, num_microbatches=8,
                    pipe_schedule="zero-bubble-h2", dp_shard_update=True,
                    plan_bounds=(0, 2, 4)), 80e9, "gpipe"),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_plan_auto_e2e_bitwise(ranks, case):
    world, graph, auto, explicit, hbm, strategy = E2E[case]
    got = ranks.run("torch_plan_ranks:plan_auto_vs_explicit", world,
                    graph=_plan_graph(*graph), auto={**AUTO, **auto},
                    explicit={**AUTO, "plan": "manual", **explicit},
                    hbm_bytes=hbm)
    for equal_cfg, bitwise, resolved in got:
        assert resolved == strategy
        assert equal_cfg, "the resolved config differs from the flags'"
        assert bitwise, "the --plan auto run differs from the explicit run"


# ---- cost-weighted timetables train as the unit ones do --------------------


def test_cost_weighted_1f1b_trains_to_the_unit_tables_result():
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.partition.schedule import make_timetable

    base = dict(strategy="gpipe", benchmark="tinylm", arch="transformer_t",
                num_devices=2, micro_batch_size=2, num_microbatches=4,
                pipe_schedule="1f1b", compute_dtype="float32",
                attention_backend="xla", seed=5)
    vectors = ((1, 4), (2, 8), (2, 8))
    unit = make_strategy(RunConfig(**base), CPU)
    weighted = make_strategy(RunConfig(**base, pipe_cost_vectors=vectors),
                             CPU)
    assert weighted.timetable.half_ticks == make_timetable(
        "1f1b", 2, 4, 1, costs=vectors).half_ticks
    assert weighted.timetable.half_ticks != unit.timetable.half_ticks
    data = make_synthetic(RunConfig(**base).dataset(), 8, CPU, seed=5)
    for i in range(2):
        x, y = data.batch(1, i)
        lu = float(unit.train_step(x, y, 0.05)["loss"])
        lw = float(weighted.train_step(x, y, 0.05)["loss"])
        assert lw == pytest.approx(lu, rel=1e-5)
    for pu, pw in zip(unit.model.parameters(), weighted.model.parameters()):
        np.testing.assert_allclose(pw.detach().numpy(), pu.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_uniform_auto_partition_plan_trains_on_its_ranks(ranks, monkeypatch):
    """A uniform plan's replicas are ranks: the plan made once in this
    process (as the CLI's prepare_run makes it) runs on two gloo ranks,
    the hybrid at the plan's bounds and mb // 2, the ranks' losses
    equal."""
    import ddlbench_tpu_torch.profiler.profile as prof
    from ddlbench_tpu_torch.parallel.api import auto_partition

    # light, and no cut balances it: replicating everything wins
    light = Graph.chain([Node(str(i), f"layer{i}", t, 0.0, 1e5, 1e4)
                         for i, t in enumerate([4.0, 4.0, 4.0, 9.0])])
    monkeypatch.setattr(prof, "profile_model", lambda *a, **k: light)
    cfg = RunConfig(strategy="gpipe", benchmark="tinylm",
                    arch="transformer_t", num_devices=2, auto_partition=True,
                    micro_batch_size=4, num_microbatches=2,
                    compute_dtype="float32", attention_backend="xla")
    part = auto_partition(cfg, CPU)
    assert (part.cfg.dp_replicas, part.cfg.num_stages) == (2, 1)
    got = ranks.run("torch_plan_ranks:uniform_plan_trains", 2, part=part)
    assert [g[:4] for g in got] == [("GPipeStrategy", [0, 4], 2, 2)] * 2
    assert got[0][4] == got[1][4] and math.isfinite(got[0][4])
