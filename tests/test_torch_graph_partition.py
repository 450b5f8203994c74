"""The port's profile graph, hierarchical partitioner and its C++ core
(graph/graph.py, partition/optimizer.py, partition/native.py,
tools/graphtool.py) held to the reference's on the same inputs.

* The graph text format both ways, byte for byte: a graph written by
  either package loads in the other and writes the same text; the DOT
  output, branch compression, antichain DAG and CSV import agree.
* ``partition_hierarchical`` on random chains from a numpy seed, the
  Python DP and the C++ core, 1 and 2 hosts, with and without the memory
  check, forward-only: equal stages and bitwise-equal
  ``pipeline_time_ms`` on the same Graph and HardwareModel values.
* ``partition_interleaved``, ``capped_balanced_split``,
  ``stage_bounds_from_graph`` and ``stamp_stage_ids`` likewise.
* The C++ core builds into build/torch_kernels/ and the result names it.
* ``--auto-partition`` with the profile stubbed (the reference's
  fixture): an uneven plan routes to the hetero strategy at the plan's
  bounds and replication, a uniform plan to the hybrid at mb // r.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddlbench_tpu.config import HardwareModel as JaxHW
from ddlbench_tpu.graph.graph import Graph as JaxGraph, Node as JaxNode
from ddlbench_tpu.partition import optimizer as jopt

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, HardwareModel, RunConfig
from ddlbench_tpu_torch.graph.graph import Graph, Node
from ddlbench_tpu_torch.partition import native, optimizer as topt

pytestmark = pytest.mark.torchport

CPU = torch.device("cpu")
TINY3 = DatasetSpec("tinyplan3", (4, 4, 1), 10, 64, 16)
tconfig.DATASETS.setdefault("tinyplan3", TINY3)


def _values(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(str(i), f"l{i}", float(rng.uniform(0.1, 20.0)) * scale,
             float(rng.uniform(0.1, 40.0)) * scale,
             float(rng.uniform(1e3, 1e8)), float(rng.uniform(1e3, 1e8)))
            for i in range(n)]


def both_chains(n, seed):
    vals = _values(n, seed)
    return (JaxGraph.chain([JaxNode(*v) for v in vals]),
            Graph.chain([Node(*v) for v in vals]))


def dag_pair():
    """A branchy graph (fork, two branch bodies, join) in both packages."""
    out = []
    for G, N in ((JaxGraph, JaxNode), (Graph, Node)):
        g = G()
        for i, name in enumerate("abcdefg"):
            g.add_node(N(name, f"op_{name}", 1.0 + i, 2.0 + i, 1e3 * (i + 1),
                         10.0 * i))
        for a, b in ("ab", "ac", "bd", "ce", "df", "ef", "fg"):
            g.add_edge(a, b)
        g.nodes["d"].stage_id = 1
        out.append(g)
    return out


def hw_pair(**kw):
    jh = JaxHW(**kw)
    return jh, HardwareModel(**dataclasses.asdict(jh))


def spans(result):
    return [(s.start, s.end, s.replication) for s in result.stages]


# ---- the graph -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_text_round_trip_both_ways(seed):
    jg, tg = both_chains(9, seed)
    tg.nodes["3"].stage_id = jg.nodes["3"].stage_id = 2
    assert str(tg) == str(jg)
    assert str(Graph.from_str(str(jg))) == str(jg)
    assert str(JaxGraph.from_str(str(tg))) == str(tg)
    jd, td = dag_pair()
    assert str(td) == str(jd)
    assert str(Graph.from_str(str(jd))) == str(jd)
    assert str(JaxGraph.from_str(str(td))) == str(td)


def test_dot_compress_antichains_agree():
    jd, td = dag_pair()
    assert td.to_dot() == jd.to_dot()
    assert str(td.compress_branches()) == str(jd.compress_branches())
    td.check_fidelity(td.compress_branches())
    js, jadj = jd.antichain_dag()
    ts, tadj = td.antichain_dag()
    assert ts == js and tadj == jadj
    assert td.is_series_parallel() == jd.is_series_parallel()
    assert [n.node_id for n in td.topological_sort()] == \
        [n.node_id for n in jd.topological_sort()]
    assert [str(p) for p in td.partition()] == \
        [str(p) for p in jd.partition()]


def test_from_profile_csv_agrees(tmp_path):
    path = tmp_path / "profile.csv"
    path.write_text(
        "Layer Type,Forward pass time (10),Total time,Output Size,"
        "Parameter Size (floats)\n"
        "Conv2d,1,3.5,\"1,024\",300\nReLU,1,0.5,1024,0\n"
        "Linear,1,7.25,10,10250\n")
    assert str(Graph.from_profile_csv(str(path))) == \
        str(JaxGraph.from_profile_csv(str(path)))


def test_graphtool_matches_the_reference(tmp_path):
    jd, _ = dag_pair()
    src = tmp_path / "graph.txt"
    src.write_text(str(jd))
    env = dict(os.environ, PYTHONPATH=os.getcwd(), JAX_PLATFORMS="cpu")
    for cmd in ("compress", "dot"):
        for pkg in ("ddlbench_tpu", "ddlbench_tpu_torch"):
            subprocess.run([sys.executable, "-m", f"{pkg}.tools.graphtool",
                            cmd, str(src), str(tmp_path / f"{pkg}_{cmd}")],
                           check=True, env=env, capture_output=True)
        for name in ("graph.txt", "graph.dot"):
            assert (tmp_path / f"ddlbench_tpu_torch_{cmd}" / name
                    ).read_text() == (tmp_path / f"ddlbench_tpu_{cmd}"
                                      / name).read_text()


def test_graphtool_imports_no_matplotlib():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, ddlbench_tpu_torch.tools."
         "graphtool; print('matplotlib' in sys.modules)"],
        check=True, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
    assert out.stdout.strip() == "False"


# ---- the hierarchical partitioner ------------------------------------------


def test_cpp_core_builds_into_the_build_directory():
    assert native.available(), native.build_error()
    lib = native.build()
    assert lib.parent.name == "torch_kernels" and lib.name.startswith(
        "partitioner-")
    _, tg = both_chains(6, 0)
    assert topt.partition_hierarchical(tg, 4, HardwareModel()).core == "c++"
    assert topt.partition_hierarchical(tg, 4, HardwareModel(),
                                       use_native=False).core == "python"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("chips,hosts", [(4, 1), (8, 1), (8, 2)])
@pytest.mark.parametrize("memory_check,forward_only",
                         [(True, False), (False, False), (True, True)])
def test_partition_hierarchical_matches(seed, use_native, chips, hosts,
                                        memory_check, forward_only):
    jg, tg = both_chains(12, seed)
    # a cap that binds: some spans cannot hold their stashed versions
    jh, th = hw_pair(hbm_bytes=6e8)
    want = jopt.partition_hierarchical(
        jg, chips, jh, num_hosts=hosts, memory_check=memory_check,
        use_native=use_native, forward_only=forward_only)
    got = topt.partition_hierarchical(
        tg, chips, th, num_hosts=hosts, memory_check=memory_check,
        use_native=use_native, forward_only=forward_only)
    assert spans(got) == spans(want)
    assert got.pipeline_time_ms == want.pipeline_time_ms
    assert got.num_chips_used == want.num_chips_used
    assert got.stage_bounds() == want.stage_bounds()
    assert got.core == ("c++" if use_native else "python")


def test_memory_check_binds_in_both():
    """The cap changes the plan (so the parametrized equality above
    covers a binding memory gate)."""
    jg, tg = both_chains(12, 0)
    jh, th = hw_pair(hbm_bytes=6e8)
    free = topt.partition_hierarchical(tg, 8, th, memory_check=False)
    capped = topt.partition_hierarchical(tg, 8, th, memory_check=True)
    assert spans(free) != spans(capped)
    assert spans(capped) == spans(jopt.partition_hierarchical(jg, 8, jh))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("virtual", [2, 3])
@pytest.mark.parametrize("hosts", [1, 2])
def test_partition_interleaved_matches(seed, virtual, hosts):
    jg, tg = both_chains(16, seed)
    jh, th = hw_pair()
    want = jopt.partition_interleaved(jg, 4, virtual, jh, num_hosts=hosts,
                                      num_microbatches=8, micro_batch=4)
    got = topt.partition_interleaved(tg, 4, virtual, th, num_hosts=hosts,
                                     num_microbatches=8, micro_batch=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_capped_balanced_split_matches(seed):
    rng = np.random.default_rng(seed)
    n = 10
    t = rng.uniform(0.1, 5.0, n)
    mem = rng.uniform(1.0, 4.0, n)
    edge = rng.uniform(0.0, 1.0, n)
    pre_t = np.concatenate([[0.0], np.cumsum(t)])
    pre_m = np.concatenate([[0.0], np.cumsum(mem)])
    cap = float(rng.uniform(6.0, 12.0))
    args = (lambda i, j: float(pre_t[j] - pre_t[i]),
            lambda i: float(edge[i]),
            lambda i, j: float(pre_m[j] - pre_m[i]) <= cap)
    for stages in (1, 2, 3, 5, 11):
        assert topt.capped_balanced_split(n, stages, *args) == \
            jopt.capped_balanced_split(n, stages, *args)


def test_stage_bounds_and_stage_ids_match():
    jg, tg = both_chains(11, 4)
    for s in (2, 3, 4):
        assert topt.stage_bounds_from_graph(tg, s) == \
            jopt.stage_bounds_from_graph(jg, s)
    jh, th = hw_pair()
    jopt.stamp_stage_ids(jg, jopt.partition_hierarchical(jg, 4, jh))
    topt.stamp_stage_ids(tg, topt.partition_hierarchical(tg, 4, th))
    assert str(tg) == str(jg)


# ---- --auto-partition routes the plan --------------------------------------


def tiny3():
    from ddlbench_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(0)
    return L.LayerModel("tiny3", [
        L.Flatten("flatten", (4, 4, 1)),
        L.Dense("fc1", (16,), 16, relu=True, gen=gen),
        L.Dense("fc2", (16,), 10, gen=gen)], (4, 4, 1), 10)


def planned_graph(times, params, acts):
    """The reference test's chain: fwd ms = the time, no backward."""
    return Graph.chain([Node(str(i), f"layer{i}", t, 0.0, a, p)
                        for i, (t, p, a) in enumerate(zip(times, params,
                                                          acts))])


def test_auto_partition_is_load_bearing(monkeypatch, capsys):
    """make_strategy executes the hierarchical plan: an uneven plan runs
    the hetero strategy at the plan's bounds and replication (the
    reference's fixture and answer), and it trains."""
    import ddlbench_tpu_torch.parallel.api as api
    import ddlbench_tpu_torch.profiler.profile as prof
    from ddlbench_tpu_torch.parallel.hetero import HeteroGPipeStrategy

    g = planned_graph([6.0, 6.0, 36.0], [45e6, 45e6, 1e4], [1e5] * 3)
    monkeypatch.setattr(api, "get_model", lambda *a, **k: tiny3())
    monkeypatch.setattr(prof, "profile_model", lambda *a, **k: g)
    cfg = RunConfig(strategy="gpipe", benchmark="tinyplan3", arch="tiny3",
                    num_devices=4, auto_partition=True, micro_batch_size=6,
                    num_microbatches=2, compute_dtype="float32")
    strat = api.make_strategy(cfg, CPU)
    assert isinstance(strat, HeteroGPipeStrategy)
    assert tuple(strat.cfg.stage_replication) == (1, 3)
    assert list(strat.bounds) == [0, 2, 3]
    assert "auto-partition: executing plan [(0, 2, 1), (2, 3, 3)]" in \
        capsys.readouterr().out
    x = torch.randn(12, 1, 4, 4, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (12,), generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(strat.train_step(x, y, 0.1)["loss"]))


def test_auto_partition_uniform_plan_routes_to_regular_mesh(monkeypatch):
    """A pure-DP plan (one stage, full replication) becomes the hybrid
    (one stage, dp_replicas 2) at mb // 2, whose replicas are ranks: the
    plan is made before they start (the CLI's prepare_run), and
    make_strategy without a rank refuses it by name."""
    import ddlbench_tpu_torch.parallel.api as api
    import ddlbench_tpu_torch.profiler.profile as prof

    g = planned_graph([4.0, 4.0, 4.0], [1e4] * 3, [1e5] * 3)
    monkeypatch.setattr(api, "get_model", lambda *a, **k: tiny3())
    monkeypatch.setattr(prof, "profile_model", lambda *a, **k: g)
    cfg = RunConfig(strategy="gpipe", benchmark="tinyplan3", arch="tiny3",
                    num_devices=2, auto_partition=True, micro_batch_size=4,
                    num_microbatches=2, compute_dtype="float32")
    part = api.auto_partition(cfg, CPU)
    assert part.bounds == [0, 3]
    assert (part.cfg.num_stages, part.cfg.dp_replicas,
            part.cfg.stage_replication) == (1, 2, None)
    assert part.cfg.resolved_batches() == (2, 2)
    assert part.cfg.global_batch() == cfg.global_batch() == 8
    assert part.cfg.spawned_ranks() == 2
    with pytest.raises(ValueError, match="runs on a rank"):
        api.make_strategy(cfg, CPU, partition=part)


@pytest.mark.parametrize("arch", ["inception_t", "nasnet_t"])
def test_auto_partition_runs_a_branchy_arch_at_the_plans_node_cuts(arch,
                                                                   capsys):
    """A branchy arch: the DAG profiled node by node, chained with packed
    boundaries, partitioned, and run as the packed chain cut at the
    plan's node positions (one span a chunk)."""
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.branchy import get_dag
    from ddlbench_tpu_torch.parallel.api import auto_partition, make_strategy

    cfg = RunConfig(benchmark="cifar10", arch=arch, strategy="gpipe",
                    num_devices=2, auto_partition=True, micro_batch_size=2,
                    num_microbatches=2, compute_dtype="float32")
    part = auto_partition(cfg, CPU)
    n = len(get_dag(arch, (32, 32, 3), 10).layers)
    assert len(part.graph.nodes) == n
    assert part.cuts and all(0 < c < n for c in part.cuts)
    assert part.bounds == list(range(len(part.cuts) + 2))
    out = capsys.readouterr().out
    assert f"packed-boundary chain, {len(part.cuts) + 1} spans" in out
    strat = make_strategy(cfg, CPU, partition=part)
    assert strat.model.name == f"{arch}_packed"
    assert len(strat.model.layers) == len(part.cuts) + 1
    x, y = make_synthetic(cfg.dataset(), 4, CPU, seed=0).batch(0, 0)
    assert np.isfinite(float(strat.train_step(x, y, 0.05)["loss"]))
