"""The port's serving engine and servebench (ddlbench_tpu_torch/serve/,
tools/servebench.py) held against the JAX reference on the tiny LM.

With the reference's weights carried over (convert.py), the port's engine
must emit token streams IDENTICAL to the JAX engine's (built as
tests/conftest.py:serve_factory builds it) through chunked admission,
unchunked admission and eviction/recompute, and the port's servebench row
must equal the JAX row on every virtual-time field: those are model-pass
units, so they do not depend on the framework. Also pinned: the entry
point refuses to fall back to the CPU silently, the port imports neither
jax nor the JAX package, and the reference's ServeConfig knob the port
does not carry (tp > 1) raises instead of being ignored, while the
fleet's (replicas, heartbeat) and the SDC ledger's (integrity, scrub)
validate as the reference's do.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import ast
import json
import pathlib
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.workload import ServeRequest as JaxRequest
from ddlbench_tpu.serve.workload import make_workload as jax_workload

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, ServeConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.serve.engine import ServeEngine
from ddlbench_tpu_torch.serve.workload import ServeRequest, make_workload
from ddlbench_tpu_torch.tools import servebench

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_lm(serve_factory):
    """The port's tiny LM carrying the session JAX LM's weights."""
    tm = build_transformer("transformer_t", TINY_LM.image_size, VOCAB)
    return from_jax_params(tm, jax.device_get(serve_factory.params))


def _drain(eng, reqs):
    """Submit everything at t=0 and step to completion; returns the
    finished records by rid."""
    for r in reqs:
        eng.submit(r)
    now = 0.0
    while eng.has_work():
        now += eng.step(now).cost
    return {f["rid"]: f for f in eng.finished}


CONFIGS = {
    # chunked admission with mixed prefill/decode steps
    "chunked": (dict(max_batch=2, pool_pages=9, page=4, max_len=16,
                     prefill_chunk=4, token_budget=10), 11, (3, 9), 4),
    # the whole prompt in ONE padded prefill call
    "unchunked": (dict(max_batch=2, pool_pages=17, page=4, max_len=16,
                       prefill_chunk=0), 12, (7, 5), 5),
    # 8 usable pages for two requests needing ~6 each: the second is
    # evicted and recomputed
    "eviction": (dict(max_batch=2, pool_pages=9, page=4, max_len=24,
                      prefill_chunk=4), 13, (9, 9), 12),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_streams_identical_to_jax(serve_factory, port_lm, name):
    kw, seed, lens, max_new = CONFIGS[name]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, size=(s,)).astype(np.int32)
               for s in lens]
    jeng = serve_factory(JaxServeConfig(**kw))
    want = _drain(jeng, [JaxRequest(rid=i, prompt=p, max_new=max_new,
                                    arrival=0.0)
                         for i, p in enumerate(prompts)])
    teng = ServeEngine(port_lm, ServeConfig(**kw), CPU)
    got = _drain(teng, [ServeRequest(rid=i, prompt=p, max_new=max_new,
                                     arrival=0.0)
                        for i, p in enumerate(prompts)])
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["token_times"] == want[rid]["token_times"], rid
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for k in ts:
        assert ts[k] == js[k], k
    if name == "eviction":
        assert ts["evicted"] > 0
    assert teng.allocator.in_use == 0


def test_workload_identical_to_jax():
    kw = dict(seed=3, n_requests=12, vocab=VOCAB, prompt_lo=2,
              prompt_typical=6, prompt_hi=14, out_lo=2, out_typical=6,
              out_hi=12, max_len=28)
    for arrival in ("poisson", "bursty", "closed"):
        want = jax_workload(arrival=arrival, **kw)
        got = make_workload(arrival=arrival, **kw)
        for g, w in zip(got, want):
            assert (g.rid, g.max_new, g.arrival) == (w.rid, w.max_new,
                                                     w.arrival)
            np.testing.assert_array_equal(g.prompt, w.prompt)


SERVEBENCH_ARGS = [
    "-m", "transformer_t", "-b", "tinylm", "--arrival", "closed",
    "--concurrency", "4", "--requests", "8", "--max-batch", "2",
    "--pool-pages", "9", "--page", "4", "--max-len", "16",
    "--prompt-lens", "2,4,8", "--out-lens", "2,4,8",
    "--slo-ttft", "8", "--slo-itl", "2.5", "--seed", "5",
]
_JAX_PROV = {"schema_version", "jax_backend", "jax_device_count",
             "cpu_requested", "cpu_fallback"}
# the port's provenance keys, and its count of plain-path calls on CUDA
_PORT_PROV = {"schema_version", "platform", "device_kind", "device_count",
              "torch_version", "cuda_version", "plain_launches"}


def test_servebench_row_equals_jax_row(capsys, serve_factory, port_lm):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched):
        assert jax_servebench.main(SERVEBENCH_ARGS
                                   + ["--platform", "cpu"]) == 0
    jrows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]

    tiny = DatasetSpec("tinylm", TINY_LM.image_size, VOCAB, 1000, 100,
                       kind="tokens")
    args = servebench.build_parser().parse_args(
        SERVEBENCH_ARGS + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": tiny}):
        trows = [rec for rec, _, _ in servebench.run(args, port_lm, CPU)]
    assert [r["policy"] for r in trows] == [r["policy"] for r in jrows] \
        == ["continuous", "static"]
    for t, j in zip(trows, jrows):
        assert set(t) - _PORT_PROV == set(j) - _JAX_PROV
        for k in set(j) - _JAX_PROV:
            assert t[k] == j[k], k
        assert t["platform"] == "cpu" and t["completed"] == 8
    # continuous batching wins goodput under SLO, as in the reference
    assert trows[0]["goodput_tokens_per_unit"] \
        > trows[1]["goodput_tokens_per_unit"]


def test_servebench_main_prints_rows_on_cpu(capsys):
    tiny = DatasetSpec("tinylm", TINY_LM.image_size, VOCAB, 1000, 100,
                       kind="tokens")
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": tiny}):
        assert servebench.main(SERVEBENCH_ARGS[:-2] + [
            "--policies", "continuous", "--wall-clock",
            "--device", "cpu"]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and rows[0]["completed"] == 8
    assert rows[0]["decode_step_ms"] > 0 and rows[0]["wall_s"] > 0
    assert rows[0]["plain_launches"] == 0  # the CPU path is never counted


def test_servebench_without_gpu_or_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        servebench.main(["-m", "transformer_t", "--requests", "1"])


@pytest.mark.parametrize("knob", [
    dict(tp=2), dict(replicas=4, tp=2),
])
def test_unported_serve_knobs_raise(knob):
    """tp > 1, once refused here naming ROADMAP A.7, is ported: the
    config validates (tests/test_torch_serve_tp.py holds the tp groups'
    streams); tp 0 stays refused."""
    ServeConfig(**knob).validate()
    with pytest.raises(ValueError, match="positive"):
        ServeConfig(**{**knob, "tp": 0}).validate()


@pytest.mark.parametrize("knob,error", [
    (dict(integrity=True), None), (dict(integrity=True, scrub=4), None),
    (dict(scrub=1), ValueError), (dict(integrity=True, scrub=-1),
                                  ValueError),
])
def test_sdc_serve_knobs_validate_as_the_reference(knob, error):
    """The SDC ledger's knobs are ported: they validate where the
    reference's do (integrity alone is the boundary-only ledger) and raise
    its ValueError where it raises (scrub without integrity, a negative
    scrub)."""
    if error is None:
        ServeConfig(**knob).validate()
        JaxServeConfig(**knob).validate()
        return
    with pytest.raises(error) as got:
        ServeConfig(**knob).validate()
    with pytest.raises(error) as want:
        JaxServeConfig(**knob).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob,error", [
    (dict(replicas=2), None), (dict(heartbeat=4.0), None),
    (dict(replicas=0), ValueError), (dict(heartbeat=-1.0), ValueError),
])
def test_fleet_serve_knobs_validate_as_the_reference(knob, error):
    """The fleet's knobs are ported: they validate where the reference's
    do and raise its ValueError where it raises."""
    if error is None:
        ServeConfig(**knob).validate()
        JaxServeConfig(**knob).validate()
        return
    with pytest.raises(error) as got:
        ServeConfig(**knob).validate()
    with pytest.raises(error) as want:
        JaxServeConfig(**knob).validate()
    assert str(got.value) == str(want.value)


def _port_files():
    files = sorted((REPO / "ddlbench_tpu_torch").rglob("*.py"))
    assert len(files) >= 13
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_jax_package():
    """No module of ddlbench_tpu_torch/, and not chip_smoke.py, imports
    jax (or jaxlib) or anything of ddlbench_tpu."""
    banned = ("jax", "jaxlib", "ddlbench_tpu")
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: {n}"
