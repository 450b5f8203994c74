"""The port's servechaos (ddlbench_tpu_torch/tools/servechaos.py) held
against the reference's tool on the CPU: the counterparts of tests/
test_serve_chaos.py's servechaos runs, on the tiny LM for both sides
(the reference's own runs of these are slow-marked; on the tiny LM they
take seconds).

* Each row equals the reference's on every field but the provenance:
  the kill and stall ledgers, the heartbeat drains, MTTR, the stream gate
  against the unfaulted control, the deadline accounting, and under
  ``--autoscale`` the repair ledger, the scripted baseline's MTTR and the
  repair-vs-scripted verdict. Each also passes the reference's gates
  (no request lost, streams equal to the control's).
* The same seed and faults give the same row.
* The argument errors are the reference's, those of ``--corrupt``,
  ``--no-detect``, ``--scrub`` and ``--disaggregate`` among them; without
  a card and without ``--device cpu`` the tool raises.
* Three planted faults are caught: a kill that drops the killed
  replica's queue (a request is lost), a step that kicks a stalled
  replica's monitor (no heartbeat drain: the row differs) and dispatch to
  the most-loaded replica (the row differs).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import contextlib
import io
import json
import unittest.mock as mock

import pytest
import torch

from tiny_models import TINY_LM

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.serve.engine import ReplicatedServer
from ddlbench_tpu_torch.tools import servechaos

from test_torch_serve import _JAX_PROV, _PORT_PROV, CPU
from test_torch_serve_prefix import port_lm  # noqa: F401
from test_torch_serve_slo import TINY, drains_clean

pytestmark = pytest.mark.torchport

# tests/test_serve_chaos.py's _run_servechaos arguments
BASE = ["-m", "transformer_t", "-b", "tinylm", "--arrival", "closed",
        "--concurrency", "4", "--requests", "10", "--max-batch", "2",
        "--pool-pages", "9", "--page", "4", "--max-len", "16",
        "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--seed", "5"]
CASES = {
    # the reference's e2e gates: a kill and a heartbeat-drained stall
    "kill_stall": ["--replicas", "3", "--kill", "6:2", "--stall",
                   "10:0:40", "--heartbeat", "4"],
    # the same faults under deadlines, retries, tiers and poisson arrivals
    "kill_stall_slo": ["--replicas", "3", "--kill", "6:2", "--stall",
                       "10:0:40", "--heartbeat", "4", "--deadline-slack",
                       "64", "--retry", "2:8", "--tier-mix", "0.3",
                       "--arrival", "poisson", "--rate", "0.5"],
    # a kill under the controller, with the scripted baseline
    "autoscale": ["--replicas", "2", "--kill", "8:1", "--autoscale", "2:2"],
    # the reference's reproducibility run, and a stall nobody detects
    "kill": ["--replicas", "2", "--kill", "8:1"],
    "stall_no_heartbeat": ["--replicas", "2", "--stall", "4:1:6",
                           "--no-control"],
}
_JAX_ROWS = {}


def jax_row(name):
    """The reference tool's row for a case, once per module."""
    if name not in _JAX_ROWS:
        import ddlbench_tpu.config as jconfig
        from ddlbench_tpu.tools import servechaos as jax_servechaos

        patched = dict(jconfig.DATASETS)
        patched["tinylm"] = TINY_LM
        buf = io.StringIO()
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                contextlib.redirect_stdout(buf):
            assert jax_servechaos.main(BASE + CASES[name]
                                       + ["--platform", "cpu"]) == 0
        _JAX_ROWS[name] = json.loads(
            [l for l in buf.getvalue().splitlines() if l.startswith("{")][0])
    return _JAX_ROWS[name]


def port_run(port_lm, name):
    args = servechaos.build_parser().parse_args(
        BASE + CASES[name] + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        return servechaos.run(args, port_lm, CPU)


def mismatches(t, j):
    keys = (set(t) - _PORT_PROV) | (set(j) - _JAX_PROV)
    return [k for k in sorted(keys)
            if t.get(k, "<missing>") != j.get(k, "<missing>")]


@pytest.mark.parametrize("name", sorted(CASES))
def test_servechaos_rows_equal_jax_rows(port_lm, name):
    rec, servers, _ = port_run(port_lm, name)
    assert mismatches(rec, jax_row(name)) == []
    assert rec["requests_lost"] == 0 and rec["platform"] == "cpu"
    assert rec["plain_launches"] == 0
    if name != "stall_no_heartbeat":
        assert rec["streams_match"] is True
        assert rec["streams_compared"] == rec["completed"] == 10
    if name.startswith("kill_stall"):
        assert rec["kills_fired"] == rec["stalls_fired"] == 1
        assert rec["heartbeat_drains"] == 1
        hb, = rec["heartbeat_events"]
        assert 4.0 < hb["stalled_for"] <= 4.0 + 8.0
        assert rec["final_replicas"] == 1
        assert len(rec["mttr_replica_s"]) == 1
    if name == "autoscale":
        assert rec["repairs"] == 1 and rec["final_replicas"] == 2
        assert rec["repair_mttr_le_scripted"] is True
        assert rec["mttr_replica_s_mean"] <= rec["mttr_scripted_s_mean"]
        assert set(servers) == {"control", "baseline", "chaos"}
    if name == "stall_no_heartbeat":
        assert rec["streams_match"] is None and rec["heartbeat_drains"] == 0
        assert set(servers) == {"chaos"}
    # every engine ends idle; the live and drained ones with every page
    # back, a killed one with its pool released
    chaos = servers["chaos"]
    killed = {ev["replica_id"] for ev in chaos.fail_events}
    for eng in chaos.engines + chaos.retired:
        assert not eng.has_work()
        if eng.replica not in killed:
            assert drains_clean(eng)
    for eng in chaos.retired:
        assert all(p is None for p in eng.pools)


def test_servechaos_is_reproducible(port_lm):
    a, _, _ = port_run(port_lm, "kill")
    b, _, _ = port_run(port_lm, "kill")
    assert a == b


def test_servechaos_main_prints_the_row(capsys):
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}):
        assert servechaos.main(BASE + CASES["kill"]
                               + ["--device", "cpu", "--wall-clock"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["tool"] == "servechaos" and rec["wall_s"] > 0
    assert rec["kills_fired"] == 1 and rec["requests_lost"] == 0


def test_servechaos_without_gpu_or_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        servechaos.main(["-m", "transformer_t", "--requests", "1"])


ERRORS = [
    ["--kill", "6"], ["--kill", "-1:0"], ["--stall", "4:0"],
    ["--stall", "4:0:0"], ["--retry", "2:4"], ["--deadline-slack", "0"],
    ["--tier-mix", "2"], ["--heartbeat", "-1"],
    ["--replicas", "1", "--kill", "4:0"],
    ["--replicas", "2", "--kill", "4:2"],
    ["--replicas", "3", "--kill", "4:0", "--kill", "5:0",
     "--kill", "6:0"],
    ["--replicas", "2", "--kill", "4:0", "--stall", "6:1:3"],
    ["--replicas", "2", "--kill", "4:2", "--autoscale", "2:2"],
    ["--replicas", "2", "--stall", "4:2:3", "--autoscale", "1:2"],
    ["--autoscale", "2:1"], ["--autoscale", "1:2", "--scale-window", "0"],
    ["--autoscale", "1:2", "--scale-cooldown", "-2"],
    ["--shared-prefix", "4"],
    # the SDC ledger's and disaggregation's flags
    ["--no-detect"], ["--scrub", "4"],
    ["--corrupt", "4:0:payload", "--scrub", "-1"],
    ["--corrupt", "4:0:payload", "--no-detect", "--scrub", "2"],
    ["--corrupt", "4:0:bogus"], ["--corrupt", "4:0:sidecar"],
    ["--corrupt", "4:0:ship"], ["--corrupt", "4:0:prefix"],
    ["--corrupt", "4:0:payload@1.0"], ["--corrupt", "4:0:payload@0.3"],
    ["--corrupt", "4:2:payload", "--replicas", "2"],
    ["--disaggregate", "0:1"],
    ["--disaggregate", "1:1", "--kill", "4:0"],
    ["--disaggregate", "1:1", "--kill", "4:p0"],
    ["--disaggregate", "1:1", "--stall", "4:0:2"],
    ["--disaggregate", "1:1", "--corrupt", "4:0:payload"],
    ["--disaggregate", "1:1", "--corrupt", "4:1:ship"],
]


@pytest.mark.parametrize("extra", ERRORS, ids=lambda e: " ".join(e))
def test_servechaos_argument_errors_are_the_references(capsys, extra):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servechaos as jax_servechaos

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    errs = []
    for main, tail in ((jax_servechaos.main, ["--platform", "cpu"]),
                       (servechaos.main, ["--device", "cpu"])):
        with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched), \
                mock.patch.dict(tconfig.DATASETS, {"tinylm": TINY}), \
                pytest.raises(SystemExit):
            main(BASE + extra + tail)
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# Planted faults.
# ---------------------------------------------------------------------------


_REAL_FAIL = ReplicatedServer.fail
_REAL_STEP = ReplicatedServer.step


def fail_drops_queue(self, replica, now=0.0, dispatch=None):
    """Planted fault: a kill whose failover resubmits the in-flight
    requests but drops the killed replica's queue."""
    queued = list(self.engines[replica].queue)
    self.engines[replica].queue.clear()
    ev = _REAL_FAIL(self, replica, now, dispatch)
    ev["displaced_queued"] = len(queued)
    return ev


def kicks_stalled(self, now=0.0):
    """Planted fault: the fleet step kicks every replica's monitor, a
    stalled one's too, so the heartbeat never drains it."""
    rep = _REAL_STEP(self, now)
    for e in self.engines:
        if e.monitor is not None:
            e.monitor.kick(now + rep.cost)
    return rep


def most_loaded(self):
    """Planted fault: dispatch to the MOST-loaded replica."""
    return max(enumerate(self.engines),
               key=lambda ie: (ie[1].load(), -ie[0]))[1]


FAULTS = {
    # (the method, its planted version, the case, the check that fails)
    "fail_drops_queue": ("fail", fail_drops_queue, "kill_stall", "lost"),
    "step_kicks_stalled": ("step", kicks_stalled, "kill_stall", "row"),
    "dispatch_most_loaded": ("_least_loaded", most_loaded, "kill", "row"),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_fleet_faults_are_rejected(port_lm, monkeypatch, name):
    attr, fault, case, check = FAULTS[name]
    monkeypatch.setattr(ReplicatedServer, attr, fault)
    rec, _, _ = port_run(port_lm, case)
    if check == "lost":
        assert rec["requests_lost"] > 0
    assert mismatches(rec, jax_row(case))
