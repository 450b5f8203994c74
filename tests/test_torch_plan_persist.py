"""The persisted plan (``partition.json`` beside the checkpoints) of the
port's ``--auto-partition`` (parallel/api.py) and ``--plan auto``
(partition/planner.py), held to the reference's.

* The reference's tests/test_resume.py cases on the port: the plan
  persists and a ``--resume`` reuses it without profiling (the branchy
  packed-chain path, nasnet_t); a stale or a truncated plan is ignored;
  a plan of other flags is not clobbered and its key counts the batch
  flags; a plan missing a field falls back to profiling; a fresh run
  backs up another configuration's plan and a same-key rerun does not.
* For one configuration, the port's partition.json equals the
  reference's field by field (the test gives both the reference's
  hardware constants).
* ``--plan auto`` persists its record and a resume reuses it; the
  elastic pin (``_elastic_pin``) gives the reference's answer for the
  same checkpoint's logical.json and partition.json.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import dataclasses
import json
import os

import pytest
import torch

from ddlbench_tpu.config import HardwareModel as JaxHW
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.parallel.api import make_strategy as jax_make_strategy
from ddlbench_tpu.partition import planner as jplan

from ddlbench_tpu_torch.config import HardwareModel, RunConfig
from ddlbench_tpu_torch.parallel.api import auto_partition, make_strategy
from ddlbench_tpu_torch.partition import planner as tplan
from ddlbench_tpu_torch.train import checkpoint as tck

pytestmark = pytest.mark.torchport

CPU = torch.device("cpu")


def _base(tmp_path, **kw):
    out = dict(benchmark="cifar10", strategy="gpipe", arch="nasnet_t",
               num_devices=2, auto_partition=True, micro_batch_size=4,
               num_microbatches=2, compute_dtype="float32",
               profile_mode="flops", checkpoint_dir=str(tmp_path))
    out.update(kw)
    return out


def _build(**kw):
    """The --auto-partition plan (what the CLI solves before it spawns
    the plan's ranks)."""
    return auto_partition(RunConfig(**kw), CPU)


def test_auto_partition_plan_persists_across_resume(tmp_path, capsys):
    base = _base(tmp_path)
    p1 = _build(**base)
    assert (tmp_path / "partition.json").exists()
    capsys.readouterr()
    p2 = _build(**base, resume=True)
    out = capsys.readouterr().out
    assert "reusing persisted plan" in out
    assert "executing plan" not in out  # no re-partition
    assert p2.graph is None  # nothing profiled
    assert (p1.bounds, p1.cuts) == (p2.bounds, p2.cuts)
    assert p1.cfg == p2.cfg.replace(resume=False)
    s1 = make_strategy(p1.cfg, CPU, partition=p1)
    s2 = make_strategy(p2.cfg, CPU, partition=p2)
    a, b = s1.checkpoint_state(), s2.checkpoint_state()
    assert a["params"].shape == b["params"].shape


def test_stale_or_corrupt_plan_is_ignored(tmp_path, capsys):
    base = _base(tmp_path)
    _build(**base)
    plan_file = tmp_path / "partition.json"
    plan = json.loads(plan_file.read_text())
    plan["key"]["num_devices"] = 4
    plan_file.write_text(json.dumps(plan))
    capsys.readouterr()
    _build(**base, resume=True)
    out = capsys.readouterr().out
    assert "re-profiling" in out and "reusing persisted plan" not in out
    plan_file.write_text("{\"graph_bounds\": [0, 4")
    capsys.readouterr()
    _build(**base, resume=True)
    assert "ignoring unreadable plan" in capsys.readouterr().out


def test_mismatched_plan_is_not_clobbered_and_flags_key(tmp_path, capsys):
    base = _base(tmp_path)
    _build(**base)
    plan_file = tmp_path / "partition.json"
    original = plan_file.read_text()
    capsys.readouterr()
    _build(**dict(base, micro_batch_size=8), resume=True)
    out = capsys.readouterr().out
    assert "re-profiling" in out and "existing plan file is kept" in out
    assert plan_file.read_text() == original
    plan = json.loads(original)
    del plan["graph_bounds"]
    plan_file.write_text(json.dumps(plan))
    capsys.readouterr()
    _build(**base, resume=True)
    assert "not applicable" in capsys.readouterr().out


def test_fresh_run_backs_up_mismatched_plan(tmp_path, capsys):
    base = _base(tmp_path)
    _build(**base)
    plan_file = tmp_path / "partition.json"
    original = plan_file.read_text()
    capsys.readouterr()
    _build(**dict(base, micro_batch_size=8))
    assert "backed up to" in capsys.readouterr().out
    bak = tmp_path / "partition.json.bak"
    assert bak.read_text() == original
    assert json.loads(plan_file.read_text())["key"]["micro_batch_size"] == 8
    bak.unlink()
    capsys.readouterr()
    _build(**dict(base, micro_batch_size=8))
    assert "backed up to" not in capsys.readouterr().out
    assert not bak.exists()


def test_partition_json_equals_the_references(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jh = JaxHW()
    jax_make_strategy(JaxRunConfig(**_base(jdir)))
    _build(**_base(tdir),
           hardware=HardwareModel(**dataclasses.asdict(jh)))
    want = json.loads((jdir / "partition.json").read_text())
    got = json.loads((tdir / "partition.json").read_text())
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def _plan_auto_cfg(tmp_path, **kw):
    out = dict(benchmark="cifar10", arch="resnet18", strategy="gpipe",
               num_devices=2, plan="auto", micro_batch_size=4,
               num_microbatches=2, compute_dtype="float32",
               profile_mode="flops", checkpoint_dir=str(tmp_path))
    out.update(kw)
    return out


def test_plan_auto_record_persists_and_is_reused(tmp_path, capsys):
    cfg = RunConfig(**_plan_auto_cfg(tmp_path))
    first = tplan.resolve_auto_plan(cfg)
    doc = json.loads((tmp_path / "partition.json").read_text())
    assert doc["key"]["plan"] == "auto" and "rewrite" in doc["plan_auto"]
    capsys.readouterr()
    again = tplan.resolve_auto_plan(cfg.replace(resume=True))
    out = capsys.readouterr().out
    assert "plan auto: reusing persisted plan" in out
    assert "plan auto: executing" not in out
    assert again == first.replace(resume=True)


def _elastic_dir(root, kind, recorded):
    """A committed checkpoint whose logical.json has ``kind`` (saved at
    world 4) and, with ``recorded``, a partition.json whose --plan auto
    winner has two stages cut at (0, 3, 6)."""
    logical = {"schema": 1, "strategy": "gpipe", "kind": kind, "world": 4}
    if kind == "pipe_shard":
        logical.update(stages=2, vstages=1, dp=2)
    tck.save_checkpoint(str(root), 1, {"params": []}, logical=logical)
    if recorded:
        (root / "partition.json").write_text(json.dumps({
            "key": {}, "plan_auto": {"winner": {"pp": 2,
                                                "bounds": [0, 3, 6]}}}))


@pytest.mark.parametrize("kind,recorded", [("pipe_shard", True),
                                           ("pipe_shard", False),
                                           ("dp_shard", False),
                                           ("replicated", False),
                                           (None, False)])
@pytest.mark.parametrize("flags", [dict(resume=True, elastic_resume=True),
                                   dict(resume=True)])
def test_elastic_pin_answers_as_the_reference(tmp_path, kind, recorded,
                                              flags, capsys):
    if kind is not None:
        _elastic_dir(tmp_path, kind, recorded)
    kw = _plan_auto_cfg(tmp_path, num_devices=8, **flags)
    got = tplan._elastic_pin(RunConfig(**kw))
    want = jplan._elastic_pin(JaxRunConfig(**kw))
    assert got == want
    if kind == "pipe_shard" and "elastic_resume" in flags:
        assert got[0] == 2 and got[2] is True
        assert (got[1] == (0, 3, 6)) == recorded
    assert os.path.isdir(tmp_path)
