"""The port's elastic world size: ``--elastic-slices`` (parallel/dp.py's
world-invariant reduction) and ``--elastic-resume`` (train/reshard.py),
through the real loop on the dp tests' gloo rank pool
(tests/torch_dp_ranks.py; cases in tests/torch_ckpt_ranks.py), on the
tiny LM in float32. The reference's elastic cases (tests/test_elastic.py),
each bitwise:

* the per-step losses, validation records and parameters of
  ``--elastic-slices 4`` are equal at worlds 1, 2 and 4;
* save at world 4, resume at world 2 with SGD: the resumed losses,
  validation records and materialised parameters equal the uninterrupted
  world-4 run's, and the run prints the reshard and the lr pin;
* 2 -> 4 with Adam; 4 -> 2 on the overlapped engine at three buckets;
* hybrid PP x ZeRO-1's rows saved at dp 2 and restored at dp 4 (the
  same stage split): the parameter and ``m`` rows equal.

Without ``--elastic-resume`` the mismatch raises the error naming "saved
world 4", "current world 2" and the flag, and the validate gates raise
the reference's messages. The reference's explicit dp engine cannot step
under the installed jax (ROADMAP C.1), so the trajectories are held to
the port's own uninterrupted runs, and to the reference through its
JAX-free pieces (the reshard helpers, tests/test_torch_reshard.py; the
gates here).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import numpy as np
import pytest

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from torch_dp_ranks import RankPool, build_model

import torch_ckpt_ranks as ck
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.parallel.dp import DPStrategy

pytestmark = pytest.mark.torchport

GLOBAL = 8  # the global batch: 8 // world rows a rank


def _cfg(world, **kw):
    out = ck.base(strategy="dp", dp_shard_update=True, elastic_slices=4,
                  batch_size=GLOBAL // world)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(4)
    yield pool
    pool.close()


def _same(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_elastic_slices_are_world_invariant(pool):
    """Adam (no lr world scaling): the trajectory of worlds 1, 2 and 4
    is one set of bits."""
    runs = [pool.run("torch_ckpt_ranks:elastic_world1", 4,
                     cfg=_cfg(1, optimizer="adam"))[0]]
    runs += [pool.run("torch_ckpt_ranks:elastic_trajectory", w,
                      cfg=_cfg(w, optimizer="adam"))[0] for w in (2, 4)]
    assert len(runs[0]["losses"]) == 8
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"]
        assert r["valid"] == runs[0]["valid"]
        assert _same(r["params"], runs[0]["params"])


def _roundtrip(pool, tmp_path, n, m, **kw):
    d = str(tmp_path / "ck")
    full = pool.run("torch_ckpt_ranks:elastic_save", n, cfg=_cfg(n, **kw),
                    ckpt_dir=d)[0]
    got = pool.run("torch_ckpt_ranks:elastic_resume", m, cfg=_cfg(m, **kw),
                   ckpt_dir=d)[0]
    assert "error" not in got, got.get("error")
    assert got["losses"] == full["losses"][4:]
    assert got["valid"] == full["valid"]
    assert _same(got["params"], full["params"])
    return got["text"]


def test_elastic_resume_shrink_bitwise_sgd(pool, tmp_path):
    text = _roundtrip(pool, tmp_path, 4, 2)
    assert "elastic resume: resharding checkpoint from world 4 to 2" in text
    assert "lr world-scaling pinned to the launch world (4)" in text


def test_elastic_resume_grow_bitwise_adam(pool, tmp_path):
    text = _roundtrip(pool, tmp_path, 2, 4, optimizer="adam")
    assert "resharding checkpoint from world 2 to 4" in text


def test_elastic_resume_overlapped_three_buckets_bitwise(pool, tmp_path):
    text = _roundtrip(pool, tmp_path, 4, 2, comm_buckets=3)
    assert "(buckets 3 -> 3)" in text


def test_hybrid_zero1_rows_reshard_bitwise(pool, tmp_path):
    """Rows and Adam's m saved sharded over dp 2 and restored at dp 4
    (the same two stages): equal, row for row."""
    cfg = ck.base(strategy="gpipe", dp_shard_update=True, comm_buckets=2,
                  optimizer="adam", num_microbatches=2, batch_size=None)
    d = str(tmp_path / "ck")
    saved = pool.run("torch_ckpt_ranks:hybrid_rows", 2, cfg=cfg, ckpt_dir=d,
                     resume=False)[0]
    got = pool.run("torch_ckpt_ranks:hybrid_rows", 4, cfg=cfg, ckpt_dir=d,
                   resume=True)[0]
    assert "resharding checkpoint from world 4 to 8" in got["text"]
    assert np.array_equal(got["params"], saved["params"])
    assert np.array_equal(got["m"], saved["m"])
    assert np.abs(saved["m"]).max() > 0


def test_shape_mismatch_without_the_flag_raises(pool, tmp_path):
    d = str(tmp_path / "ck")
    pool.run("torch_ckpt_ranks:elastic_save", 4, cfg=_cfg(4), ckpt_dir=d)
    got = pool.run("torch_ckpt_ranks:elastic_resume", 2, cfg=_cfg(2),
                   ckpt_dir=d, elastic=False)
    for r in got:
        msg = r["error"]
        assert msg.startswith("CheckpointShapeError")
        assert "saved world 4" in msg and "current world 2" in msg
        assert "--elastic-resume" in msg


# (RunConfig kwargs) the reference's validate refuses; each message equal
GATES = {
    "not_a_power_of_two": _cfg(4, num_devices=4, elastic_slices=6),
    "not_dp_zero1": dict(strategy="single", elastic_slices=4),
    "world_not_dividing": _cfg(8, num_devices=8, batch_size=2),
    "quantized_wire": _cfg(4, num_devices=4, allreduce_dtype="bf16"),
    "batch_not_dividing": _cfg(4, num_devices=2, batch_size=3,
                               elastic_slices=4),
    "with_accumulation": _cfg(2, num_devices=2, grad_accum_steps=2),
    "elastic_resume_without_dir": dict(elastic_resume=True),
    "keep_below_one": dict(checkpoint_dir="d", keep_checkpoints=0),
    "every_without_dir": dict(checkpoint_every_steps=2),
    "every_below_one": dict(checkpoint_dir="d", checkpoint_every_steps=0),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_validate_gates_raise_the_references_messages(name):
    kw = {k: v for k, v in GATES[name].items()
          if k not in ("log_interval", "steps_per_epoch", "seed")}
    kw.update(benchmark="synthtext", arch="transformer_t")
    with pytest.raises(ValueError) as want:
        JaxRunConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        RunConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_elastic_slices_refuse_batchnorm_models():
    cfg = RunConfig(benchmark="mnist", arch="resnet18", strategy="dp",
                    num_devices=2, dp_shard_update=True, elastic_slices=2,
                    batch_size=4)
    with pytest.raises(NotImplementedError, match="stateless"):
        DPStrategy(build_model("bn"), cfg, Comm.describe(2))
