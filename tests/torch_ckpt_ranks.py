"""Rank cases of the port's checkpoints for tests/torch_dp_ranks.RankPool
("torch_ckpt_ranks:<case>"). This module imports no JAX: the ranks run
the port only. Importing it registers the tiny token benchmark
("tinylm": T 32, vocab 64) in the port's config (torch_plan_ranks)."""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

from torch_plan_ranks import TINY  # noqa: F401  (registers "tinylm")

from ddlbench_tpu_torch.config import RunConfig

CPU = torch.device("cpu")


def base(**kw) -> dict:
    """The tiny token model's RunConfig kwargs, float32, 4 steps an
    epoch."""
    out = dict(benchmark="tinylm", arch="transformer_t",
               compute_dtype="float32", steps_per_epoch=4, log_interval=1,
               seed=3, batch_size=4)
    out.update(kw)
    return out


def run(comm, cfg: RunConfig, warmup_steps: int = 1):
    """run_benchmark of ``cfg`` on ``comm``'s ranks (None: in this
    process): (strategy, result, printed text, per-step losses)."""
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import run_benchmark

    strategy = make_strategy(cfg, CPU, comm if cfg.spawned_ranks() else None)
    losses = []
    step = strategy.train_step

    def recording(x, y, lr):
        m = step(x, y, lr)
        losses.append(float(m["loss"]))
        return m

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        strategy.train_step = recording
        result = run_benchmark(cfg, strategy, warmup_steps=warmup_steps)
    return strategy, result, out.getvalue(), losses[warmup_steps:]


def leaves(strategy) -> list:
    """The strategy's checkpoint tree's leaves as numpy (a collective)."""
    from ddlbench_tpu_torch.parallel.state import tree_leaves

    return [t.numpy().copy() for t in tree_leaves(
        strategy.checkpoint_state())]


def same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


def resume(comm, cfg: dict, ckpt_dir: str, every=None) -> dict:
    """Two uninterrupted epochs; one epoch saved (a step checkpoint every
    ``every`` steps), then resumed for the second. Returns the
    comparisons (bitwise) and the resumed run's text."""
    ranks = comm if comm is not None and comm.world > 1 else None
    full_s, full_r, _, full_l = run(ranks, RunConfig(epochs=2, **cfg))
    want = leaves(full_s)
    d = os.path.join(ckpt_dir, "run")
    run(ranks, RunConfig(epochs=1, checkpoint_dir=d,
                         checkpoint_every_steps=every, **cfg))
    got_s, got_r, text, got_l = run(ranks, RunConfig(
        epochs=2, checkpoint_dir=d, resume=True, **cfg))
    steps = cfg["steps_per_epoch"]
    return {"params": same(leaves(got_s), want),
            "losses": got_l == full_l[steps:],
            "valid": got_r["valid_history"] == full_r["valid_history"],
            "text": text}


def mid_epoch(comm, cfg: dict, ckpt_dir: str) -> dict:
    """One epoch with a step checkpoint after step 1, its epoch
    checkpoint removed, resumed: the rest equals the uninterrupted run."""
    import shutil

    ranks = comm if comm is not None and comm.world > 1 else None
    full_s, full_r, _, full_l = run(ranks, RunConfig(epochs=2, **cfg))
    want = leaves(full_s)
    d = os.path.join(ckpt_dir, "mid")
    run(ranks, RunConfig(epochs=1, checkpoint_dir=d,
                         checkpoint_every_steps=2, **cfg))
    if comm is None or comm.rank == 0:
        shutil.rmtree(os.path.join(d, "epoch_1"))
    if ranks is not None:
        ranks.barrier()
    got_s, got_r, text, got_l = run(ranks, RunConfig(
        epochs=2, checkpoint_dir=d, resume=True, **cfg))
    return {"params": same(leaves(got_s), want),
            "losses": got_l == full_l[2:],
            "valid": got_r["valid_history"] == full_r["valid_history"],
            "text": text}


def elastic_trajectory(comm, cfg: dict) -> dict:
    """The per-step losses, validation records and final parameters of
    two epochs at this world (the elastic engine's world invariance)."""
    s, r, _, losses = run(comm, RunConfig(epochs=2, num_devices=comm.world,
                                          **cfg), warmup_steps=0)
    return {"losses": losses, "valid": r["valid_history"],
            "params": [p.detach().numpy().copy()
                       for p in s.materialize_params().parameters()]}


def elastic_save(comm, cfg: dict, ckpt_dir: str) -> dict:
    """One epoch at this world, checkpointed, and the uninterrupted two
    epochs' trajectory beside it."""
    full = elastic_trajectory(comm, cfg)
    run(comm, RunConfig(epochs=1, num_devices=comm.world,
                        checkpoint_dir=ckpt_dir, **cfg), warmup_steps=0)
    return full


def elastic_resume(comm, cfg: dict, ckpt_dir: str, elastic: bool = True
                   ) -> dict:
    """The second epoch resumed at this world from ``ckpt_dir`` (saved at
    another): its losses, validation records, final parameters and
    text; or the error's text where the resume raises."""
    try:
        s, r, text, losses = run(comm, RunConfig(
            epochs=2, num_devices=comm.world, checkpoint_dir=ckpt_dir,
            resume=True, elastic_resume=elastic, **cfg), warmup_steps=0)
    except Exception as e:  # the named error, sent back to the test
        return {"error": f"{type(e).__name__}: {e}"}
    return {"losses": losses, "valid": r["valid_history"], "text": text,
            "params": [p.detach().numpy().copy()
                       for p in s.materialize_params().parameters()]}


def logical(comm, cfg: dict) -> dict:
    """The logical metadata (train/reshard.logical_meta) of the strategy
    ``cfg`` builds on these ranks, at lr world 2."""
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.reshard import logical_meta

    rc = RunConfig(**cfg)
    s = make_strategy(rc, CPU, comm if rc.spawned_ranks() else None)
    return logical_meta(s, rc, s.checkpoint_state(), 2)


def elastic_world1(comm, cfg: dict) -> dict:
    """:func:`elastic_trajectory` at world 1, on a group of rank 0 alone
    (every rank of ``comm`` makes the group; the others return None)."""
    from ddlbench_tpu_torch import distributed

    one = distributed.subgroup(comm, [0])
    return None if one is None else elastic_trajectory(one, cfg)


def hybrid_rows(comm, cfg: dict, ckpt_dir: str, resume: bool) -> dict:
    """Hybrid PP x ZeRO-1 at dp = this world: one epoch saved under
    ``ckpt_dir``, or (``resume``) the checkpoint restored there through
    the loop's elastic resume, no step taken. Returns the strategy's
    plain parameter rows and its ``m`` rows, whatever its dp."""
    from ddlbench_tpu_torch.convert import zero1_plain_rows

    rc = RunConfig(epochs=1, checkpoint_dir=ckpt_dir, resume=resume,
                   elastic_resume=resume, dp_replicas=comm.world,
                   num_devices=2 * comm.world,
                   micro_batch_size=4 // comm.world, **cfg)
    s, _, text, _ = run(comm, rc, warmup_steps=0)
    m = s.checkpoint_state()["opt"]["m"]
    meta = s.ref_row_meta()
    return {"params": s.materialize_params().numpy(),
            "m": zero1_plain_rows(m.numpy(), meta.length, s.dp,
                                  meta.num_buckets),
            "text": text}
