"""Rank workers for the port's data-parallel tests. This module imports no
JAX: the ranks are spawned processes that import it and the port only.

:class:`RankPool` starts ``world`` gloo ranks on the CPU once, each with
one thread, joined through a rendezvous file (distributed.init_rank);
every rank also joins a subgroup of ranks 0-1, so one pool runs cases at
world 2 and at its full world. A case is the name of a function here and
its keyword arguments (numpy arrays, plain values); the ranks of the
case's world run it and send back what it returns. A case named
"module:function" is that function of another JAX-free test module
(tests/torch_shard_ranks.py holds the sharded strategies' cases).
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

CASE_TIMEOUT_S = 240.0


class RankPool:
    """``world`` CPU ranks serving cases until :meth:`close`."""

    def __init__(self, world: int = 4):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = world
        self._tmp = tempfile.TemporaryDirectory(prefix="ddlb_dp_test_")
        init_file = os.path.join(self._tmp.name, "rdv")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, args=(
            r, world, init_file, self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, case: str, world: int, **kw) -> List[Any]:
        """Run ``case(comm, **kw)`` on ranks 0..world-1 (world 2 or the
        pool's); returns their results in rank order."""
        if world not in (2, self.world):
            raise ValueError(f"a pool of {self.world} runs worlds 2 and "
                             f"{self.world}, not {world}")
        for r in range(world):
            self._tasks[r].put((case, world, kw))
        got, errors, waited = {}, [], 0.0
        while len(got) < world:
            try:
                rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r in range(world)
                        if not self._procs[r].is_alive()]
                if dead or waited > CASE_TIMEOUT_S:
                    raise TimeoutError(
                        f"{case}: {len(got)} of {world} ranks answered in "
                        f"{waited:.0f} s (ranks {dead} have exited)"
                        + "".join(errors)) from None
                continue
            got[rank] = out
            if not ok:
                errors.append(f"\n--- rank {rank} ---\n{out}")
        if errors:
            raise RuntimeError(f"{case} failed:" + "".join(errors))
        return [got[r] for r in range(world)]

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()


def _serve(rank, world, init_file, tasks, results):
    torch.set_num_threads(1)
    from ddlbench_tpu_torch import distributed

    comm = distributed.init_rank(rank, world, init_file, "cpu")
    comms = {world: comm, 2: distributed.subgroup(comm, [0, 1])}
    assert "jax" not in sys.modules, "a dp rank imported jax"
    while True:
        task = tasks.get()
        if task is None:
            break
        case, w, kw = task
        try:
            if ":" in case:
                import importlib

                mod, name = case.split(":")
                fn = getattr(importlib.import_module(mod), name)
            else:
                fn = globals()[case]
            results.put((rank, True, fn(comms[w], **kw)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


# ---- the port's counterparts of the tests' tiny models ---------------------


def build_model(name: str, num_classes: int = 4):
    """The port's twin of a test model of the reference (tests/
    tiny_models.py, tests/test_dp_shard.py): "dense", "bn",
    "transformer_t" (T 32, vocab 64)."""
    from ddlbench_tpu_torch.models import layers as L
    from ddlbench_tpu_torch.models.transformer import build_transformer

    gen = torch.Generator().manual_seed(0)
    if name == "dense":
        return L.LayerModel("tinydense", [
            L.Flatten("flatten", (4, 4, 1)),
            L.Dense("fc1", (16,), 9, relu=True, gen=gen),
            L.Dense("fc2", (9,), 8, relu=True, gen=gen),
            L.Dense("fc3", (8,), num_classes, gen=gen)], (4, 4, 1),
            num_classes)
    if name == "bn":
        return L.LayerModel("tinybn", [
            L.ConvBN("c1", (4, 4, 1), 4, gen=gen),
            L.GlobalAvgPool("gap", (4, 4, 4)),
            L.Flatten("flatten", (4,)),
            L.Dense("fc", (4,), num_classes, gen=gen)], (4, 4, 1),
            num_classes)
    if name == "transformer_t":
        return build_transformer("transformer_t", (32,), 64)
    raise ValueError(name)


def _port_batch(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def named(model) -> Dict[str, np.ndarray]:
    """``model``'s parameters as numpy, by "<layer>.<name>"."""
    return {f"{i}.{n}": p.detach().numpy().copy()
            for i, layer in enumerate(model.layers)
            for n, p in layer.named_parameters()}


def buffers(model) -> Dict[str, np.ndarray]:
    return {f"{i}.{n}": b.detach().numpy().copy()
            for i, layer in enumerate(model.layers)
            for n, b in layer.named_buffers()}


# ---- cases -----------------------------------------------------------------


def _strategy(comm, model: str, cfg: dict, params=None, states=None):
    """DPStrategy on the port's ``model`` (the reference's weights
    ``params`` and ``states`` where given), initialised."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
    from ddlbench_tpu_torch.parallel.dp import DPStrategy

    net = build_model(model)
    if params is not None:
        from_jax_params(net, params)
    if states is not None:
        from_jax_state(net, states)
    strat = DPStrategy(net, RunConfig(num_devices=comm.world, **cfg), comm)
    strat.init()
    return strat


def train(comm, model: str, cfg: dict, batches: list, lr: float,
          params=None, states=None) -> dict:
    """DPStrategy over the global ``batches`` at ``lr``: the per-step
    losses and accuracies, the final parameters and buffers, the
    optimizer-state bytes, the int8 step counter and the collectives'
    record."""
    strat = _strategy(comm, model, cfg, params, states)
    losses, accs = [], []
    for x, y in batches:
        m = strat.train_step(_port_batch(x), torch.from_numpy(np.array(y)),
                             lr)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    net = strat.materialize_params()
    return {"losses": losses, "accuracy": accs, "params": named(net),
            "buffers": buffers(net), "opt_bytes": strat.opt_state_bytes(),
            "padded": strat.meta.padded, "qstep": strat.opt.get("qstep"),
            "staged": strat.comm.record()}


def grads(comm, model: str, cfg: dict, batch: tuple, params=None,
          states=None) -> dict:
    """One step's global loss and reduced gradient, by parameter name,
    without the update (the replicated engine)."""
    from ddlbench_tpu_torch.parallel.common import unpack_flat

    strat = _strategy(comm, model, cfg, params, states)
    m, gred = strat.reduced_grads(_port_batch(batch[0]),
                                  torch.from_numpy(np.array(batch[1])))
    by_param = {id(p): g for p, g in zip(strat.params,
                                         unpack_flat(gred, strat.meta))}
    return {"loss": float(m["loss"]),
            "grads": {f"{i}.{n}": by_param[id(p)].numpy().copy()
                      for i, layer in enumerate(strat.model.layers)
                      for n, p in layer.named_parameters()}}


def evaluate(comm, model: str, cfg: dict, batch: tuple, params=None,
             states=None) -> dict:
    """DPStrategy.eval_step on the global ``batch``."""
    strat = _strategy(comm, model, cfg, params, states)
    m = strat.eval_step(_port_batch(batch[0]),
                        torch.from_numpy(np.array(batch[1])))
    return {k: float(v) for k, v in m.items()}


def loop_lrs(comm, cfg: dict) -> list:
    """The learning rate of every train step of the port's run_benchmark
    (warm-up step included) for ``cfg``."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import run_benchmark

    rc = RunConfig(num_devices=comm.world, **cfg)
    strat = make_strategy(rc, comm.device, comm)
    step, lrs = strat.train_step, []

    def recording(x, y, lr):
        lrs.append(lr)
        return step(x, y, lr)

    strat.train_step = recording
    run_benchmark(rc, strat, warmup_steps=1)
    return lrs


def threads(comm) -> int:
    """The rank's torch intra-op thread count (each rank starts at one)."""
    return torch.get_num_threads()
