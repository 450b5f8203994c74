"""Process groups for the port's data-parallel training (the counterpart of
``ddlbench_tpu/distributed.py``'s multi-process pieces).

The reference runs one process per host over a JAX mesh; the port runs one
process per rank over ``torch.distributed``, the reference's own
mechanism (Horovod: one process per GPU). :func:`spawn` starts the ranks
with ``torch.multiprocessing``'s spawn start method and a rendezvous file
(``init_method="file://..."``) in a fresh temporary directory, so two runs
on one machine never share a port or a file. Each rank gets a :class:`Comm`:
its group, rank, world and device, and the collectives the dp strategy
calls (parallel/dp.py).

Backends and devices:

* ``cpu``: gloo, every rank on the CPU (the tests);
* ``cuda``: NCCL, rank r on ``cuda:r`` (a hybrid pipeline's replica on
  the first of its stages' cards, ``cuda:(r * S)``:
  :func:`hybrid_stage_devices`; a 3-D tpp rank on its first stage's
  card, :func:`tpp3d_stage_devices`); a world larger than the machine's
  card count is an error naming the count, never a silent fall back to
  gloo or the CPU;
* ``cuda`` with ``shared_card=True``: gloo, every rank on ``cuda:0``. NCCL
  refuses two ranks on one card, so this is how one card runs a world of
  2 (chip_smoke.py). It exists only for a caller that asks for it; the CLI
  does not offer it. gloo takes CUDA tensors directly for all_reduce and
  broadcast (:data:`GLOO_CUDA_DIRECT`); reduce-scatter, all-gather and
  all_to_all are always staged through pinned host memory, by the table,
  never on an exception. Its wire is the host's, so it says nothing of
  NCCL's speed.

The sharded strategies' collectives inside the model have autograd
wrappers here: :func:`all_gather_grad` (fsdp's gather of a layer's
shard and sequence parallelism's gather of the K/V blocks: the backward
reduce-scatters the gradient) and :func:`all_to_all_experts` (expert
parallelism's token exchange: the backward is the inverse exchange).
Collectives are not autograd-aware on their own, so every rank must
reach the same wrappers in the same order, forward and backward: each
is one node that every rank's graph holds, whatever the rank computes
with its output. :class:`AxisContext` is the model's switch into a
sharded mode (models/transformer.sequence_parallel and
tensor_parallel, models/moe.expert_parallel and global_routing). 3-D
tpp's ranks hold two sub-Comms each (:func:`tpp3d_comms`, over
:func:`subgroup`): the tensor-parallel group of their replica and the
data group of their shard index. Tensor parallelism's two
are Megatron's: :func:`sum_forward` (the sum over the ranks forward, the
identity backward: after a row-parallel projection) and
:func:`sum_backward` (the identity forward, the sum backward: where a
replicated activation enters a column-parallel one).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors itself (PyTorch's backend
# table); the others are staged through pinned host memory
GLOO_CUDA_DIRECT = ("all_reduce", "broadcast")
COLLECTIVES = ("all_reduce", "broadcast", "reduce_scatter", "all_gather",
               "all_to_all")
TIMEOUT_S = 300.0  # a collective's wait before gloo or NCCL gives up

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous rows of a global batch of
    ``global_batch`` rows (the reference's ``local_batch_slice``)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"over {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def rank_device(device: str, rank: int, world: int,
                shared_card: bool = False, stride: int = 1,
                tp: int = 1) -> torch.device:
    """The device of rank ``rank``: the CPU, ``cuda:(rank * stride)``, or
    ``cuda:0`` for every rank of a shared card. ``stride`` is the cards a
    rank holds (a hybrid pipeline's replica holds its S stages' cards,
    :func:`hybrid_stage_devices`; its group is bound to the first). With
    ``tp`` > 1 the ranks come in tensor-parallel groups of ``tp`` whose
    ranks' stages interleave (tpp, :func:`tp_stage_devices`, and 3-D tpp,
    :func:`tpp3d_stage_devices`): rank ``d * tp + t`` on ``cuda:(d *
    stride * tp + t)``. Raises where the machine lacks the cards (module
    docstring)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if shared_card:
            raise ValueError("shared_card is a mode of the card (cuda)")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shared_card and have:
        return torch.device("cuda", 0)
    if have < world * stride or not have:
        need = 1 if shared_card else world * stride
        raise RuntimeError(
            f"-g {world * stride} needs {need} CUDA device(s) ("
            + ("gloo, every rank on one card" if shared_card
               else "NCCL, one rank a card" if stride == 1
               else f"NCCL, one rank {stride} cards")
            + f"); this machine has {have} (--device cpu runs the ranks "
            "on the CPU)")
    return torch.device("cuda", (rank // tp) * stride * tp + rank % tp)


def stage_devices(device: str, num_stages: int,
                  shared_card: bool = False) -> List[torch.device]:
    """The devices of a pipeline's ``num_stages`` stages, stage s on
    entry s: ``cuda`` gives ``cuda:0`` .. ``cuda:S-1`` and raises, naming
    the count, where the machine has fewer cards; ``shared_card=True``
    puts every stage on ``cuda:0`` (asked for explicitly, never a fall
    back); ``cpu`` gives the CPU for every stage."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if shared_card:
            raise ValueError("shared_card is a mode of the card (cuda)")
        return [dev] * num_stages
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shared_card and have:
        return [torch.device("cuda", 0)] * num_stages
    if have < num_stages or not have:
        need = 1 if shared_card else num_stages
        raise RuntimeError(
            f"{num_stages} pipeline stages need {need} CUDA device(s) ("
            + ("every stage on one card" if shared_card
               else "one stage a card")
            + f"); this machine has {have} (--device cpu runs the stages "
            "on the CPU)")
    return [torch.device("cuda", s) for s in range(num_stages)]


def tp_stage_devices(device: str, num_stages: int, tp: int, rank: int,
                     shared_card: bool = False) -> List[torch.device]:
    """The stage devices of tensor-parallel rank ``rank`` of ``tp`` in a
    pipeline of ``num_stages`` stages (tpp): stage s on ``cuda:(s * tp +
    rank)``, a stage's shards on adjacent cards as the reference's mesh
    lays its 'model' axis innermost; raises, naming the count, where the
    machine has fewer than ``num_stages * tp`` cards. ``shared_card=True``
    puts every stage of every rank on ``cuda:0``; ``cpu`` gives the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu" or shared_card:
        return stage_devices(device, num_stages, shared_card)
    need = num_stages * tp
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"{num_stages} pipeline stages x tp {tp} need {need} CUDA "
            f"device(s) (one shard of a stage a card); this machine has "
            f"{have} (--device cpu runs them on the CPU)")
    return [torch.device("cuda", s * tp + rank) for s in range(num_stages)]


def hybrid_stage_devices(device: str, num_stages: int, replicas: int,
                         rank: int, shared_card: bool = False
                         ) -> List[torch.device]:
    """The stage devices of replica ``rank`` of ``replicas`` in a hybrid
    pipeline of ``num_stages`` stages (hybrid PP x DP): stage s on
    ``cuda:(rank * num_stages + s)``, the reference's ``('data',
    'stage')`` mesh with the data axis outer; raises, naming the count,
    where the machine has fewer than ``replicas * num_stages`` cards.
    ``shared_card=True`` puts every stage of every replica on ``cuda:0``;
    ``cpu`` gives the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu" or shared_card:
        return stage_devices(device, num_stages, shared_card)
    need = num_stages * replicas
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"{num_stages} pipeline stages x {replicas} replicas need "
            f"{need} CUDA device(s) (one stage of a replica a card); this "
            f"machine has {have} (--device cpu runs them on the CPU)")
    return [torch.device("cuda", rank * num_stages + s)
            for s in range(num_stages)]


def tpp3d_stage_devices(device: str, num_stages: int, tp: int,
                        replicas: int, rank: int, shared_card: bool = False
                        ) -> List[torch.device]:
    """The stage devices of rank ``rank`` = ``d * tp + t`` (replica d of
    ``replicas``, shard t of ``tp``) in 3-D tpp over ``num_stages``
    stages: stage s on ``cuda:(d * num_stages * tp + s * tp + t)``, the
    reference's ``('data', 'stage', 'model')`` mesh with the data axis
    outer and the model axis inner; raises, naming the count, where the
    machine has fewer than ``replicas * num_stages * tp`` cards.
    ``shared_card=True`` puts every stage of every rank on ``cuda:0``;
    ``cpu`` gives the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu" or shared_card:
        return stage_devices(device, num_stages, shared_card)
    need = replicas * num_stages * tp
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"{replicas} replicas x {num_stages} pipeline stages x tp {tp} "
            f"need {need} CUDA device(s) (one shard of a stage of a replica "
            f"a card); this machine has {have} (--device cpu runs them on "
            "the CPU)")
    d, t = divmod(rank, tp)
    return [torch.device("cuda", d * num_stages * tp + s * tp + t)
            for s in range(num_stages)]


def check_world(device: str, world: int, shared_card: bool = False,
                stride: int = 1, tp: int = 1) -> None:
    """Raise before any process starts where ``world`` ranks of
    ``stride`` cards each cannot run on ``device``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    rank_device(device, world - 1, world, shared_card, stride, tp)


def _reduce_scatter(out, inp, op, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, op=op, group=group)


def _all_gather(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


@dataclasses.dataclass
class Comm:
    """One rank's view of its group: ``rank`` of ``world`` on ``device``,
    and the collectives of the dp strategy. ``staged`` names the
    collectives this rank copies through pinned host memory (a shared
    card's gloo: module docstring). A Comm with no ``group`` describes a
    world without running one (comm_stats, layouts); its collectives
    raise."""

    group: Optional[Any]
    rank: int
    world: int
    device: torch.device
    backend: str
    staged: frozenset = frozenset()

    @classmethod
    def describe(cls, world: int, rank: int = 0,
                 device: str = "cpu") -> "Comm":
        return cls(None, rank, world, torch.device(device), "none")

    def record(self) -> dict:
        """Which collectives took the device's tensors directly and which
        were staged through host memory."""
        direct = [c for c in COLLECTIVES if c not in self.staged]
        return {"backend": self.backend, "world": self.world,
                "device": str(self.device), "direct": direct,
                "host_staged": sorted(self.staged)}

    def _run(self, name: str, fn: Callable, *tensors: torch.Tensor):
        """Run ``fn`` on ``tensors`` (the last one receives the result),
        through pinned host copies where ``name`` is staged, and through
        the rank's own card where NCCL gets tensors of another (a later
        pipeline stage's under tpp: NCCL runs on the card its group was
        bound to)."""
        if self.group is None:
            raise RuntimeError(f"{name}: this Comm describes a world of "
                               f"{self.world} and runs no collective")
        if self.backend == "nccl" and tensors[0].device != self.device:
            moved = [t.to(self.device) for t in tensors]
            fn(*moved)
            tensors[-1].copy_(moved[-1])
            return tensors[-1]
        if name not in self.staged or tensors[0].device.type != "cuda":
            fn(*tensors)
            return tensors[-1]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t)
        fn(*host)
        tensors[-1].copy_(host[-1])
        return tensors[-1]

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place: the sum (or max) of ``t`` over the ranks."""
        return self._run("all_reduce", lambda x: dist.all_reduce(
            x, op=_OPS[op], group=self.group), t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: rank ``src``'s ``t`` on every rank."""
        return self._run("broadcast", lambda x: dist.broadcast(
            x, dist.get_global_rank(self.group, src), group=self.group), t)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's 1/world contiguous slice of the sum of the flat
        ``t`` over the ranks."""
        out = torch.empty(t.numel() // self.world, dtype=t.dtype,
                          device=t.device)
        return self._run("reduce_scatter", lambda x, o: _reduce_scatter(
            o, x, dist.ReduceOp.SUM, self.group), t.reshape(-1), out)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' flat ``t`` concatenated in rank order."""
        out = torch.empty(t.numel() * self.world, dtype=t.dtype,
                          device=t.device)
        return self._run("all_gather", lambda x, o: _all_gather(
            o, x, self.group), t.reshape(-1), out)

    def exchange(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        """``t`` sent to rank ``peer`` of the group and that rank's ``t``
        received (one send and one receive, posted together), through
        pinned host copies where the collectives are staged."""
        if self.group is None:
            raise RuntimeError(f"exchange: this Comm describes a world of "
                               f"{self.world} and runs no collective")
        t = t.contiguous()
        src = t
        if self.staged and t.device.type == "cuda":
            src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            src.copy_(t)
        elif self.backend == "nccl" and t.device != self.device:
            src = t.to(self.device)
        buf = torch.empty_like(src)
        g = dist.get_global_rank(self.group, peer)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, g, self.group),
                dist.P2POp(dist.irecv, buf, g, self.group)]):
            req.wait()
        return buf.to(t.device)

    def barrier(self) -> None:
        """Every rank of the group here before any leaves (a one-element
        all-reduce, on the backend and card the group runs on)."""
        if self.group is not None and self.world > 1:
            self.all_reduce(torch.zeros(1, device=self.device))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s dim 0 in world equal blocks, block j sent to rank j;
        block i of the result came from rank i."""
        if self.world == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        return self._run("all_to_all", lambda x, o: dist.all_to_all_single(
            o, x, group=self.group), t, out)


def subgroup(comm: Comm, ranks: Sequence[int]) -> Optional[Comm]:
    """A Comm over ``ranks`` of ``comm``'s group, on the rank's device and
    backend; None on a rank outside it. Every rank of ``comm``'s group
    calls this for every subgroup, in the same order (``new_group``
    requires it)."""
    ranks = list(ranks)
    group = dist.new_group(ranks)
    if comm.rank not in ranks:
        return None
    return dataclasses.replace(comm, group=group,
                               rank=ranks.index(comm.rank),
                               world=len(ranks))


def tpp3d_comms(comm: Comm, replicas: int, tp: int):
    """3-D tpp's two groups of rank ``comm.rank`` = ``d * tp + t`` of a
    world of ``replicas * tp``: (its tensor-parallel group, the ``tp``
    shards of replica d; its data group, shard t of every replica). Every
    rank makes every group, the tp groups first, in one order."""
    if comm.world != replicas * tp:
        raise ValueError(f"a world of {comm.world} ranks for {replicas} "
                         f"replicas x tp {tp}")
    tp_comm = dp_comm = None
    for d in range(replicas):
        got = subgroup(comm, [d * tp + t for t in range(tp)])
        tp_comm = got or tp_comm
    for t in range(tp):
        got = subgroup(comm, [d * tp + t for d in range(replicas)])
        dp_comm = got or dp_comm
    return tp_comm, dp_comm


def butterfly_sum(t: torch.Tensor, comm: "Comm") -> torch.Tensor:
    """The sum of ``t`` over the ranks by recursive doubling: log2(world)
    rounds, in round r each rank adds its partner's (rank XOR r) partial
    to its own, the add on the rank's own device. IEEE addition is
    commutative, so every rank lands on the same bits, and the sum is the
    balanced binary tree over the ranks in rank order whatever the
    backend's own reduction order (dp's ``elastic_slices``). The world
    must be a power of two."""
    n = comm.world
    if n & (n - 1):
        raise ValueError(f"butterfly_sum needs a power-of-two world, got {n}")
    r = 1
    while r < n:
        t = t + comm.exchange(t, comm.rank ^ r)
        r <<= 1
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, on_backward, replicated):
        ctx.comm, ctx.on_backward, ctx.shape = comm, on_backward, t.shape
        ctx.replicated = replicated
        return comm.all_gather(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.on_backward is not None:
            ctx.on_backward()
        if ctx.replicated:
            n, r = ctx.comm.world, ctx.comm.rank
            shard = g.reshape(n, -1)[r]
        else:
            shard = ctx.comm.reduce_scatter(g.contiguous())
        return shard.view(ctx.shape), None, None, None


def all_gather_grad(t: torch.Tensor, comm: "Comm",
                    on_backward: Optional[Callable] = None,
                    replicated: bool = False) -> torch.Tensor:
    """:meth:`Comm.all_gather` (the ranks' flat ``t`` in rank order),
    differentiable: the backward reduce-scatters the gradient, so each
    rank gets the sum over the ranks of its own ``t``'s part, then calls
    ``on_backward`` (fsdp drops a layer's re-gathered weights there).
    ``replicated``: every rank computed the same gradient (the batch is
    replicated: the tp strategy), so the backward takes the rank's own
    part of it and sends nothing."""
    return _AllGather.apply(t, comm, on_backward, replicated)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        return comm.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone()), None


def sum_forward(t: torch.Tensor, comm: "Comm") -> torch.Tensor:
    """The sum of ``t`` over ``comm``'s ranks; the backward passes the
    gradient through unchanged (Megatron's reduction after a
    row-parallel matmul: each rank's partial product gets the whole
    output's gradient)."""
    return t if comm.world == 1 else _SumForward.apply(t, comm)


def sum_backward(t: torch.Tensor, comm: "Comm") -> torch.Tensor:
    """``t`` unchanged; the backward sums its gradient over ``comm``'s
    ranks (Megatron's copy into a column-parallel branch: each rank's
    slice contributes part of the replicated input's gradient). With it
    the replicated parameters before the branch get their whole
    gradient on every rank, so nothing else sums them."""
    return t if comm.world == 1 else _SumBackward.apply(t, comm)


class AxisContext:
    """While active (``with``), the model's layers run sharded over the
    ranks of ``comm`` in the subclass's mode; :meth:`current` is the
    innermost active context's Comm, or None. Each subclass keeps its own
    process-wide stack, so contexts nest."""

    _stack: list = []

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._stack = []

    def __init__(self, comm: "Comm"):
        self.comm = comm

    def __enter__(self):
        type(self)._stack.append(self.comm)
        return self

    def __exit__(self, *exc):
        type(self)._stack.pop()
        return False

    @classmethod
    def current(cls) -> Optional["Comm"]:
        return cls._stack[-1] if cls._stack else None


def _experts_there(x: torch.Tensor, comm: "Comm") -> torch.Tensor:
    """[E, C, ...] -> [E / n, n * C, ...]: rank j gets every rank's block
    of its experts, rank i's at [i * C, (i + 1) * C) (the reference's tiled
    ``all_to_all`` splitting axis 0 and concatenating axis 1)."""
    n = comm.world
    E, C = x.shape[:2]
    got = comm.all_to_all(x.reshape(n, E // n, C, *x.shape[2:]))
    return got.transpose(0, 1).reshape(E // n, n * C, *x.shape[2:])


def _experts_back(y: torch.Tensor, comm: "Comm") -> torch.Tensor:
    """Inverse of :func:`_experts_there`: [E / n, n * C, ...] -> [E, C,
    ...], each block back on the rank it came from."""
    n = comm.world
    El, nC = y.shape[:2]
    C = nC // n
    blocks = y.reshape(El, n, C, *y.shape[2:]).transpose(0, 1)
    return comm.all_to_all(blocks).reshape(n * El, C, *y.shape[2:])


class _AllToAllExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, back):
        ctx.comm, ctx.back = comm, back
        return (_experts_back if back else _experts_there)(x, comm)

    @staticmethod
    def backward(ctx, g):
        inverse = _experts_there if ctx.back else _experts_back
        return inverse(g, ctx.comm), None, None


def all_to_all_experts(x: torch.Tensor, comm: "Comm",
                       back: bool = False) -> torch.Tensor:
    """Expert parallelism's exchange, differentiable: the dispatch buffer
    [E, C, ...] to this rank's experts' blocks from every rank [E / n,
    n * C, ...], or with ``back`` the inverse; each one's backward is the
    other."""
    return _AllToAllExperts.apply(x, comm, back)


def init_rank(rank: int, world: int, init_file: str, device: str,
              shared_card: bool = False, stride: int = 1,
              tp: int = 1) -> Comm:
    """Join the default process group as ``rank`` of ``world`` through the
    rendezvous file ``init_file`` and return the rank's Comm, bound to
    its first card (:func:`rank_device`)."""
    dev = rank_device(device, rank, world, shared_card, stride, tp)
    if dev.type == "cuda":
        from ddlbench_tpu_torch.device import resolve_device

        resolve_device(str(dev))  # float32 pinned to full float32 (no TF32)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and not shared_card else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **kw)
    staged = (frozenset(c for c in COLLECTIVES if c not in GLOO_CUDA_DIRECT)
              if shared_card else frozenset())
    return Comm(dist.group.WORLD, rank, world, dev, backend, staged)


def _rank_main(fn, rank, world, init_file, device, shared_card, results,
               args, stride=1, tp=1):
    try:
        comm = init_rank(rank, world, init_file, device, shared_card,
                         stride, tp)
        try:
            out = fn(comm, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, device: str = "cuda", *,
          shared_card: bool = False, args: Sequence = (),
          stride: int = 1, tp: int = 1) -> List[Any]:
    """Run ``fn(comm, *args)`` on ``world`` ranks, each a process of its own
    (spawn start method), and return their results in rank order. ``fn``
    and ``args`` are pickled by import path (a module-level function);
    rank r's group is bound to ``cuda:(r * stride)`` on the card (tpp's,
    ``tp`` > 1: :func:`rank_device`).
    Raises with every failed rank's traceback, or where a rank died without
    a word."""
    check_world(device, world, shared_card, stride, tp)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ddlb_rdv_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, os.path.join(tmp, "rdv"),
                                   device, shared_card, results, tuple(args),
                                   stride, tp))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        waited, grace = 0.0, None
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    waited += 1.0
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} died without a result "
                            f"(exit codes {[procs[r].exitcode for r in dead]})"
                            + "".join(errors))
                    # after a failure the others may wait in a collective
                    # the failed rank never joins: give them a few seconds
                    if grace is not None and waited > grace:
                        break
                    continue
                got[rank] = out
                if not ok:
                    errors.append(f"\n--- rank {rank} ---\n{out}")
                    grace = waited + 10.0
            if not errors:
                for p in procs:
                    p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError(f"{len(errors)} of {world} ranks failed"
                           f" ({world - len(got)} stopped):"
                           + "".join(errors))
    return [got[r] for r in range(world)]
