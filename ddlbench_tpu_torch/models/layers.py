"""Flat-layer model container, the training apply, the serving-layer and
cached-decode protocols and the image layers.

The port's counterpart of ``ddlbench_tpu/models/layers.py``'s
``LayerModel``, ``apply_slice``/``apply_model``, ``ServeOps``, the
``init_cache``/``prefill``/``decode`` fields with ``PagedOps``
(:class:`DecodeLayer`) and its image primitives. A model is a named flat
stack of ``nn.Module`` layers; training applies it through
:func:`apply_model`, and the serving engine and the decoders
(models/decode.py) walk the stack themselves, calling each layer's serve
or decode ops and plain ``forward`` on pointwise layers (the LM head).

The image layers compute in NCHW (channels_last on the card is a memory
format of the same tensors) with OIHW convolution kernels; their
parameter and state names are the reference's, so convert.py carries its
weights over by name. Each takes the reference's per-example input shape
``(H, W, C)`` and records ``out_shape`` in the same order. Three numerics
of the reference are kept on purpose (tests pin them):

* Convolutions and pools pad as XLA's ``SAME`` does: ``total // 2`` before
  and the rest after, so a stride-2 layer on an even size pads more at the
  bottom and right (3x3 on 56: (0, 1); the 7x7 stem on 224: (2, 3)), where
  torch's ``padding=k//2`` would pad both sides alike. :func:`conv2d` and
  :class:`MaxPool` pad explicitly with ``F.pad`` when the two sides differ
  (with -inf for a pool), then convolve or pool unpadded.
* BatchNorm (:class:`BatchNorm`) is ``F.batch_norm``: on the card two
  kernels forward (statistics, then the normalisation) and two backward
  (PyTorch's channels_last batch-norm kernels at bfloat16; the profile in
  chip_smoke.py names them), where the reference's formula written out in
  torch ops would take a dozen elementwise and reduction kernels each
  way. Its semantics are the reference's: batch statistics in float32,
  normalisation with the biased variance, the running variance updated
  with the unbiased one (n / (n - 1)), momentum 0.1, eps 1e-5, and in
  eval mode the running statistics. The statistics are reduced in another
  order than the reference's one-pass ``mean(x^2) - mean(x)^2``, which
  moves them by float32 rounding only. The scale and bias arrive as the
  compute-dtype casts of apply_slice (the reference's ``cast_params``)
  and are widened to the running statistics' type (float32) for the call,
  so ``inv = rsqrt(var + eps) * scale`` is formed in float32 from the
  rounded scale as in the reference; ``F.batch_norm`` takes float32
  weights and statistics beside bfloat16 activations (it refuses bfloat16
  weights beside float32 statistics). The output is rounded to the
  compute dtype once, where the reference rounds ``inv`` and ``shift``
  first. The running statistics are buffers, never cast. Under
  data parallelism (:class:`batch_parallel`) the statistics are the
  global batch's, reduced across the ranks: on the card through
  PyTorch's batch-norm kernels (Welford statistics, as nn.SyncBatchNorm
  computes them), on the CPU with the reference's one-pass formula
  (:meth:`BatchNorm.sync_forward`).
* :class:`Flatten` flattens in the reference's NHWC order (H, W, C): the
  classifier's first dense rows stay as the reference lays them out.
* :class:`AvgPool` counts the padding: a SAME window at the map's edge
  is the sum of its in-map values over window², as the reference's
  ``reduce_window`` sum divided by window² is (torch's
  ``count_include_pad``). It pads with zeros through ``F.pad`` (XLA's
  SAME sides, uneven at stride 2 on an even size) and pools unpadded;
  ``F.avg_pool2d(padding=k // 2)`` would pad both sides alike.
* Channel concatenations (squeezenet's fire module, densenet's blocks,
  the branchy models' joins) are on dim 1 in the reference's order on its
  last (C) axis.

The pipelines (parallel/gpipe.py, pipeline_rt.py, pipedream.py) run one
chunk ``layers[a:b]`` at a time through :func:`apply_chunk`, on the
layers' own parameters or on given ones (a weight version PipeDream
stashed), and recompute a chunk for its backward inside
:class:`frozen_batch_stats`: BatchNorm then normalises with the batch
statistics, as the first forward did, and leaves its running statistics
as that forward left them. ``torch.utils.checkpoint`` would update them a
second time; the reference's recompute is functional and discards them.
Per-layer remat (``remat_layers``: :func:`remat_call`, under single,
dp, fsdp and tp) recomputes inside the same context.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # torch's default BatchNorm momentum, as the reference's
BN_EPS = 1e-5


class ServeLayer(nn.Module):
    """A layer the continuous-batching engine (serve/engine.py) can serve.

    Serving rows are independent requests at per-row stream positions,
    borrowing K/V slots from a SHARED pool through ONE page table
    ([max_batch, npg] int32, slot 0 = scratch) that every layer indexes
    (ops/paged_decode.py). Pools are written in place.

    * ``pool_init(n_pages, page, dtype, device)`` — the layer's slice of the
      shared pool, or None for a cache-free layer (the embedding).
    * ``serve_prefill(pool, table, x, start, npl, page)`` — one
      page-aligned prompt chunk x [R, C] at positions [start, start + C).
    * ``serve_decode(pool, table, x, pos, npl, page)`` — one token per row,
      x [B, 1] at per-row positions ``pos`` [B] (an int32 tensor).
    * ``serve_verify(pool, table, x, pos0, npl, page)`` — the speculative
      verify pass: a span of W tokens per row, x [B, W] at per-row
      positions [pos0, pos0 + W), page-unaligned (the reference's
      ``ServeOps.verify``).

    ``npl`` is the number of live table pages the attention walks.

    The batch decoders of models/decode.py use :class:`DecodeLayer`'s
    protocol instead: every row one hypothesis at one shared position,
    each layer with its own cache.
    """

    def pool_init(self, n_pages: int, page: int, dtype: torch.dtype,
                  device: torch.device) -> Optional[dict]:
        return None

    def serve_prefill(self, pool, table, x, start: int, npl: int,
                      page: int) -> torch.Tensor:
        raise NotImplementedError

    def serve_decode(self, pool, table, x, pos, npl: int,
                     page: int) -> torch.Tensor:
        raise NotImplementedError

    def serve_verify(self, pool, table, x, pos0, npl: int,
                     page: int) -> torch.Tensor:
        raise NotImplementedError


class DecodeLayer(nn.Module):
    """A layer the KV-cached decoders (models/decode.py) can run one
    position at a time: the reference's ``Layer.init_cache``/``prefill``/
    ``decode`` fields and its ``PagedOps``. Every row is one hypothesis,
    and all rows sit at one position ``pos`` (a Python int). A layer that
    carries a cache sets ``cached``; one that also has the paged four sets
    ``paged``. A layer outside this protocol takes part only if it is
    ``pointwise`` (its forward on one position equals its full-sequence
    result, e.g. the LM head) and is then run through ``forward``.

    * ``init_cache(batch, max_len, dtype, device)`` — the layer's dense
      cache, or None (a cache-free layer, the embedding).
    * ``prefill(cache, x, start) -> (y, cache)`` — the whole prompt from
      position ``start`` (0: the prompt opens the stream), recording the
      cache; a cache-free layer runs ``forward``.
    * ``decode(cache, x, pos) -> (y, cache)`` — one token x [B, 1, ...]
      at position ``pos`` against the cache.
    * ``paged_init_cache``/``paged_prefill``/``paged_decode``/
      ``paged_reorder`` — the same over the row-owned beam cache
      (ops/paged_decode.py); ``paged_decode`` also takes ``npl``, the live
      pages the attention walks, and ``paged_reorder(cache, parent, pos)``
      is the copy-on-write replacement of the dense cache's gather.
    """

    cached = False
    paged = False

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device) -> Optional[dict]:
        return None

    def prefill(self, cache, x: torch.Tensor, start: int):
        return self(x), cache

    def decode(self, cache, x: torch.Tensor, pos: int):
        raise NotImplementedError

    def paged_init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                         device: torch.device) -> Optional[dict]:
        raise NotImplementedError

    def paged_prefill(self, cache, x: torch.Tensor, start: int):
        raise NotImplementedError

    def paged_decode(self, cache, x: torch.Tensor, pos: int, npl: int):
        raise NotImplementedError

    def paged_reorder(self, cache, parent: torch.Tensor, pos: int):
        raise NotImplementedError


class LayerModel(nn.Module):
    """A named flat stack of layers plus the metadata the tools need:
    ``in_shape`` is ``(H, W, C)`` for image models (the reference's order)
    and ``(T,)`` for token models; ``num_classes`` the classes or the
    vocabulary; ``src_len`` the source length of a seq2seq model (None
    otherwise). ``forward`` applies every layer in order."""

    def __init__(self, name: str, layers: Sequence[nn.Module],
                 in_shape: Tuple[int, ...], num_classes: int,
                 src_len: Optional[int] = None):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleList(layers)
        self.in_shape = tuple(in_shape)
        self.num_classes = num_classes
        self.src_len = src_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def _call(layer: nn.Module, params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(layer, params, (x,))


def apply_slice(layers: Sequence[nn.Module], x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False) -> torch.Tensor:
    """Run ``layers`` in order on casts of their parameters.

    Every floating-point parameter is cast to ``compute_dtype`` (None keeps
    it) before its layer runs, as the reference applies its model on
    ``cast_params`` (parallel/common.py): the embedding tables and the
    LayerNorm and BatchNorm scales and biases too, so activations come out
    in the compute dtype. The casts are inside autograd, so gradients land
    on the float32 master parameters; buffers (BatchNorm's running
    statistics) are the layer's own, never cast. With ``remat`` each layer
    runs through :func:`remat_call` (the reference's ``jax.checkpoint``
    a layer): the backward recomputes the layer, casts included, instead
    of keeping its interior activations, and BatchNorm's running
    statistics are updated by the first forward only."""
    if not remat:
        return apply_chunk(layers, x, compute_dtype)
    for layer in layers:
        names = [n for n, _ in layer.named_parameters()]

        def run(x, ts, layer=layer, names=names):
            return _call(layer, _cast(dict(zip(names, ts)), compute_dtype),
                         x)

        x = remat_call(run, x, [p for _, p in layer.named_parameters()])
    return x


class _Remat(torch.autograd.Function):
    """:func:`remat_call`'s node: the forward runs ``run`` without a graph
    and saves its input (and the tensors, unless ``first`` fetches the
    first one again); the backward recomputes ``run`` inside
    :class:`frozen_batch_stats` and backpropagates through it."""

    @staticmethod
    def forward(ctx, run, first, x, *tensors):
        ctx.run, ctx.first = run, first
        ctx.save_for_backward(x, *(tensors[1:] if first else tensors))
        return run(x, list(tensors))

    @staticmethod
    def backward(ctx, g):
        x, *saved = ctx.saved_tensors
        tensors = ([ctx.first()] if ctx.first else []) + saved
        needs = ctx.needs_input_grad[2:]
        x = x.detach().requires_grad_(needs[0])
        tensors = [t.detach().requires_grad_(n)
                   for t, n in zip(tensors, needs[1:])]
        with torch.enable_grad(), frozen_batch_stats():
            y = ctx.run(x, tensors)
        inputs = [t for t, n in zip([x] + tensors, needs) if n]
        got = iter(torch.autograd.grad(y, inputs, g, allow_unused=True)
                   if inputs else ())
        return (None, None) + tuple(
            (next(got) if n else None) for n in needs)


def remat_call(run, x: torch.Tensor, tensors, first=None) -> torch.Tensor:
    """``run(x, tensors)`` (one layer: a tensor from a tensor) without
    keeping its interior for the backward: the backward runs it again on
    the saved ``x`` and ``tensors`` and backpropagates through that run.
    The recompute runs inside :class:`frozen_batch_stats`, so BatchNorm
    normalises with the same batch statistics (the same batch) and its
    running statistics keep what the first forward left, as the
    reference's functional ``jax.checkpoint`` does. ``first``, when
    given, is called in the backward for ``tensors[0]`` instead of
    saving it (fsdp's re-gather of the layer's weights, which its
    backward gathers once anyway). A layer taking integer input (token
    ids: an embedding, whose backward reads only the ids) runs as it is:
    a recompute would keep nothing less."""
    if not x.is_floating_point():
        return run(x, list(tensors))
    return _Remat.apply(run, first, x, *tensors)


def _cast(params: dict, compute_dtype: Optional[torch.dtype]) -> dict:
    return {n: p.to(compute_dtype)
            if compute_dtype is not None and p.is_floating_point() else p
            for n, p in params.items()}


class frozen_batch_stats:
    """While active, BatchNorm in train mode normalises with the batch
    statistics and leaves its running statistics as they are (the
    pipelines' recompute: module docstring). Nests; one process-wide
    flag, as the pipelines run their events on one host thread."""

    depth = 0

    def __enter__(self):
        frozen_batch_stats.depth += 1
        return self

    def __exit__(self, *exc):
        frozen_batch_stats.depth -= 1


def call_layer(layer: nn.Module, params: Optional[dict], x: torch.Tensor,
               method: str = "forward"):
    """``layer.<method>(x)`` on ``params`` ({name: tensor}, the layer's
    parameter names) in place of its own parameters, or on its own when
    None; its buffers stay its own."""
    if params is None:
        return getattr(layer, method)(x)
    if method == "forward":
        return _call(layer, params, x)
    return torch.func.functional_call(
        _Method(layer, method), {f"layer.{n}": t for n, t in params.items()},
        (x,))


class _Method(nn.Module):
    """Calls one method of ``layer`` as its forward, so functional_call
    can run it on other parameters."""

    def __init__(self, layer: nn.Module, method: str):
        super().__init__()
        self.layer = layer
        self.method = method

    def forward(self, x):
        return getattr(self.layer, self.method)(x)


def apply_chunk(layers: Sequence[nn.Module], x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                params: Optional[Sequence[dict]] = None,
                update_stats: bool = True) -> torch.Tensor:
    """One pipeline chunk: :func:`apply_slice` over ``layers`` (casts of
    the parameters to ``compute_dtype`` inside autograd), on ``params``
    (one {name: tensor} per layer, float32 masters) in place of the
    layers' own when given. ``update_stats=False`` recomputes: BatchNorm
    normalises with the batch statistics and leaves its running
    statistics alone (:class:`frozen_batch_stats`)."""
    if not update_stats:
        with frozen_batch_stats():
            return apply_chunk(layers, x, compute_dtype, params)
    for i, layer in enumerate(layers):
        src = (params[i] if params is not None
               else dict(layer.named_parameters()))
        x = _call(layer, _cast(src, compute_dtype), x)
    return x


def apply_model(model: LayerModel, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False) -> torch.Tensor:
    return apply_slice(model.layers, x, compute_dtype, remat)


# ---------------------------------------------------------------------------
# Image layers (the reference's models/layers.py:305-643).
# ---------------------------------------------------------------------------

def _conv_kernel(gen: torch.Generator, kh: int, kw: int, cin: int,
                 cout: int) -> nn.Parameter:
    """Kaiming-normal, fan_out (kh * kw * cout), OIHW."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    return nn.Parameter(torch.randn(cout, cin, kh, kw, generator=gen) * std)


def _uniform(gen: torch.Generator, bound: float, *shape: int):
    return nn.Parameter((torch.rand(*shape, generator=gen) * 2 - 1) * bound)


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA SAME padding of one spatial axis of size ``n``: (before,
    after), ``total // 2`` before and the rest after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def out_hw(name: str, h: int, w: int, k: int, stride: int,
           padding: str) -> Tuple[int, int]:
    """Output size of a k x k window at ``stride`` (the reference's
    ``_conv_out_hw``). A size that reaches 0 raises: the reference would
    carry an empty map into a mean, which is NaN."""
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    elif padding == "VALID":
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    else:
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"{name}: a {k}x{k}/{stride} {padding} window takes the "
            f"{h}x{w} map to {max(oh, 0)}x{max(ow, 0)}; the input is too "
            "small for this model")
    return oh, ow


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
           groups: int = 1) -> torch.Tensor:
    """XLA SAME convolution of NCHW ``x`` with OIHW ``kernel``: padded by
    the convolution itself where both sides take the same padding, else
    by ``F.pad`` first (module docstring)."""
    (top, bottom) = same_pads(x.shape[2], kernel.shape[2], stride)
    (left, right) = same_pads(x.shape[3], kernel.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, kernel, stride=stride, padding=(top, left),
                        groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), kernel,
                    stride=stride, groups=groups)


class batch_parallel:
    """Context in which BatchNorm's training statistics are those of the
    global batch of a data-parallel group (the reference's
    ``batch_parallel`` with ``sync_batch_mean``): the model runs on one
    rank's rows and ``comm`` (distributed.Comm) all-reduces the statistics.
    parallel/dp.py applies the model inside it, in every dp engine, as the
    reference gets sync-BN from GSPMD in every dp mode."""

    _stack: list = []

    def __init__(self, comm):
        self.comm = comm

    def __enter__(self):
        type(self)._stack.append(self.comm)
        return self

    def __exit__(self, *exc):
        type(self)._stack.pop()
        return False

    @classmethod
    def current(cls):
        return cls._stack[-1] if cls._stack else None


class _SyncBatchStats(torch.autograd.Function):
    """(E[x], E[x^2]) per channel (dim 1) over the global batch: the local
    sums in ``dtype`` all-reduced in one collective and divided by the
    local count x the world. The backward all-reduces the two cotangents
    the same way (each rank's holds only its rows' part), divides by the
    same count and broadcasts them over the local rows: the reference's
    ``sync_batch_mean`` forward and backward, for x and x^2."""

    @staticmethod
    def forward(ctx, x, comm, dtype):
        dims = [d for d in range(x.dim()) if d != 1]
        xs = x.to(dtype)
        sums = torch.cat([xs.sum(dims), (xs * xs).sum(dims)])
        comm.all_reduce(sums)
        count = (x.numel() // x.shape[1]) * comm.world
        ctx.save_for_backward(x)
        ctx.comm, ctx.count, ctx.dtype = comm, count, dtype
        mean, mean2 = (sums / count).chunk(2)
        return mean, mean2

    @staticmethod
    def backward(ctx, g_mean, g_mean2):
        (x,) = ctx.saved_tensors
        c = x.shape[1]
        zero = torch.zeros(c, dtype=ctx.dtype, device=x.device)
        ct = torch.cat([zero if g_mean is None else g_mean,
                        zero if g_mean2 is None else g_mean2])
        ctx.comm.all_reduce(ct)
        ct_m, ct_m2 = (ct / ctx.count).chunk(2)
        shape = [1] * x.dim()
        shape[1] = c
        dx = (ct_m.view(shape).to(x.dtype).expand_as(x)
              + (2.0 * x.to(ctx.dtype) * ct_m2.view(shape)).to(x.dtype))
        return dx, None, None


class _SyncBatchNormCuda(torch.autograd.Function):
    """Sync-BN on the card with PyTorch's batch-norm kernels (those of
    ``nn.SyncBatchNorm``): each rank's Welford statistics
    (``batch_norm_stats``), gathered through one all-reduce of a
    [world, 2C + 1] table in which each rank fills its row (gloo takes CUDA
    tensors for all-reduce, not for all-gather), combined into the global
    mean and inverse std with the running statistics updated in place
    (``batch_norm_gather_stats_with_counts``: the unbiased variance over
    the global count; none given, none updated: a recompute inside
    :class:`frozen_batch_stats`), and ``batch_norm_elemt``; the backward
    reduces each rank's (sum dy, sum dy (x - mean)), all-reduces them and
    runs
    ``batch_norm_backward_elemt``. The weight and bias gradients stay the
    rank's own sums: dp reduces them with every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, comm):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, BN_EPS)
        table = torch.zeros(comm.world, 2 * c + 1, dtype=mean.dtype,
                            device=x.device)
        table[comm.rank, :c] = mean
        table[comm.rank, c:2 * c] = invstd
        table[comm.rank, 2 * c] = x.numel() // c
        comm.all_reduce(table)
        counts = table[:, 2 * c]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, table[:, :c], table[:, c:2 * c], running_mean, running_var,
            BN_MOMENTUM, BN_EPS, counts.to(mean.dtype))
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        ctx.comm = comm
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, BN_EPS)

    @staticmethod
    def backward(ctx, grad):
        if not grad.is_contiguous(memory_format=torch.channels_last):
            grad = grad.contiguous()
        x, weight, mean, invstd, counts = ctx.saved_tensors
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            grad, x, mean, invstd, weight, True, True, True)
        both = ctx.comm.all_reduce(torch.cat([sum_dy, sum_dy_xmu]))
        sum_dy, sum_dy_xmu = both.chunk(2)
        dx = torch.batch_norm_backward_elemt(grad, x, mean, invstd, weight,
                                             sum_dy, sum_dy_xmu, counts)
        return dx, grad_w, grad_b, None, None, None


class BatchNorm(nn.Module):
    """The reference's ``batchnorm`` (module docstring): ``scale`` and
    ``bias`` parameters, ``mean`` and ``var`` running statistics (buffers,
    float32). Train mode normalises with the batch statistics and updates
    the running ones in place; eval mode reads them. Inside
    :class:`batch_parallel` the training statistics are the global
    batch's: on the card through PyTorch's batch-norm kernels
    (:class:`_SyncBatchNormCuda`), on the CPU as the reference writes them
    out (:meth:`sync_forward`)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comm = batch_parallel.current() if self.training else None
        dtype = self.mean.dtype  # the weights take the statistics' type
        if comm is not None and x.is_cuda:
            frozen = frozen_batch_stats.depth > 0
            return _SyncBatchNormCuda.apply(
                x, self.scale.to(dtype), self.bias.to(dtype),
                None if frozen else self.mean, None if frozen else self.var,
                comm)
        if comm is not None:
            return self.sync_forward(x, comm)
        if self.training and frozen_batch_stats.depth:
            return F.batch_norm(x, None, None, self.scale.to(dtype),
                                self.bias.to(dtype), True, BN_MOMENTUM,
                                BN_EPS)
        return F.batch_norm(x, self.mean, self.var, self.scale.to(dtype),
                            self.bias.to(dtype), self.training, BN_MOMENTUM,
                            BN_EPS)

    def sync_forward(self, x: torch.Tensor, comm) -> torch.Tensor:
        """The reference's sync branch written out (the CPU's path):
        one-pass global statistics in the running statistics' type (float32, or float64
        for a float64 model), ``var = max(E[x^2] - E[x]^2, 0)``, the
        biased variance for normalising and the unbiased one (over the
        global count) for the running variance; ``inv = rsqrt(var + eps) *
        scale`` and ``shift = bias - mean * inv`` in that type, applied
        to x in its own."""
        dtype = self.mean.dtype
        mean, mean2 = _SyncBatchStats.apply(x, comm, dtype)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        n = (x.numel() // x.shape[1]) * comm.world
        if not frozen_batch_stats.depth:
            with torch.no_grad():
                unbiased = var * (n / max(1, n - 1))
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean
                                + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var
                               + BN_MOMENTUM * unbiased)
        inv = torch.rsqrt(var + BN_EPS) * self.scale
        shift = self.bias - mean * inv
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        return (x * inv.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))


class ImageLayer(nn.Module):
    """An image layer: its reference name and per-example output shape,
    ``(H, W, C)`` or ``(features,)``."""

    def __init__(self, name: str, out_shape: Tuple[int, ...]):
        super().__init__()
        self.name = name
        self.out_shape = tuple(out_shape)


class ConvBN(ImageLayer):
    """conv (SAME) -> BatchNorm [-> ReLU]; ``kernel`` is OIHW."""

    def __init__(self, name: str, in_shape, out_ch: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, groups: int = 1, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (*out_hw(name, h, w, kernel, stride, "SAME"),
                                out_ch))
        self.kernel = _conv_kernel(gen, kernel, kernel, c // groups, out_ch)
        self.bn = BatchNorm(out_ch)
        self.stride, self.relu, self.groups = stride, relu, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(conv2d(x, self.kernel, self.stride, self.groups))
        return F.relu(y) if self.relu else y


class MaxPool(ImageLayer):
    """Max pooling; ``SAME`` pads with -inf as XLA's reduce_window does."""

    def __init__(self, name: str, in_shape, window: int = 2,
                 stride: Optional[int] = None, padding: str = "VALID"):
        h, w, c = in_shape
        stride = stride or window
        super().__init__(name, (*out_hw(name, h, w, window, stride, padding),
                                c))
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            top, bottom = same_pads(x.shape[2], self.window, self.stride)
            left, right = same_pads(x.shape[3], self.window, self.stride)
            x = F.pad(x, (left, right, top, bottom), value=-math.inf)
        return F.max_pool2d(x, self.window, self.stride)


class GlobalAvgPool(ImageLayer):
    def __init__(self, name: str, in_shape):
        super().__init__(name, (in_shape[-1],))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class Flatten(ImageLayer):
    """[B, C, H, W] -> [B, H*W*C] in the reference's (H, W, C) order (free
    on a channels_last tensor); [B, features] passes through."""

    def __init__(self, name: str, in_shape):
        super().__init__(name, (math.prod(in_shape),))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class AvgPool(ImageLayer):
    """Average pooling that counts the padding (module docstring)."""

    def __init__(self, name: str, in_shape, window: int = 3,
                 stride: int = 1, padding: str = "SAME"):
        h, w, c = in_shape
        super().__init__(name, (*out_hw(name, h, w, window, stride, padding),
                                c))
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            top, bottom = same_pads(x.shape[2], self.window, self.stride)
            left, right = same_pads(x.shape[3], self.window, self.stride)
            x = F.pad(x, (left, right, top, bottom))
        return F.avg_pool2d(x, self.window, self.stride)


class Identity(ImageLayer):
    """The identity: a branchy model's join node (models/branchy.py)."""

    def __init__(self, name: str, in_shape):
        super().__init__(name, in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ConvReLU(ImageLayer):
    """A plain SAME convolution with a bias and no BatchNorm [-> ReLU]
    (LeNet, AlexNet, SqueezeNet: the architectures that predate it)."""

    def __init__(self, name: str, in_shape, out_ch: int, kernel: int,
                 stride: int = 1, relu: bool = True, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (*out_hw(name, h, w, kernel, stride, "SAME"),
                                out_ch))
        self.kernel = _conv_kernel(gen, kernel, kernel, c, out_ch)
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.relu = stride, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.kernel, self.stride) + self.b[None, :, None, None]
        return F.relu(y) if self.relu else y


class SepConvBN(ImageLayer):
    """Depthwise-separable convolution, NASNet's cell operation: ReLU ->
    depthwise k x k (stride; ``dw`` is (c, 1, k, k), convolved with
    ``groups=c``) -> pointwise 1x1 -> BatchNorm."""

    def __init__(self, name: str, in_shape, out_ch: int, kernel: int = 3,
                 stride: int = 1, *, gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (*out_hw(name, h, w, kernel, stride, "SAME"),
                                out_ch))
        self.dw = _conv_kernel(gen, kernel, kernel, 1, c)
        self.pw = _conv_kernel(gen, 1, 1, c, out_ch)
        self.bn = BatchNorm(out_ch)
        self.stride, self.c = stride, c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(F.relu(x), self.dw, self.stride, self.c)
        return self.bn(conv2d(y, self.pw))


class Dense(ImageLayer):
    """``x @ w + b`` over [B, features] (after GlobalAvgPool or Flatten),
    ``w`` ``[in, out]`` as in the reference, uniform +-1/sqrt(in) init.
    ``dropout`` is accepted and does nothing, as in the reference (a
    documented no-op there)."""

    def __init__(self, name: str, in_shape, out_features: int,
                 relu: bool = False, dropout: float = 0.0, *,
                 gen: torch.Generator):
        super().__init__(name, (out_features,))
        cin = math.prod(in_shape)
        bound = 1.0 / math.sqrt(cin)
        self.w = _uniform(gen, bound, cin, out_features)
        self.b = _uniform(gen, bound, out_features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w + self.b
        return F.relu(y) if self.relu else y


def _shortcut(layer: ImageLayer, c: int, out_ch: int, stride: int,
              gen: torch.Generator) -> None:
    """The projection shortcut (1x1 conv + BN) where the block changes
    the stride or the width; identity otherwise."""
    if stride != 1 or c != out_ch:
        layer.proj = _conv_kernel(gen, 1, 1, c, out_ch)
        layer.bn_proj = BatchNorm(out_ch)
    else:
        layer.proj = None


def _apply_shortcut(layer: ImageLayer, x: torch.Tensor) -> torch.Tensor:
    if layer.proj is None:
        return x
    return layer.bn_proj(conv2d(x, layer.proj, layer.stride))


class BasicBlock(ImageLayer):
    """ResNet BasicBlock: 3x3 (stride) -> 3x3, identity or projection
    shortcut."""

    def __init__(self, name: str, in_shape, out_ch: int, stride: int = 1, *,
                 gen: torch.Generator):
        h, w, c = in_shape
        super().__init__(name, (*out_hw(name, h, w, 3, stride, "SAME"),
                                out_ch))
        self.conv1 = _conv_kernel(gen, 3, 3, c, out_ch)
        self.conv2 = _conv_kernel(gen, 3, 3, out_ch, out_ch)
        self.bn1, self.bn2 = BatchNorm(out_ch), BatchNorm(out_ch)
        self.stride = stride
        _shortcut(self, c, out_ch, stride, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d(x, self.conv1, self.stride)))
        y = self.bn2(conv2d(y, self.conv2))
        return F.relu(y + _apply_shortcut(self, x))


class Bottleneck(ImageLayer):
    """ResNet Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x expansion),
    identity or projection shortcut."""

    def __init__(self, name: str, in_shape, mid_ch: int, stride: int = 1,
                 expansion: int = 4, *, gen: torch.Generator):
        h, w, c = in_shape
        out_ch = mid_ch * expansion
        super().__init__(name, (*out_hw(name, h, w, 3, stride, "SAME"),
                                out_ch))
        self.conv1 = _conv_kernel(gen, 1, 1, c, mid_ch)
        self.conv2 = _conv_kernel(gen, 3, 3, mid_ch, mid_ch)
        self.conv3 = _conv_kernel(gen, 1, 1, mid_ch, out_ch)
        self.bn1, self.bn2 = BatchNorm(mid_ch), BatchNorm(mid_ch)
        self.bn3 = BatchNorm(out_ch)
        self.stride = stride
        _shortcut(self, c, out_ch, stride, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d(x, self.conv1)))
        y = F.relu(self.bn2(conv2d(y, self.conv2, self.stride)))
        y = self.bn3(conv2d(y, self.conv3))
        return F.relu(y + _apply_shortcut(self, x))


class InvertedResidual(ImageLayer):
    """MobileNetV2's block: 1x1 expand (when ``expand`` > 1) -> 3x3
    depthwise (stride) -> 1x1 project, ReLU6 after the first two; the
    input is added where the stride is 1 and the widths match."""

    def __init__(self, name: str, in_shape, out_ch: int, stride: int,
                 expand: int, *, gen: torch.Generator):
        h, w, c = in_shape
        hidden = c * expand
        super().__init__(name, (*out_hw(name, h, w, 3, stride, "SAME"),
                                out_ch))
        if expand != 1:
            self.expand = _conv_kernel(gen, 1, 1, c, hidden)
            self.bn_e = BatchNorm(hidden)
        else:
            self.expand = None
        # depthwise: one input channel per group, groups = hidden
        self.dw = _conv_kernel(gen, 3, 3, 1, hidden)
        self.bn_d = BatchNorm(hidden)
        self.project = _conv_kernel(gen, 1, 1, hidden, out_ch)
        self.bn_p = BatchNorm(out_ch)
        self.stride, self.hidden = stride, hidden
        self.residual = stride == 1 and c == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = F.relu6(self.bn_e(conv2d(y, self.expand)))
        y = F.relu6(self.bn_d(conv2d(y, self.dw, self.stride, self.hidden)))
        y = self.bn_p(conv2d(y, self.project))
        return y + x if self.residual else y
