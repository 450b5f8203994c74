"""Per-layer profiler of the port: layer chain (or layer DAG) -> weighted
profile Graph (the reference's ``profiler/profile.py``).

Each node is one layer: its forward and backward compute times (ms), its
output activation bytes and its parameter bytes, in the graph text format
of graph/graph.py. Two modes, as in the reference:

* ``"time"``: each layer's forward, and its forward + backward, run on the
  layer's device after ``warmup`` untimed calls (which build any kernel
  the layer launches first: no timed sample holds an nvcc build), timed
  with CUDA events on the card and ``perf_counter`` on the CPU; the
  median of ``repeats`` samples, ``bwd = max(fb - f, 0)``. The
  reference subtracts an empty-queue sync latency from each host-timed
  sample, because a completion barrier over its device tunnel costs a
  round trip; CUDA events are recorded on the device's own stream and
  hold no host round trip, so nothing is subtracted.
* ``"flops"``: each layer's forward FLOPs over ``hw.peak_flops``, the
  backward twice the forward (the reference's rule). The count runs on
  the ``meta`` device through the plain attention path, so it never
  depends on what implements a layer: the card (whose CUDA kernels a
  FLOP counter cannot see) and the CPU give the same graph. It is the
  port's own per-op tally, written to follow XLA's HLO cost analysis,
  which the reference divides: 2 per multiply-add of a matmul or a
  convolution (a convolution's taps on padding excluded), one per output
  element of an elementwise op (transcendentals excluded, as XLA counts
  them apart), one per input element of a reduction, and a fixed count
  per element for the fused normalisation and softmax ops that XLA sees
  written out. tests/test_torch_profile.py states how far each node's
  count lies from XLA's.

Profiling has no side effects: every layer runs under
``frozen_batch_stats`` (BatchNorm normalises with the batch statistics
and leaves its running statistics as they were), gradients are taken
with ``torch.autograd.grad`` (no ``.grad`` is written), and a layer's
train/eval mode is restored after it. Token ids are not differentiated.
Activation sizes use the profile dtype's itemsize, float32 by default.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

from ddlbench_tpu_torch.config import HardwareModel
from ddlbench_tpu_torch.graph.graph import Graph, Node
from ddlbench_tpu_torch.models.branchy import combine
from ddlbench_tpu_torch.models.layers import apply_chunk, frozen_batch_stats


# elementwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "erf", "erfc", "erfinv", "pow", "sin", "cos",
    "tan", "atan", "atan2", "asin", "acos"))
# ops that move or view data: no FLOPs
_FREE = frozenset((
    "clone", "copy", "_to_copy", "copy_", "lift_fresh", "detach", "view",
    "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "slice", "select", "unsqueeze", "squeeze", "cat", "stack", "split",
    "split_with_sizes", "chunk", "constant_pad_nd", "gather",
    "index_select", "alias", "empty_like", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_empty", "new_full",
    "arange", "full", "zeros", "ones", "empty", "fill", "fill_", "zero_",
    "scalar_tensor", "_reshape_alias", "as_strided", "unbind", "flip",
    "roll", "contiguous", "masked_fill", "scatter", "scatter_add",
    "index_put", "index_add", "one_hot", "topk", "sort", "argsort",
    "_local_scalar_dense"))
# output-element multiples for the fused ops XLA sees written out: layer
# and batch normalisation (mean, centre, square, mean, scale, shift: 7
# elementwise passes), softmax (max, subtract, sum, divide: 4)
_FUSED_PER_ELEMENT = {
    "native_layer_norm": 7, "native_batch_norm": 7,
    "_native_batch_norm_legit": 7, "_native_batch_norm_legit_no_training": 4,
    "_softmax": 4, "_log_softmax": 5}
_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "var", "var_mean", "std",
    "argmax", "argmin", "logsumexp", "prod", "any", "all"))


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _valid_taps(size: int, kernel: int, stride: int, dilation: int,
                pad_lo: int, out: int) -> int:
    """Sum over ``out`` output positions of the kernel taps landing inside
    the unpadded input of ``size`` (XLA's convolution count)."""
    total = 0
    for o in range(out):
        start = o * stride - pad_lo
        total += sum(1 for k in range(kernel)
                     if 0 <= start + k * dilation < size)
    return total


class _FlopCount(TorchDispatchMode):
    """Counts the FLOPs of the aten ops run under it (module docstring).
    A zero-valued ``constant_pad_nd`` is remembered on its output, so a
    convolution of it counts the taps on that padding as padding."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._pads = WeakTensorKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        first = out[0] if isinstance(out, (tuple, list)) else out
        if name == "constant_pad_nd":
            value = args[2] if len(args) > 2 else kwargs.get("value", 0)
            if value == 0:
                self._pads[out] = (args[0].shape, list(args[1]))
            return out
        if name == "convolution":
            self.flops += self._conv(*args[:9])
        elif func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            if name in ("addmm", "baddbmm"):
                self.flops += _numel(first)  # the bias add
        elif name in _FUSED_PER_ELEMENT:
            self.flops += _FUSED_PER_ELEMENT[name] * _numel(first)
        elif name in _REDUCTIONS:
            self.flops += _numel(args[0])
        elif name in _FREE or name in _TRANSCENDENTAL:
            pass
        elif torch.Tag.pointwise in func.tags:
            self.flops += _numel(first)
        elif name in ("avg_pool2d", "max_pool2d_with_indices"):
            # XLA's reduce_window: window - 1 reductions an output, and
            # an average's divide
            k = args[1]
            window = math.prod(k if isinstance(k, (list, tuple)) else (k, k))
            self.flops += _numel(first) * (window - 1
                                           + (name == "avg_pool2d"))
        elif name in ("embedding", "index"):
            self.flops += _numel(first)  # jnp.take's bounds select
        return out

    def _conv(self, x, w, bias, stride, padding, dilation, transposed,
              output_padding, groups) -> int:
        if transposed:
            raise ValueError("a transposed convolution is not counted (the "
                             "port's models build none)")
        spatial = list(x.shape[2:])
        pads = [(p, p) for p in padding]
        if x in self._pads:
            orig, flat = self._pads[x]
            # F.pad's list runs last dimension first: (left, right, top,
            # bottom) for an NCHW map
            for d in range(len(spatial)):
                lo, hi = flat[2 * (len(spatial) - 1 - d):
                              2 * (len(spatial) - 1 - d) + 2]
                spatial[d] = orig[2 + d]
                pads[d] = (pads[d][0] + lo, pads[d][1] + hi)
        out_sp = [(spatial[d] + pads[d][0] + pads[d][1]
                   - dilation[d] * (w.shape[2 + d] - 1) - 1) // stride[d] + 1
                  for d in range(len(spatial))]
        taps = 1
        for d in range(len(spatial)):
            taps *= _valid_taps(spatial[d], w.shape[2 + d], stride[d],
                                dilation[d], pads[d][0], out_sp[d])
        macs = x.shape[0] * w.shape[0] * (x.shape[1] // groups) * taps
        return 2 * macs + (x.shape[0] * w.shape[0] * math.prod(out_sp)
                           if bias is not None else 0)


def layer_names(model) -> List[str]:
    """The reference's name of each layer of ``model``: an image layer's
    own; for the token stacks embed, block{i} / moe_block{i} (i the
    layer's index), lstm{k} and attn{k} (k counting the LSTM layers) and
    lm_head."""
    names, lstm = [], 0
    for idx, layer in enumerate(model.layers):
        name = getattr(layer, "name", None)
        kind = type(layer).__name__
        if name is None:
            if kind in ("Embed", "Seq2seqEmbed", "LSTMEmbed"):
                name = "embed"
            elif kind == "LMHead":
                name = "lm_head"
            elif kind == "MoEBlock":
                name = f"moe_block{idx}"
            elif kind == "LSTMLayer":
                lstm += 1
                name = f"lstm{lstm}"
            elif kind == "CrossAttention":
                name = f"attn{lstm}"
            else:
                name = f"block{idx}"
        names.append(name)
    return names


def _param_bytes(layer: torch.nn.Module) -> float:
    return float(sum(p.numel() * p.element_size()
                     for p in layer.parameters()))


def _prod(shape: Sequence[int]) -> float:
    out = 1.0
    for d in shape:
        out *= d
    return out


def _nchw(shape: Sequence[int]) -> Tuple[int, ...]:
    """A per-example shape in the reference's order ((H, W, C) for an image
    map) as the port's tensor shape ((C, H, W))."""
    return ((shape[2], shape[0], shape[1]) if len(shape) == 3
            else tuple(shape))


def _ref_order(shape: Sequence[int]) -> Tuple[int, ...]:
    return ((shape[1], shape[2], shape[0]) if len(shape) == 3
            else tuple(shape))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, device: torch.device, repeats: int = 5,
             warmup: int = 2) -> float:
    """Median time of ``fn()`` in ms over ``repeats`` samples, after
    ``warmup`` untimed calls: CUDA events on the card, perf_counter on
    the CPU."""
    for _ in range(max(1, warmup)):
        fn()
    _sync(device)
    samples = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(samples)


class _plain_attention:
    """The attention backend set to the plain path while active."""

    def __enter__(self):
        from ddlbench_tpu_torch.models import transformer

        self._prev = transformer._ATTENTION_BACKEND[0]
        transformer.set_attention_backend("xla")

    def __exit__(self, *exc):
        from ddlbench_tpu_torch.models import transformer

        transformer.set_attention_backend(self._prev)


def _forward_flops(layer, xs, how, dtype) -> int:
    """The forward FLOPs of ``layer`` on inputs shaped like ``xs``, counted
    on the meta device (the layer's own tensors are not touched)."""
    # the parameters in the profile dtype (apply_chunk's cast), the
    # buffers as they are
    meta = {n: torch.empty(t.shape, device="meta",
                           dtype=dtype if t.is_floating_point() else t.dtype)
            for n, t in layer.named_parameters()}
    meta.update({n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for n, t in layer.named_buffers()})
    xm = [x if x.device.type == "meta" else
          torch.empty(x.shape, dtype=x.dtype, device="meta") for x in xs]
    counter = _FlopCount()
    with torch.no_grad(), frozen_batch_stats(), _plain_attention(), counter:
        torch.func.functional_call(layer, meta, (combine(xm, how),))
    return counter.flops


def _profile_node(layer, xs, how, mode, hw, repeats, dtype):
    """The shared per-node measurement core of profile_model/profile_dag:
    (fwd_ms, bwd_ms) for one layer, its inputs pre-combined with ``how``
    ("" / "concat" / "add") as the node's own cost."""
    if mode == "flops":
        f_flops = float(_forward_flops(layer, xs, how, dtype))
        b_flops = 2.0 * f_flops  # dL/dw + dL/dx each cost ~one forward
        return (1000.0 * f_flops / hw.peak_flops,
                1000.0 * b_flops / hw.peak_flops)
    if mode != "time":
        raise ValueError(f"unknown profile mode {mode!r}")
    device = xs[0].device
    params = list(layer.parameters())

    def fwd():
        with torch.no_grad(), frozen_batch_stats():
            return apply_chunk([layer], combine(xs, how), dtype)

    def fwd_bwd():
        with torch.enable_grad(), frozen_batch_stats():
            xin = [x.detach().requires_grad_(True)
                   if x.is_floating_point() else x for x in xs]
            out = apply_chunk([layer], combine(xin, how), dtype)
            # token ids are not differentiable: only dL/dw for that layer
            wrt = params + [x for x in xin if x.requires_grad]
            return torch.autograd.grad(out.float().sum(), wrt,
                                       allow_unused=True)

    f_ms = _time_ms(fwd, device, repeats=repeats)
    fb_ms = _time_ms(fwd_bwd, device, repeats=repeats)
    return f_ms, max(fb_ms - f_ms, 0.0)


def _input(idx: int, shape, batch_size: int, tokens: bool, vocab: int,
           dtype, device, gen: torch.Generator) -> torch.Tensor:
    """A random input of one node: int ids in [0, vocab) for a token
    model's first layer, else standard normal values in ``dtype``."""
    full = (batch_size, *_nchw(shape))
    if device.type == "meta":  # flops mode: shapes only
        return torch.empty(full, dtype=torch.long if idx == 0 and tokens
                           else dtype, device=device)
    if idx == 0 and tokens:
        x = torch.randint(0, vocab, full, generator=gen)
    else:
        x = torch.randn(full, generator=gen).to(dtype)
    return x.to(device)


def _model_shapes(model) -> List[Tuple[int, ...]]:
    """Per-example boundary shapes in the reference's order (the input
    shape, then each layer's output), from one batch-1 pass of the plain
    path on the meta device."""
    tokens = len(model.in_shape) == 1
    x = torch.empty((1, *_nchw(model.in_shape)),
                    dtype=torch.long if tokens else torch.float32,
                    device="meta")
    shapes = [tuple(model.in_shape)]
    with torch.no_grad(), frozen_batch_stats(), _plain_attention():
        for layer in model.layers:
            meta = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                    for n, t in list(layer.named_parameters())
                    + list(layer.named_buffers())}
            x = torch.func.functional_call(layer, meta, (x,))
            shapes.append(_ref_order(tuple(x.shape[1:])))
    return shapes


class _train_mode:
    """``module`` in train mode while active, its mode restored after."""

    def __init__(self, module: torch.nn.Module):
        self.module = module

    def __enter__(self):
        self._was = self.module.training
        self.module.train()

    def __exit__(self, *exc):
        self.module.train(self._was)


def _device_of(model) -> torch.device:
    p = next(model.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def profile_model(
    model,
    batch_size: int,
    mode: str = "time",
    dtype=torch.float32,
    hw: Optional[HardwareModel] = None,
    repeats: int = 5,
    seed: int = 0,
    input_time_ms: float = 0.0,
) -> Graph:
    """Profile every layer of a LayerModel on its own device; returns a
    chain Graph with per-node forward/backward times (ms), activation
    sizes and parameter sizes (bytes).

    ``input_time_ms`` > 0 prepends a synthetic "input" source node carrying
    the measured per-batch data-loading cost, so the partitioner prices
    host-side loading into stage 0. Layer node ids stay the layer indices;
    the input node id is "input"."""
    hw = hw or HardwareModel()
    shapes = _model_shapes(model)
    itemsize = torch.empty((), dtype=dtype).element_size()
    device = torch.device("meta") if mode == "flops" else _device_of(model)
    tokens = len(model.in_shape) == 1
    gen = torch.Generator().manual_seed(seed + 1)
    names = layer_names(model)
    nodes = []
    with _train_mode(model):
        for idx, layer in enumerate(model.layers):
            x = _input(idx, shapes[idx], batch_size, tokens,
                       model.num_classes, dtype, device, gen)
            f_ms, b_ms = _profile_node(layer, [x], "", mode, hw, repeats,
                                       dtype)
            nodes.append(Node(
                node_id=str(idx),
                node_desc=names[idx],
                forward_compute_time=f_ms,
                backward_compute_time=b_ms,
                activation_size=float(batch_size) * _prod(shapes[idx + 1])
                * itemsize,
                parameter_size=_param_bytes(layer),
            ))
    if input_time_ms > 0.0:
        in_bytes = float(batch_size) * _prod(shapes[0]) * itemsize
        nodes.insert(0, Node(
            node_id="input",
            node_desc="Input",
            forward_compute_time=float(input_time_ms),
            backward_compute_time=0.0,
            activation_size=in_bytes,
            parameter_size=0.0,
        ))
    return Graph.chain(nodes)


def measure_input_ms(data, batches: int = 3) -> float:
    """Average wall-clock cost of fetching one training batch from a data
    source with the ``batch(epoch, i)`` interface (host read + upload).
    The profiler's Input-node weight for the on-disk path. Callers should
    pass a throwaway data instance: sequential on-disk streams advance
    with every fetch."""
    x, _ = data.batch(0, 0)  # warm: page cache, first-use builds
    _sync(x.device)
    t0 = time.perf_counter()
    for i in range(batches):
        x, _ = data.batch(0, i)
    _sync(x.device)
    return 1000.0 * (time.perf_counter() - t0) / batches


def fold_input_node(graph: Graph) -> Graph:
    """Collapse the synthetic Input source node into its successor: the
    partitioner prices data loading into the stage hosting layer 0 (a
    device cannot run "just data loading", so Input must never form its
    own stage). Returns a new chain graph of the layer nodes; graphs
    without an input node pass through unchanged."""
    order = graph.topological_sort()
    if not order or order[0].node_id != "input":
        return graph
    rest = [dataclasses.replace(n) for n in order[1:]]
    rest[0].forward_compute_time += order[0].forward_compute_time
    return Graph.chain(rest)


def profile_dag(
    model,
    batch_size: int,
    mode: str = "time",
    dtype=torch.float32,
    hw: Optional[HardwareModel] = None,
    repeats: int = 5,
    seed: int = 0,
    return_shapes: bool = False,
):
    """Profile a DagModel (models/branchy.py) node by node; returns the
    branchy Graph (node ids are layer indices, edges the declared
    dataflow). Each node's cost includes its input-combine (concat/add)
    op. With ``return_shapes`` also the per-node output shapes in the
    reference's order. The layers run on the device of their
    parameters."""
    hw = hw or HardwareModel()
    itemsize = torch.empty((), dtype=dtype).element_size()
    out_shapes = [tuple(layer.out_shape) for layer in model.layers]
    device = (torch.device("meta") if mode == "flops" else
              next((p.device for layer in model.layers
                    for p in layer.parameters()), torch.device("cpu")))
    gen = torch.Generator().manual_seed(seed + 1)
    nodes = []
    for idx, layer in enumerate(model.layers):
        preds = model.inputs[idx]
        xs = [_input(1, model.in_shape if p < 0 else out_shapes[p],
                     batch_size, False, model.num_classes, dtype, device,
                     gen) for p in preds]
        with _train_mode(layer):
            f_ms, b_ms = _profile_node(layer, xs, model.combine[idx], mode,
                                       hw, repeats, dtype)
        nodes.append(Node(
            node_id=str(idx),
            node_desc=layer.name,
            forward_compute_time=f_ms,
            backward_compute_time=b_ms,
            activation_size=float(batch_size) * _prod(out_shapes[idx])
            * itemsize,
            parameter_size=_param_bytes(layer),
        ))
    g = Graph()
    for n in nodes:
        g.add_node(n)
    for idx in range(len(model.layers)):
        for pr in model.inputs[idx]:
            if pr >= 0:
                g.add_edge(str(pr), str(idx))
    if return_shapes:
        return g, out_shapes
    return g


def coarse_chain(graph: Graph, model) -> Graph:
    """Aggregate a DAG profile into the chain of its articulation blocks
    (models/branchy.block_spans): summed compute/params per block,
    boundary activation = the single tensor crossing each cut. Its node
    index k is layer k of branchy.to_chain(model), so stage bounds
    transfer 1:1."""
    from ddlbench_tpu_torch.models.branchy import block_spans

    spans = block_spans(model)
    chain_nodes = []
    for k, (a, b) in enumerate(spans):
        nd = Node(str(k), node_desc=f"block{k}")
        for i in range(a, b):
            n = graph.nodes[str(i)]
            nd.forward_compute_time += n.forward_compute_time
            nd.backward_compute_time += n.backward_compute_time
            nd.parameter_size += n.parameter_size
        if b < len(model.layers):
            # the cut at b crosses exactly one source (articulation
            # property): its output is the boundary tensor
            (src,) = {s for d in range(b, len(model.layers))
                      for s in model.inputs[d] if 0 <= s < b}
            nd.activation_size = graph.nodes[str(src)].activation_size
        else:
            nd.activation_size = graph.nodes[str(b - 1)].activation_size
        chain_nodes.append(nd)
    return Graph.chain(chain_nodes)


def packed_chain_graph(graph: Graph, model, batch_size: int,
                       itemsize: int = 4) -> Graph:
    """Node-granular chainized view of a DAG profile for topo-prefix cuts.

    Node i keeps its measured cost/params; its activation_size becomes the
    packed bytes crossing the cut after it: the sum of every tensor (the
    model input too, when consumed later) flowing from [0, i] to [i+1, n).
    A cut at any position is then executable through
    branchy.to_packed_chain (one flat boundary buffer per cut), so the
    partitioner prices and the runtime executes the same boundaries, and
    the chain shape keeps the C++ DP applicable."""
    from ddlbench_tpu_torch.models.branchy import crossing_ids

    n = len(model.layers)
    in_bytes = float(batch_size) * _prod(model.in_shape) * itemsize
    chain_nodes = []
    for i in range(n):
        src = graph.nodes[str(i)]
        nd = Node(str(i), node_desc=src.node_desc,
                  forward_compute_time=src.forward_compute_time,
                  backward_compute_time=src.backward_compute_time,
                  parameter_size=src.parameter_size)
        if i < n - 1:
            nd.activation_size = sum(
                in_bytes if pid < 0
                else graph.nodes[str(pid)].activation_size
                for pid in crossing_ids(model, i + 1))
        else:
            nd.activation_size = src.activation_size
        chain_nodes.append(nd)
    return Graph.chain(chain_nodes)


def chunk_cost_ms(graph: Graph, bounds: Sequence[int]):
    """Per-chunk (forward_ms, backward_ms) sums of a profile graph over
    chosen stage/chunk bounds, the raw material of cost-weighted
    timetables (partition/schedule.quantize_cost_vectors): chunk c owns
    graph nodes [bounds[c], bounds[c+1]) in topological order, exactly
    the spans the partitioner chose and the pipeline runtime executes."""
    order = graph.topological_sort()
    f_ms, b_ms = [], []
    for c in range(len(bounds) - 1):
        span = order[bounds[c]:bounds[c + 1]]
        f_ms.append(sum(n.forward_compute_time for n in span))
        b_ms.append(sum(n.backward_compute_time for n in span))
    return f_ms, b_ms


def profile_and_partition(
    model,
    batch_size: int,
    num_chips: int,
    num_hosts: int = 1,
    mode: str = "time",
    hw: Optional[HardwareModel] = None,
):
    """profile -> hierarchical partition; returns (graph,
    PartitionResult), the stage ids written onto the graph's nodes."""
    from ddlbench_tpu_torch.partition.optimizer import (
        partition_hierarchical,
        stamp_stage_ids,
    )

    hw = hw or HardwareModel()
    graph = profile_model(model, batch_size, mode=mode, hw=hw)
    result = partition_hierarchical(graph, num_chips, hw, num_hosts=num_hosts)
    stamp_stage_ids(graph, result)
    return graph, result
