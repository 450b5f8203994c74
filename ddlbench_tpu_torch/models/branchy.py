"""Models declared as DAGs of layers, run as chains of composite layers
(``ddlbench_tpu/models/branchy.py``): the inception and nasnet families.

A :class:`DagModel` lists its layers in topological order with each
layer's predecessor indices (-1 is the model's input) and the rule that
joins several inputs ("concat" over channels, in the listed order, or
"add"). The layers are built as they are appended, each on the shape its
inputs give it. :func:`to_chain` cuts the DAG at its articulation
positions (where exactly one tensor crosses the cut) and wraps each span
in a :class:`Composite` layer, so the strategies see a flat chain; a
composite's parameters are named ``<k>.<name>`` after the span's k-th
node, which is how the reference's per-span list of parameter dicts maps
onto them (convert.py). The packed multi-tensor chain the reference's
pipeline partitioner uses waits for the pipeline strategies (ROADMAP
A.7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from ddlbench_tpu_torch.models.layers import (AvgPool, ConvBN, Dense,
                                              Flatten, GlobalAvgPool,
                                              Identity, ImageLayer,
                                              LayerModel, MaxPool, SepConvBN)

Shape = Tuple[int, ...]


def combined_shape(shapes: Sequence[Shape], how: str) -> Shape:
    if len(shapes) == 1:
        return tuple(shapes[0])
    if how == "concat":
        base = tuple(shapes[0][:-1])
        if any(tuple(s[:-1]) != base for s in shapes):
            raise ValueError(f"cannot concatenate maps of shapes {shapes}")
        return (*base, sum(s[-1] for s in shapes))
    if any(tuple(s) != tuple(shapes[0]) for s in shapes):
        raise ValueError(f"cannot add maps of shapes {shapes}")
    return tuple(shapes[0])


def combine(vals: List[torch.Tensor], how: str) -> torch.Tensor:
    """Join a node's inputs: one passes through; "concat" along the
    channels (dim 1) in order; "add" sums them in order."""
    if len(vals) == 1:
        return vals[0]
    if how == "concat":
        return torch.cat(vals, dim=1)
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return total


@dataclasses.dataclass
class DagModel:
    """A model as a DAG of built layers in topological order (module
    docstring)."""

    name: str
    in_shape: Shape
    num_classes: int
    layers: List[ImageLayer] = dataclasses.field(default_factory=list)
    inputs: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    combine: List[str] = dataclasses.field(default_factory=list)

    def add(self, make: Callable[[Shape], ImageLayer], preds,
            how: str = "") -> int:
        """Append the layer ``make(in_shape)`` reading ``preds``, joined by
        ``how``; returns its index."""
        preds = tuple(preds)
        if any(p >= len(self.layers) for p in preds):
            raise ValueError(f"node {len(self.layers)} has a "
                             f"non-topological input {preds}")
        if len(preds) > 1 and how not in ("concat", "add"):
            raise ValueError(f"{len(preds)} inputs need concat or add")
        shape = combined_shape([self.in_shape if p < 0
                                else self.layers[p].out_shape
                                for p in preds], how)
        self.layers.append(make(shape))
        self.inputs.append(preds)
        self.combine.append(how)
        return len(self.layers) - 1


def cut_positions(model: DagModel) -> List[int]:
    """Positions p (0 < p < n) where cutting [0, p) | [p, n) leaves one
    tensor crossing: every edge into {>= p} from {< p} (or from the input)
    has the same source."""
    n = len(model.layers)
    cuts = []
    for p in range(1, n):
        sources = {s for d in range(p, n) for s in model.inputs[d] if s < p}
        if len(sources) == 1:
            cuts.append(p)
    return cuts


def block_spans(model: DagModel) -> List[Tuple[int, int]]:
    """The node spans between consecutive articulation cuts."""
    bounds = [0] + cut_positions(model) + [len(model.layers)]
    return list(zip(bounds[:-1], bounds[1:]))


class Composite(ImageLayer):
    """DAG span [start, end) as one layer: the span's external inputs all
    come from one source, whose tensor is the layer's input."""

    def __init__(self, model: DagModel, start: int, end: int):
        name = (model.layers[start].name if end - start == 1 else
                f"{model.layers[start].name}..{model.layers[end - 1].name}")
        super().__init__(name, model.layers[end - 1].out_shape)
        self.start = start
        self.inputs = model.inputs[start:end]
        self.combine = model.combine[start:end]
        # parameters named "<k>.<name>", as the reference's list of dicts
        for k, node in enumerate(model.layers[start:end]):
            self.add_module(str(k), node)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = {}
        for k, (preds, how) in enumerate(zip(self.inputs, self.combine)):
            xin = combine([x if p < self.start else outs[p] for p in preds],
                          how)
            outs[self.start + k] = self._modules[str(k)](xin)
        return outs[self.start + len(self.inputs) - 1]


def to_chain(model: DagModel) -> LayerModel:
    """The DAG as a flat LayerModel of one composite layer per span
    between articulation cuts."""
    return LayerModel(model.name, [Composite(model, a, b)
                                   for a, b in block_spans(model)],
                      model.in_shape, model.num_classes)


# ---- inception ------------------------------------------------------------

_INCEPTION_BLOCKS = {
    # (ch1, ch3r, ch3, ch5r, ch5, pool_proj): GoogLeNet's table 1 widths
    "inception": [(64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
                  (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64)],
    # the tiny variant the tests use
    "inception_t": [(8, 8, 8, 4, 4, 4), (8, 8, 8, 4, 4, 4)],
}


def _add_inception_block(dag: DagModel, gen, pred: int, name: str, ch1: int,
                         ch3r: int, ch3: int, ch5r: int, ch5: int,
                         pool_proj: int) -> int:
    """One GoogLeNet module reading node ``pred``: four branches (1x1;
    1x1 -> 3x3; 1x1 -> 5x5; 3x3 max pool -> 1x1) concatenated in that
    order. Returns the join's index."""

    def conv(nm, ch, k):
        return lambda s: ConvBN(nm, s, ch, k, gen=gen)

    b1 = dag.add(conv(f"{name}_1x1", ch1, 1), [pred])
    b3 = dag.add(conv(f"{name}_3x3", ch3, 3),
                 [dag.add(conv(f"{name}_3x3r", ch3r, 1), [pred])])
    b5 = dag.add(conv(f"{name}_5x5", ch5, 5),
                 [dag.add(conv(f"{name}_5x5r", ch5r, 1), [pred])])
    bp = dag.add(lambda s: MaxPool(f"{name}_pool", s, 3, 1, "SAME"), [pred])
    bpp = dag.add(conv(f"{name}_poolproj", pool_proj, 1), [bp])
    return dag.add(lambda s: Identity(f"{name}_concat", s),
                   [b1, b3, b5, bpp], "concat")


def build_inception(arch: str, in_shape, num_classes: int,
                    seed: int = 0) -> DagModel:
    """A mini GoogLeNet: stem, four inception modules with a max pool after
    the second, global average pool, dense."""
    gen = torch.Generator().manual_seed(seed)
    dag = DagModel(arch, tuple(in_shape), num_classes)
    small = in_shape[0] <= 64
    stem_ch = 16 if arch == "inception_t" else 64
    cur = dag.add(lambda s: ConvBN("stem", s, stem_ch, 3 if small else 7,
                                   1 if small else 2, gen=gen), [-1])
    if not small:
        cur = dag.add(lambda s: MaxPool("stem_pool", s, 3, 2, "SAME"), [cur])
    blocks = _INCEPTION_BLOCKS[arch]
    for i, spec in enumerate(blocks):
        cur = _add_inception_block(dag, gen, cur, f"inc{i}", *spec)
        if i == len(blocks) // 2 - 1:
            cur = dag.add(lambda s, i=i: MaxPool(f"mid_pool{i}", s, 3, 2,
                                                 "SAME"), [cur])
    cur = dag.add(lambda s: GlobalAvgPool("gap", s), [cur])
    cur = dag.add(lambda s: Flatten("flatten", s), [cur])
    dag.add(lambda s: Dense("fc", s, num_classes, gen=gen), [cur])
    return dag


# ---- nasnet ---------------------------------------------------------------

_NASNET_SPECS = {
    # (stem channels, cell filters, cells: N normal, R reduction; the
    # filters double at each reduction)
    "nasnet": (32, 44, "NNRNNRNN"),
    # the tiny variant the tests use
    "nasnet_t": (8, 8, "NRN"),
}


def _nasnet_ops(dag: DagModel, gen, name: str):
    """Node constructors of one cell, named after it."""

    def sep(tag, ch, k, stride=1):
        return lambda s: SepConvBN(f"{name}_{tag}", s, ch, k, stride,
                                   gen=gen)

    def adj(tag, ch, stride=1):
        return lambda s: ConvBN(f"{name}_{tag}", s, ch, 1, stride, gen=gen)

    def pair(tag, left, right):
        return dag.add(lambda s: Identity(f"{name}_{tag}", s), [left, right],
                       "add")

    return sep, adj, pair


def _add_nasnet_normal(dag: DagModel, gen, prev: int, cur: int, name: str,
                       ch: int, adj_stride: int = 1) -> int:
    """A normal cell over (h_{i-2} = prev, h_{i-1} = cur): five pairwise
    sums concatenated (5 ch channels). ``adj_stride`` 2 halves a lagging
    prev in its 1x1 adjustment."""
    sep, adj, pair = _nasnet_ops(dag, gen, name)

    def avg(tag):
        return lambda s: AvgPool(f"{name}_{tag}", s)

    p = dag.add(adj("adjP", ch, adj_stride), [prev])
    c = dag.add(adj("adjC", ch), [cur])
    b1 = pair("b1", dag.add(sep("b1_sep3", ch, 3), [c]), c)
    b2 = pair("b2", dag.add(sep("b2_sep3", ch, 3), [p]),
              dag.add(sep("b2_sep5", ch, 5), [c]))
    b3 = pair("b3", dag.add(avg("b3_avg"), [c]), p)
    b4 = pair("b4", dag.add(avg("b4_avgA"), [p]),
              dag.add(avg("b4_avgB"), [p]))
    b5 = pair("b5", dag.add(sep("b5_sep5", ch, 5), [p]),
              dag.add(sep("b5_sep3", ch, 3), [p]))
    return dag.add(lambda s: Identity(f"{name}_concat", s),
                   [b1, b2, b3, b4, b5], "concat")


def _add_nasnet_reduction(dag: DagModel, gen, prev: int, cur: int,
                          name: str, ch: int, adj_stride: int = 1) -> int:
    """A reduction cell (the map halved): four pairwise sums concatenated
    (4 ch channels)."""
    sep, adj, pair = _nasnet_ops(dag, gen, name)
    p = dag.add(adj("adjP", ch, adj_stride), [prev])
    c = dag.add(adj("adjC", ch), [cur])
    b1 = pair("b1", dag.add(sep("b1_sep5", ch, 5, 2), [c]),
              dag.add(sep("b1_sep7", ch, 7, 2), [p]))
    b2 = pair("b2", dag.add(lambda s: MaxPool(f"{name}_b2_max", s, 3, 2,
                                              "SAME"), [c]),
              dag.add(sep("b2_sep7", ch, 7, 2), [p]))
    b3 = pair("b3", dag.add(lambda s: AvgPool(f"{name}_b3_avg", s, 3, 2),
                            [c]),
              dag.add(sep("b3_sep5", ch, 5, 2), [p]))
    b4 = pair("b4", dag.add(lambda s: MaxPool(f"{name}_b4_max", s, 3, 2,
                                              "SAME"), [c]),
              dag.add(sep("b4_sep3", ch, 3), [b1]))
    return dag.add(lambda s: Identity(f"{name}_concat", s),
                   [b1, b2, b3, b4], "concat")


def build_nasnet(arch: str, in_shape, num_classes: int,
                 seed: int = 0) -> DagModel:
    """A NASNet-A-style mini: stem, then cells over the previous two cell
    outputs, a lagging prev adjusted by a strided 1x1 after a reduction;
    global average pool, dense."""
    stem_ch, ch, cells = _NASNET_SPECS[arch]
    gen = torch.Generator().manual_seed(seed)
    dag = DagModel(arch, tuple(in_shape), num_classes)
    small = in_shape[0] <= 64
    stem = dag.add(lambda s: ConvBN("stem", s, stem_ch, 3,
                                    1 if small else 2, gen=gen), [-1])
    prev = cur = stem
    prev_lags = False  # prev has twice cur's spatial size
    for i, kind in enumerate(cells):
        adj = 2 if prev_lags else 1
        if kind == "R":
            ch *= 2
            out = _add_nasnet_reduction(dag, gen, prev, cur, f"cell{i}", ch,
                                        adj)
        else:
            out = _add_nasnet_normal(dag, gen, prev, cur, f"cell{i}", ch,
                                     adj)
        prev_lags = kind == "R"
        prev, cur = cur, out
    cur = dag.add(lambda s: GlobalAvgPool("gap", s), [cur])
    cur = dag.add(lambda s: Flatten("flatten", s), [cur])
    dag.add(lambda s: Dense("fc", s, num_classes, gen=gen), [cur])
    return dag


BRANCHY_ARCHS = tuple(_INCEPTION_BLOCKS) + tuple(_NASNET_SPECS)


def get_dag(arch: str, in_shape, num_classes: int, seed: int = 0):
    """The DAG form of a branchy arch, None for a chain arch."""
    if arch in _INCEPTION_BLOCKS:
        return build_inception(arch, in_shape, num_classes, seed)
    if arch in _NASNET_SPECS:
        return build_nasnet(arch, in_shape, num_classes, seed)
    return None
