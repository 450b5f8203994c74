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
  first. The running statistics are buffers, never cast.
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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    runs under ``torch.utils.checkpoint`` (non-reentrant): the backward
    recomputes the layer instead of keeping its interior activations. A
    layer with BatchNorm refuses remat: the recomputation would update its
    running statistics a second time."""
    if remat and any(isinstance(m, BatchNorm) for layer in layers
                     for m in layer.modules()):
        raise NotImplementedError(
            "per-layer remat of a layer with BatchNorm is not ported: the "
            "recomputation would update the running statistics twice")
    for layer in layers:
        params = {n: p.to(compute_dtype)
                  if compute_dtype is not None and p.is_floating_point()
                  else p for n, p in layer.named_parameters()}
        if remat:
            x = checkpoint(_call, layer, params, x, use_reentrant=False)
        else:
            x = _call(layer, params, x)
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


class BatchNorm(nn.Module):
    """The reference's ``batchnorm`` (module docstring): ``scale`` and
    ``bias`` parameters, ``mean`` and ``var`` running statistics (buffers,
    float32). Train mode normalises with the batch statistics and updates
    the running ones in place; eval mode reads them."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.mean.dtype  # the weights take the statistics' type
        return F.batch_norm(x, self.mean, self.var, self.scale.to(dtype),
                            self.bias.to(dtype), self.training, BN_MOMENTUM,
                            BN_EPS)


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
