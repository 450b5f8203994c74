"""Typed configuration of the PyTorch serving and token-training paths.

The port's own copy of the pieces of ``ddlbench_tpu/config.py`` those paths
read: :class:`DatasetSpec` with the token workloads, ``DEFAULT_BATCH`` for
the ``single`` strategy, :class:`ServeConfig` and :class:`RunConfig` with
their resolvers and validation. The field names, defaults and error
messages are the reference's, so a config built for one package means the
same thing to the other (one deliberate divergence: ``fused_head_loss``,
see :class:`RunConfig`).

Features the port does not carry yet keep their fields where the reference
has them, and ``validate`` raises ``NotImplementedError`` when one is set
away from its default, so a knob is never silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Shape/size blueprint of one benchmark dataset (tokens only here:
    ``image_size`` is ``(T,)``, ``num_classes`` the vocabulary)."""

    name: str
    image_size: Tuple[int, ...]
    num_classes: int
    train_size: int
    test_size: int
    kind: str = "image"

    @property
    def seq_len(self) -> int:
        assert self.kind == "tokens"
        return self.image_size[0]


DATASETS: Mapping[str, DatasetSpec] = {
    # a standard LM context (ddlbench_tpu/config.py "synthtext")
    "synthtext": DatasetSpec("synthtext", (1024,), 32_768, 100_000, 10_000,
                             kind="tokens"),
    # long-context stressors (one card trains them through the flash
    # kernels, whose memory does not grow with the score matrix)
    "longctx": DatasetSpec("longctx", (8192,), 32_768, 20_000, 2_000,
                           kind="tokens"),
    "longctx32k": DatasetSpec("longctx32k", (32_768,), 32_768, 5_000, 500,
                              kind="tokens"),
}

# "auto" = the flash kernels for CUDA tensors, the plain einsum for CPU
# tensors; "flash"/"xla" force one (models/transformer.py)
ATTENTION_BACKENDS = ("auto", "flash", "xla")

# the reference's per-strategy default batch, token workloads of "single"
DEFAULT_BATCH: Mapping[str, Mapping[str, Any]] = {
    "single": {"synthtext": 16, "longctx": 2, "longctx32k": 1},
}


# (field, default, what it is) for every ServeConfig knob the port keeps
# for schema parity but does not implement yet
_NOT_PORTED = (
    ("tp", 1, "tensor-parallel serving (tp > 1)"),
    ("replicas", 1, "multi-replica serving (replicas > 1)"),
    ("prefix_cache", False, "the cross-request prefix cache"),
    ("temperature", 0.0, "sampling (temperature > 0)"),
    ("top_k", 0, "top-k sampling"),
    ("trace", False, "request-lifecycle tracing"),
    ("heartbeat", 0.0, "the straggler heartbeat"),
    ("integrity", False, "the SDC checksum ledger"),
    ("scrub", 0, "the SDC scrubber"),
    ("speculative", "none", "speculative verify"),
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Shape/policy configuration of the continuous-batching engine
    (serve/engine.py). Every decode step is a [max_batch, 1] model call and
    every prefill chunk a [1, prefill_chunk] call."""

    max_batch: int = 8  # engine rows = concurrent requests per replica
    pool_pages: int = 64  # shared KV pool slots (slot 0 = scratch)
    page: int = 16  # positions per page
    max_len: int = 256  # per-request stream capacity (prompt + output)
    # tokens a step may process: active decode rows count 1 each, the
    # remainder is packed with prefill chunks. 0 = max_batch + 2 chunks.
    token_budget: int = 0
    # tokens per prefill call (page multiple); 0 = whole prompt in ONE
    # padded call ("unchunked admission")
    prefill_chunk: int = 16
    policy: str = "continuous"  # "continuous" | "static" (the A/B baseline)
    # KV-pool storage dtype: float32 or bfloat16 ("int8" is not ported yet)
    kv_dtype: str = "float32"
    # SLOs in virtual time units (observability only; 0 = no SLO)
    slo_ttft: float = 0.0
    slo_itl: float = 0.0
    # knobs of the reference config the port does not implement yet:
    # validate() raises NotImplementedError when one leaves its default
    replicas: int = 1
    tp: int = 1
    prefix_cache: bool = False
    temperature: float = 0.0
    top_k: int = 0
    sample_seed: int = 0
    trace: bool = False
    heartbeat: float = 0.0
    integrity: bool = False
    scrub: int = 0
    speculative: str = "none"

    def npg_max(self) -> int:
        return -(-self.max_len // self.page)

    def resolved_token_budget(self) -> int:
        if self.token_budget:
            return self.token_budget
        return self.max_batch + 2 * self.resolved_prefill_chunk()

    def resolved_prefill_chunk(self) -> int:
        if self.prefill_chunk:
            return self.prefill_chunk
        return self.npg_max() * self.page  # whole-stream padded chunk

    def validate(self) -> None:
        for name, default, what in _NOT_PORTED:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{what} ({name}={getattr(self, name)!r}) is not ported "
                    "to the PyTorch serving path yet")
        if self.kv_dtype == "int8":
            raise NotImplementedError(
                "the int8 KV pool (kv_dtype='int8') is not ported to the "
                "PyTorch serving path yet")
        if self.policy not in ("continuous", "static"):
            raise ValueError(
                f"policy must be continuous|static, got {self.policy!r}")
        if min(self.max_batch, self.page, self.max_len) < 1:
            raise ValueError("max_batch, page, and max_len must be positive")
        if self.prefill_chunk < 0 or self.token_budget < 0:
            raise ValueError(
                "prefill_chunk and token_budget must be >= 0")
        if self.prefill_chunk and self.prefill_chunk % self.page:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                f"the page size {self.page} (chunks are page-aligned)")
        if self.pool_pages < self.npg_max() + 1:
            raise ValueError(
                f"pool_pages {self.pool_pages} cannot hold one max-length "
                f"request ({self.npg_max()} pages) plus the scratch slot — "
                "a request that can never fit would evict itself forever")
        if self.resolved_token_budget() < self.resolved_prefill_chunk():
            raise ValueError(
                "token_budget below one prefill chunk starves admission "
                f"({self.resolved_token_budget()} < "
                f"{self.resolved_prefill_chunk()})")
        if self.slo_ttft < 0 or self.slo_itl < 0:
            raise ValueError(
                "slo_ttft and slo_itl must be >= 0 (0 = no SLO)")
        if self.kv_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"kv_dtype must be float32|bfloat16|int8, got "
                f"{self.kv_dtype!r}")

    def replace(self, **kw: Any) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One training run = dataset x strategy x model, with the fields the
    port's token-training path reads (the reference's names and defaults).

    Deliberate divergence: ``fused_head_loss`` defaults to False here (True
    in the reference). The fused LM-head loss runs the Pallas kernels B4-B6
    (``ops/fused_xent.py``), which are not ported yet; until they are, the
    port trains through the materialised logits, and ``validate`` refuses
    True. ``benchmark`` and ``arch`` default to the token path's
    ``synthtext`` / ``transformer_s`` (the reference's mnist / resnet18 are
    not ported).
    """

    benchmark: str = "synthtext"
    strategy: str = "single"
    arch: str = "transformer_s"
    batch_size: Optional[int] = None
    steps_per_epoch: Optional[int] = None
    # None = per-workload default (resolved_*): sgd, lr 0.01, momentum 0.5,
    # weight decay 0 for the token workloads
    optimizer: Optional[str] = None  # sgd | adam
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    lr: Optional[float] = None
    momentum: Optional[float] = None
    weight_decay: Optional[float] = None
    label_smoothing: Optional[float] = None
    compute_dtype: str = "bfloat16"
    attention_backend: str = "auto"  # auto | flash | xla
    fused_head_loss: bool = False  # the reference's default is True
    # torch.utils.checkpoint per layer: the backward recomputes each layer
    remat_layers: bool = False
    seed: int = 1
    grad_accum_steps: int = 1
    # the stability guard (not ported; validate() refuses both)
    anomaly_policy: Optional[str] = None
    loss_scale: Optional[Any] = None

    def dataset(self) -> DatasetSpec:
        return DATASETS[self.benchmark]

    def resolved_optimizer(self) -> str:
        if self.optimizer is not None:
            return self.optimizer
        return "adam" if self.dataset().kind == "seq2seq" else "sgd"

    def resolved_lr(self) -> float:
        if self.lr is not None:
            return self.lr
        if self.resolved_optimizer() == "adam":
            return 1e-3
        return 0.01  # the reference's token-workload default

    def resolved_label_smoothing(self) -> float:
        if self.label_smoothing is not None:
            return self.label_smoothing
        return 0.1 if self.dataset().kind == "seq2seq" else 0.0

    def resolved_momentum(self) -> float:
        if self.momentum is not None:
            return self.momentum
        return 0.5  # the reference's default outside imagenet/highres

    def resolved_weight_decay(self) -> float:
        if self.weight_decay is not None:
            return self.weight_decay
        return 0.0  # the reference's default outside imagenet/highres

    def global_batch(self) -> int:
        """The step's batch: ``single`` runs one batch of batch_size (or
        the reference's default for the benchmark) per step."""
        return int(self.batch_size or DEFAULT_BATCH["single"][self.benchmark])

    def validate(self) -> None:
        if self.benchmark not in DATASETS:
            raise ValueError(f"unknown benchmark {self.benchmark!r}")
        if self.strategy != "single":
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported to the PyTorch "
                "training path yet (only 'single')")
        if self.grad_accum_steps > 1:
            raise NotImplementedError(
                "gradient accumulation (grad_accum_steps > 1) is not ported "
                "to the PyTorch training path yet")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.anomaly_policy is not None or self.loss_scale is not None:
            raise NotImplementedError(
                "the stability guard (anomaly_policy / loss_scale) is not "
                "ported to the PyTorch training path yet")
        if "moe" in self.arch:
            raise NotImplementedError(
                f"MoE arch {self.arch!r} is not ported to the PyTorch "
                "training path yet")
        if self.fused_head_loss:
            raise NotImplementedError(
                "fused_head_loss=True runs the fused LM-head kernels B4-B6 "
                "(ops/fused_xent.py), which are not ported yet; train with "
                "fused_head_loss=False (the materialised logits)")
        if self.attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"unknown attention_backend {self.attention_backend!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got "
                f"{self.compute_dtype!r}")
        if self.optimizer is not None and self.optimizer not in ("sgd",
                                                                 "adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if (self.label_smoothing is not None
                and not 0.0 <= self.label_smoothing < 1.0):
            raise ValueError("label_smoothing must be in [0, 1)")
        if self.dataset().kind != "tokens":
            raise ValueError(f"{self.benchmark} is not a token workload")
