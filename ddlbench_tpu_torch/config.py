"""Typed configuration of the PyTorch serving and training paths.

The port's own copy of the pieces of ``ddlbench_tpu/config.py`` those paths
read: :class:`DatasetSpec` with the image and token workloads,
``DEFAULT_BATCH`` for the ``single`` strategy, :class:`ServeConfig` and
:class:`RunConfig` with their resolvers and validation. The field names, defaults and error
messages are the reference's, so a config built for one package means the
same thing to the other.

Features the port does not carry yet keep their fields where the reference
has them, and ``validate`` raises ``NotImplementedError`` when one is set
away from its default, so a knob is never silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


# the stream kinds beside "image": token streams (next-token LM) and
# seq2seq streams (prefix-LM with masked source labels)
STREAM_KINDS = ("tokens", "seq2seq")


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Shape/size blueprint of one benchmark dataset: ``image_size`` is
    ``(H, W, C)`` for images (the reference's NHWC order; the port's
    batches are NCHW) and ``(T,)`` for token streams, ``num_classes`` the
    classes or the vocabulary."""

    name: str
    image_size: Tuple[int, ...]
    num_classes: int
    train_size: int
    test_size: int
    kind: str = "image"  # "image" | "tokens" | "seq2seq"
    # seq2seq only: length of the source segment within the T-token stream
    # (positions < src_len are the source; loss is masked there).
    src_len: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind == "seq2seq":
            if self.src_len is None:
                raise ValueError("kind='seq2seq' requires src_len")
            if not 0 < self.src_len < self.image_size[0]:
                raise ValueError(
                    f"src_len {self.src_len} must be inside the "
                    f"{self.image_size[0]}-token stream"
                )

    @property
    def seq_len(self) -> int:
        assert self.kind in STREAM_KINDS
        return self.image_size[0]


DATASETS: Mapping[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", (28, 28, 1), 10, 60_000, 10_000),
    "cifar10": DatasetSpec("cifar10", (32, 32, 3), 10, 50_000, 10_000),
    "imagenet": DatasetSpec("imagenet", (224, 224, 3), 1000, 1_281_167,
                            50_000),
    # the reference's activation-memory stressor: 512x512x3, 1000 classes
    "highres": DatasetSpec("highres", (512, 512, 3), 1000, 50_000, 10_000),
    # a standard LM context (ddlbench_tpu/config.py "synthtext")
    "synthtext": DatasetSpec("synthtext", (1024,), 32_768, 100_000, 10_000,
                             kind="tokens"),
    # long-context stressors (one card trains them through the flash
    # kernels, whose memory does not grow with the score matrix)
    "longctx": DatasetSpec("longctx", (8192,), 32_768, 20_000, 2_000,
                           kind="tokens"),
    "longctx32k": DatasetSpec("longctx32k", (32_768,), 32_768, 5_000, 500,
                              kind="tokens"),
    # synthetic translation: the seq2seq workload (the reference's GNMT
    # analog) as a prefix-LM stream, 128 source + 128 target tokens
    "synthmt": DatasetSpec("synthmt", (256,), 32_768, 200_000, 20_000,
                           kind="seq2seq", src_len=128),
}

# "auto" = the flash kernels for CUDA tensors, the plain einsum for CPU
# tensors; "flash"/"xla" force one (models/transformer.py)
ATTENTION_BACKENDS = ("auto", "flash", "xla")

# the reference's per-strategy default batch, of "single"
DEFAULT_BATCH: Mapping[str, Mapping[str, Any]] = {
    "single": {"mnist": 128, "cifar10": 64, "imagenet": 32, "highres": 32,
               "synthtext": 16, "longctx": 2, "longctx32k": 1,
               "synthmt": 64},
}


# (field, default, what it is, the ROADMAP item it waits on) for every
# ServeConfig knob the port keeps for schema parity but does not implement
# yet
_NOT_PORTED = (
    ("tp", 1, "tensor-parallel serving (tp > 1)",
     "A.7: a replica needs tp devices"),
)


# (field, default, what it is) for every RunConfig knob of the reference's
# training loop the port keeps for schema parity but does not implement
_TRAIN_NOT_PORTED = (
    ("plan", "manual", "the --plan auto solver"),
    ("auto_partition", False, "auto-partition"),
    ("trace", None, "step-level tracing"),
    ("trace_dir", None, "profiler trace capture"),
    ("audit", None, "the compiled-program audit"),
    ("checkpoint_dir", None, "checkpoints"),
    ("resume", False, "resume from a checkpoint"),
    ("checkpoint_every_steps", None, "step-granular checkpoints"),
    ("hang_timeout_s", None, "the hang watchdog"),
    ("inject", (), "fault injection and preemption"),
    ("activation_log_dir", None, "activation logging"),
    ("warmup_epochs", 0, "gradual lr warmup (it needs a dp strategy)"),
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
    # KV-pool storage dtype: float32, bfloat16, or int8 (quantised at the
    # write boundary with a per-page scale sidecar; ops/paged_decode.py)
    kv_dtype: str = "float32"
    # the cross-request prefix cache (serve/prefix.py): admissions bind the
    # resident pages of their longest cached prompt prefix and prefill only
    # the tail. Continuous policy only.
    prefix_cache: bool = False
    # "none", or "ngram:N:K": self-drafting speculative decoding — an
    # N-gram drafter proposes up to K tokens per decode row and one
    # K+1-wide verify pass scores them; greedy acceptance keeps the token
    # streams those of plain decoding
    speculative: str = "none"
    # sampling (0.0 = greedy argmax). temperature > 0 samples from
    # softmax(logits / T) on the host with counter-based per-request
    # seeds (sample_seed, request id, token index), so streams are
    # reproducible per seed and eviction/recompute regenerates them
    temperature: float = 0.0
    top_k: int = 0  # 0 = full vocab; > 0 restricts sampling to the k best
    sample_seed: int = 0
    # request-lifecycle tracing (telemetry/tracer.py): the engine emits
    # its decisions into the process-global tracer in virtual time; token
    # streams and virtual-time numbers are the same traced or not
    trace: bool = False
    # ring of the most recent per-step engine states kept for
    # ServeEngine.snapshot(); 0 disables the ring
    flight_recorder: int = 64
    # SLOs in virtual time units (observability only; 0 = no SLO)
    slo_ttft: float = 0.0
    slo_itl: float = 0.0
    replicas: int = 1  # serving replicas (least-loaded dispatch)
    # serve-side heartbeat: a replica that holds work but makes no progress
    # for more than this many time units is drained (0 = off)
    heartbeat: float = 0.0
    # silent-data-corruption defence (serve/integrity.py): a host-side
    # crc32 ledger over every pool page's payload and sidecar rows, stamped
    # at each pool write and verified at every trust boundary (page
    # shipping, prefix-hit binds, eviction-recompute, the scrubber). A
    # mismatch quarantines the slot for the rest of the run and recovers
    # every request that references it through the re-prefill path. Off
    # (the default) keeps no ledger and makes no checks.
    integrity: bool = False
    # background scrub budget: verify up to this many stamped pages per
    # step, round-robin (0 = off; > 0 requires integrity)
    scrub: int = 0
    # knobs of the reference config the port does not implement yet:
    # validate() raises NotImplementedError when one leaves its default
    tp: int = 1

    def npg_max(self) -> int:
        return -(-self.max_len // self.page)

    def spec_params(self) -> Optional[Tuple[int, int]]:
        """(ngram_n, draft_k) when speculative decoding is on, else None.
        ``validate`` rejects malformed specs; this parses a valid one."""
        if self.speculative == "none":
            return None
        _, n, k = self.speculative.split(":")
        return int(n), int(k)

    def resolved_token_budget(self) -> int:
        if self.token_budget:
            return self.token_budget
        return self.max_batch + 2 * self.resolved_prefill_chunk()

    def resolved_prefill_chunk(self) -> int:
        if self.prefill_chunk:
            return self.prefill_chunk
        return self.npg_max() * self.page  # whole-stream padded chunk

    def validate(self) -> None:
        if self.policy not in ("continuous", "static"):
            raise ValueError(
                f"policy must be continuous|static, got {self.policy!r}")
        if min(self.max_batch, self.page, self.max_len, self.replicas,
               self.tp) < 1:
            raise ValueError(
                "max_batch, page, max_len, replicas, and tp must be "
                "positive")
        for name, default, what, item in _NOT_PORTED:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{what} ({name}={getattr(self, name)!r}) is not ported "
                    f"to the PyTorch serving path yet (ROADMAP {item})")
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
        if self.prefix_cache and self.policy != "continuous":
            raise ValueError(
                "prefix_cache requires the continuous policy — the static "
                "baseline measures cache-off scheduling (run it cache-off)")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocab), got "
                             f"{self.top_k}")
        if self.top_k and self.temperature == 0.0:
            raise ValueError(
                "top_k without temperature has no sampling to restrict "
                "(greedy already takes the argmax)")
        if self.flight_recorder < 0:
            raise ValueError(
                f"flight_recorder must be >= 0 (0 disables the ring), "
                f"got {self.flight_recorder}")
        if self.slo_ttft < 0 or self.slo_itl < 0:
            raise ValueError(
                "slo_ttft and slo_itl must be >= 0 (0 = no SLO)")
        if self.heartbeat < 0:
            raise ValueError(
                f"heartbeat must be >= 0 time units (0 disables straggler "
                f"detection), got {self.heartbeat}")
        if self.scrub < 0:
            raise ValueError(
                f"scrub must be >= 0 pages/step (0 disables the "
                f"scrubber), got {self.scrub}")
        if self.scrub and not self.integrity:
            raise ValueError(
                "scrub without integrity has no checksum ledger to "
                "verify against — enable integrity or drop scrub")
        if self.kv_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"kv_dtype must be float32|bfloat16|int8, got "
                f"{self.kv_dtype!r}")
        if self.speculative != "none":
            parts = self.speculative.split(":")
            if len(parts) != 3 or parts[0] != "ngram":
                raise ValueError(
                    f"speculative must be 'none' or 'ngram:N:K', got "
                    f"{self.speculative!r}")
            try:
                n, k = int(parts[1]), int(parts[2])
            except ValueError:
                raise ValueError(
                    f"speculative ngram wants integer N:K, got "
                    f"{self.speculative!r}") from None
            if n < 1 or k < 1:
                raise ValueError(
                    f"speculative ngram needs N >= 1 and K >= 1, got "
                    f"N={n} K={k}")
            if self.temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (acceptance "
                    "compares draft tokens against greedy argmax); drop "
                    "temperature or speculative")
            if k + 1 > self.max_len:
                raise ValueError(
                    f"speculative draft width K+1 ({k + 1}) exceeds "
                    f"max_len {self.max_len}")

    def replace(self, **kw: Any) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One training run = dataset x strategy x model, with the fields the
    port's training loop reads (the reference's names and defaults).

    ``fused_head_loss`` (the default, as in the reference) trains the token
    workloads through the fused projection + cross-entropy head
    (ops/fused_xent.py), which never materialises the [B*T, V] logits;
    False takes the full logits; image models have no fused head.
    ``benchmark`` and ``arch`` default to the token path's ``synthtext`` /
    ``transformer_s``; the reference's defaults, ``mnist`` / ``resnet18``,
    are the CLI's (cli.py).
    """

    benchmark: str = "synthtext"
    strategy: str = "single"
    arch: str = "transformer_s"
    # the training protocol (the reference's EPOCHS=3, LOGINTER=25)
    epochs: int = 3
    log_interval: int = 25
    batch_size: Optional[int] = None
    steps_per_epoch: Optional[int] = None
    # None = per-workload default (resolved_*): sgd everywhere but seq2seq
    # (adam); lr 0.1, momentum 0.9 and weight decay 1e-4 on imagenet and
    # highres, else lr 0.01, momentum 0.5, no weight decay
    optimizer: Optional[str] = None  # sgd | adam
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    lr: Optional[float] = None
    momentum: Optional[float] = None
    weight_decay: Optional[float] = None
    # step decay: lr x gamma every lr_step_epochs epochs
    lr_step_epochs: int = 30
    lr_step_gamma: float = 0.1
    # Goyal-et-al gradual warmup epochs: the ramp undoes a data-parallel
    # world's lr scaling, so it waits for a dp strategy (validate() refuses
    # it until then)
    warmup_epochs: int = 0
    # MoE (transformer_moe_* archs): the router load-balance loss weight
    # and the static capacity ceil(cf * tokens / experts) an expert
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    label_smoothing: Optional[float] = None
    compute_dtype: str = "bfloat16"
    attention_backend: str = "auto"  # auto | flash | xla
    # fused projection+loss head (ops/fused_xent.py); applies to models
    # whose head supports it (the token/seq2seq workloads)
    fused_head_loss: bool = True
    # the reference's schema: its training reads param_dtype nowhere, and
    # remat_stages only in the pipeline strategies; validate() refuses any
    # other value than these defaults, which is what the port does
    param_dtype: str = "float32"
    remat_stages: bool = True
    # torch.utils.checkpoint per layer: the backward recomputes each layer
    # (token models only: the recomputation would update BatchNorm's
    # running statistics a second time, and an MoE block's aux loss)
    remat_layers: bool = False
    seed: int = 1
    # gradient accumulation: each update averages K micro-steps of
    # batch_size rows (every K-th row of the step's batch; the global batch
    # is batch_size x K)
    grad_accum_steps: int = 1
    # False = on-disk data (-s): a text corpus (train.txt) or a parallel
    # corpus (train.src/train.tgt) under data_dir for a token or seq2seq
    # benchmark, else a store or a recognised image layout there
    # ("./data" when None), else a synthetic store generated there
    # (train/loop.make_data)
    synthetic: bool = True
    data_dir: Optional[str] = None
    # the on-disk path's training augmentation (crop/flip per dataset)
    augment: bool = True
    # batches prepared ahead of the step by a producer thread
    # (data/prefetch.py); 0 = made inline (--no-prefetch)
    prefetch_depth: int = 2
    # the stability guard (not ported; validate() refuses both)
    anomaly_policy: Optional[str] = None
    loss_scale: Optional[Any] = None
    # knobs of the reference's training loop the port does not implement
    # yet: validate() raises NotImplementedError when one leaves its default
    plan: str = "manual"
    auto_partition: bool = False
    trace: Optional[str] = None
    trace_dir: Optional[str] = None
    audit: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    checkpoint_every_steps: Optional[int] = None
    hang_timeout_s: Optional[float] = None
    inject: Tuple[str, ...] = ()
    activation_log_dir: Optional[str] = None

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
        if self.dataset().kind in STREAM_KINDS:
            return 0.01
        return 0.1 if self.benchmark in ("imagenet", "highres") else 0.01

    def resolved_label_smoothing(self) -> float:
        if self.label_smoothing is not None:
            return self.label_smoothing
        return 0.1 if self.dataset().kind == "seq2seq" else 0.0

    def resolved_momentum(self) -> float:
        if self.momentum is not None:
            return self.momentum
        return 0.9 if self.benchmark in ("imagenet", "highres") else 0.5

    def resolved_weight_decay(self) -> float:
        if self.weight_decay is not None:
            return self.weight_decay
        return 1e-4 if self.benchmark in ("imagenet", "highres") else 0.0

    def global_batch(self) -> int:
        """The step's batch: ``single`` runs batch_size (or the reference's
        default for the benchmark) rows per micro-step, grad_accum_steps
        micro-steps per step."""
        b = self.batch_size or DEFAULT_BATCH["single"][self.benchmark]
        return int(b) * self.grad_accum_steps

    def validate(self) -> None:
        if self.benchmark not in DATASETS:
            raise ValueError(f"unknown benchmark {self.benchmark!r}")
        if self.strategy != "single":
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported to the PyTorch "
                "training path yet (only 'single')")
        for name, default, what in _TRAIN_NOT_PORTED:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{what} ({name}={getattr(self, name)!r}) is not ported "
                    "to the PyTorch training path yet")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0 (0 = synchronous)")
        if self.anomaly_policy is not None or self.loss_scale is not None:
            raise NotImplementedError(
                "the stability guard (anomaly_policy / loss_scale) is not "
                "ported to the PyTorch training path yet")
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: parameters are float32 "
                "(the reference's training reads param_dtype nowhere)")
        if not self.remat_stages:
            raise NotImplementedError(
                "remat_stages=False acts on the pipeline strategies, which "
                "are not ported to the PyTorch training path yet "
                "(ROADMAP A.7)")
        if self.remat_layers and "moe" in self.arch:
            raise ValueError(
                "remat_layers is incompatible with MoE archs (a "
                "checkpointed forward would record each router's aux loss "
                "twice)")
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
        if self.epochs < 1 or self.log_interval < 1:
            raise ValueError("epochs and log_interval must be >= 1")
        if self.lr_step_epochs < 1:
            raise ValueError("lr_step_epochs must be >= 1")
        if self.remat_layers and self.dataset().kind == "image":
            raise NotImplementedError(
                "per-layer remat (remat_layers) of the image models is not "
                "ported: torch.utils.checkpoint's recomputation would "
                "update BatchNorm's running statistics a second time")
