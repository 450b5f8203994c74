"""Typed configuration of the PyTorch serving and training paths.

The port's own copy of the pieces of ``ddlbench_tpu/config.py`` those paths
read: :class:`DatasetSpec` with the image and token workloads,
``DEFAULT_BATCH`` for the ``single``, ``dp``, ``gpipe``, ``pipedream``,
``sp`` and ``ep`` strategies (``fsdp`` reads ``dp``'s),
:class:`ServeConfig` and :class:`RunConfig` with their resolvers and
validation. The field names, defaults and error
messages are the reference's, so a config built for one package means the
same thing to the other.

Features the port does not carry yet keep their fields where the reference
has them, and ``validate`` raises ``NotImplementedError`` when one is set
away from its default, so a knob is never silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from ddlbench_tpu_torch.partition.schedule import (PIPE_SCHEDULES,
                                                   normalize_costs)


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

# the reference's per-strategy default batch: for "single" and "dp" per
# device (a dp step takes num_devices x this many rows); for "gpipe" the
# (micro_batch_size, num_microbatches) pair, the global batch their
# product; for "pipedream" the global batch
DEFAULT_BATCH: Mapping[str, Mapping[str, Any]] = {
    "single": {"mnist": 128, "cifar10": 64, "imagenet": 32, "highres": 32,
               "synthtext": 16, "longctx": 2, "longctx32k": 1,
               "synthmt": 64},
    "dp": {"mnist": 128, "cifar10": 64, "imagenet": 32, "highres": 32,
           "synthtext": 16, "longctx": 2, "longctx32k": 1, "synthmt": 64},
    "gpipe": {
        "mnist": (128, 24),
        "cifar10": (64, 32),
        "imagenet": (24, 12),
        "highres": (4, 12),
        "synthtext": (4, 8),
        "longctx": (1, 8),
        "longctx32k": (1, 4),
        "synthmt": (16, 8),
    },
    "pipedream": {"mnist": 512, "cifar10": 256, "imagenet": 128,
                  "highres": 64, "synthtext": 64, "longctx": 8,
                  "longctx32k": 4, "synthmt": 128},
    "sp": {"mnist": 128, "cifar10": 64, "imagenet": 32, "highres": 32,
           "synthtext": 16, "longctx": 2, "longctx32k": 1, "synthmt": 32},
    # ep: per-device batch (batch and experts both shard the one rank axis)
    "ep": {"synthtext": 8, "longctx": 1, "longctx32k": 1},
}

# the reference's strategies, every one of which the port runs
STRATEGIES = ("single", "dp", "gpipe", "pipedream", "sp", "ep", "fsdp",
              "tp")
PIPELINE_STRATEGIES = ("gpipe", "pipedream")
# the strategies whose ranks are processes of a group (distributed.spawn);
# a gpipe with tp_size > 1 spawns one rank per shard too, and a uniform
# hybrid pipeline one a replica (RunConfig.spawned_ranks)
RANK_STRATEGIES = ("dp", "sp", "ep", "fsdp", "tp")
# the one-apply strategies that accumulate gradients and take remat_layers
ONE_APPLY_STRATEGIES = ("single", "dp", "tp", "fsdp")

# the canonical names of the dp gradient wire dtypes (allreduce_dtype)
_WIRE_DTYPES = {"f32": "float32", "float32": "float32",
                "bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8"}


# (field, default, what it is, the ROADMAP item it waits on) for every
# pipeline knob of the reference the port keeps for schema parity but does
# not implement yet
_PIPE_NOT_PORTED = (
    ("schedule_trace", None,
     "measured-bubble schedule advice (schedule_trace)",
     "A.8, traces group: it reads an earlier run's --trace JSON through "
     "telemetry/bubble.py"),
)


# (field, default, what it is) for every RunConfig knob of the reference's
# training loop the port keeps for schema parity but does not implement
_TRAIN_NOT_PORTED = (
    ("trace", None, "step-level tracing"),
    ("trace_dir", None, "profiler trace capture"),
    ("audit", None, "the compiled-program audit"),
    ("hang_timeout_s", None, "the hang watchdog"),
    ("inject", (), "fault injection and preemption"),
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
    # tensor-parallel width of ONE replica (serve/engine.py: Megatron
    # shards sharing one page table)
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
class HardwareModel:
    """Bandwidth/memory constants feeding the partitioner's and the
    planner's cost models (partition/optimizer.py, partition/planner.py),
    under the reference's field names so a test can pass its values by
    name.

    The defaults are datasheet values of one NVIDIA H100 SXM5 80GB
    (700 W), not measurements:

    * ``ici_bandwidth``: NVLink 4, 900 GB/s bidirectional per GPU, so
      450 GB/s each way (the level inside one host, the reference's ICI);
    * ``dcn_bandwidth``: the node's network, one 400 Gb/s NDR InfiniBand
      port per GPU as in a DGX H100 (50 GB/s; the level across hosts);
    * ``hbm_bytes``: 80 GB of HBM3;
    * ``peak_flops``: dense bfloat16 tensor-core peak, 989 TFLOP/s;
    * ``hbm_bandwidth``: 3.35 TB/s.
    """

    ici_bandwidth: float = 4.5e11
    dcn_bandwidth: float = 5.0e10
    hbm_bytes: float = 80e9
    peak_flops: float = 9.89e14
    hbm_bandwidth: float = 3.35e12

    def levels(self, num_hosts: int, chips_per_host: int):
        """Hierarchical (bandwidth, machines-per-group) levels, fastest
        first: NVLink inside a host, then the network across hosts (the
        reference's ICI then DCN)."""
        levels = [(self.ici_bandwidth, chips_per_host)]
        if num_hosts > 1:
            levels.append((self.dcn_bandwidth, num_hosts))
        return levels


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
    strategy: str = "single"  # single | dp | gpipe | pipedream
    arch: str = "transformer_s"
    # ranks of a dp run, stages of a pipeline (the reference's chips: gpus
    # x nodes)
    num_devices: int = 1
    # hosts the devices span (the partitioner's second level); > 1 is the
    # multi-node launch, which validate() refuses
    num_hosts: int = 1
    # the training protocol (the reference's EPOCHS=3, LOGINTER=25)
    epochs: int = 3
    log_interval: int = 25
    # per device for single/dp; the global batch for pipedream
    batch_size: Optional[int] = None
    micro_batch_size: Optional[int] = None  # gpipe/pipedream microbatch
    num_microbatches: Optional[int] = None
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
    # Goyal-et-al gradual warmup: over this many leading epochs the lr
    # ramps per step from base to base x world (train/loop.py); it undoes
    # exactly dp's world scaling, so it is the identity elsewhere
    warmup_epochs: int = 0
    # Horovod parity: under dp with SGD the lr is scaled by the world size
    # and by grad_accum_steps (train/loop.py)
    scale_lr_by_world: bool = True
    # dp (parallel/dp.py). shard_opt_state: the optimizer state sliced per
    # leaf over the ranks, the updated slices all-gathered (params stay
    # replicated). dp_shard_update: the explicit sharded update (ZeRO-1):
    # the packed flat gradient reduce-scatters, each rank updates a
    # 1/world slice of the flat params and optimizer state, the slices
    # all-gather back. allreduce_dtype: the gradient wire dtype (f32,
    # bf16, int8: global-absmax scaling and stochastic rounding).
    # comm_buckets: K layer-aligned buckets, one collective each; with
    # dp_shard_update the params stay sharded between steps and each
    # bucket is all-gathered before the forward (the overlapped engine)
    shard_opt_state: bool = False
    dp_shard_update: bool = False
    allreduce_dtype: str = "float32"
    comm_buckets: int = 1
    # Pipelines (parallel/gpipe.py, pipeline_rt.py, pipedream.py): stages
    # (num_devices // dp_replicas by default), model chunks per stage
    # (the interleaved layout: chunk c = v*S + s on stage s; needs
    # num_microbatches % stages == 0 above 1), the gpipe schedule
    # (fill-drain, or an event schedule of the timetable runtime:
    # 1f1b, interleaved, zero-bubble, zero-bubble-h2 with zb_h2_stash
    # extra in-flight microbatches, searched with its budget and seed),
    # PipeDream's macrobatch (update_interval microbatches' gradients
    # averaged per update) and explicit per-chunk stage bounds
    # (plan_bounds: stages x virtual_stages + 1 layer indices from 0).
    # dp_replicas: hybrid PP x DP, that many replicas of every stage, one
    # rank each (parallel/gpipe.py; with dp_shard_update on gpipe the
    # rows and optimizer state stay 1/dp a rank: hybrid PP x ZeRO-1);
    # stage_replication: replicas per stage, uniform (the hybrid at
    # micro_batch_size // r) or uneven (parallel/hetero.py). tp_size > 1
    # is tpp (parallel/tpp.py). pipe_costs "profile": the event
    # schedules' timetables weighted by per-chunk cost vectors
    # (pipe_cost_vectors, half-ticks) that auto-partition sums from its
    # profile over the chosen bounds. schedule_trace is the reference's
    # too; validate() refuses it away from its default
    num_stages: Optional[int] = None
    dp_replicas: int = 1
    stage_replication: Optional[Tuple[int, ...]] = None
    virtual_stages: int = 1
    pipe_schedule: str = "fill-drain"
    zb_h2_stash: int = 1
    sched_search_budget: int = 256
    sched_search_seed: int = 0
    pipe_costs: str = "unit"
    pipe_cost_vectors: Optional[Tuple[Tuple[int, ...], Tuple[int, ...],
                                      Tuple[int, ...]]] = None
    schedule_trace: Optional[str] = None
    tp_size: int = 1
    update_interval: int = 1
    plan_bounds: Optional[Tuple[int, ...]] = None
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
    # the reference's schema: its training reads param_dtype nowhere;
    # validate() refuses any other value than float32
    param_dtype: str = "float32"
    # gpipe: recompute each (microbatch, chunk) from its stashed input in
    # the backward (torchgpipe's checkpointing); False keeps the graphs.
    # The event schedules and pipedream always recompute, as the
    # reference's do
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
    # profile -> partition -> plan (profiler/profile.py,
    # partition/optimizer.py, partition/planner.py): auto_partition
    # profiles the model and runs the hierarchical partitioner's stage
    # bounds and replication (gpipe, pipedream); profile_mode "flops"
    # counts each layer's FLOPs over hardware.peak_flops, "time" times it
    # on the device; plan "auto" solves the dp/pp/tp mix, the split and
    # the schedule and rewrites this config onto the winner
    # (planner.resolve_auto_plan)
    auto_partition: bool = False
    profile_mode: str = "flops"
    plan: str = "manual"
    hardware: HardwareModel = dataclasses.field(
        default_factory=HardwareModel)
    # activation/gradient logging (profiler/actlog.py): every
    # activation_log_freq epochs the first activation_log_steps steps'
    # per-layer activations and loss gradients as npz files here
    activation_log_dir: Optional[str] = None
    activation_log_freq: int = 1
    activation_log_steps: int = 1
    # checkpoints (train/checkpoint.py): a commit per epoch under
    # checkpoint_dir, and every checkpoint_every_steps steps; resume from
    # the newest valid one; keep only the newest keep_checkpoints
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    checkpoint_every_steps: Optional[int] = None
    keep_checkpoints: Optional[int] = None
    # topology-portable resume (train/reshard.py): a checkpoint saved at
    # another world is resharded instead of refused
    elastic_resume: bool = False
    # dp ZeRO-1's world-invariant reduction over E slices of the global
    # batch (parallel/dp.py), so a resharded run replays bitwise
    elastic_slices: Optional[int] = None
    # knobs of the reference's training loop the port does not implement
    # yet: validate() raises NotImplementedError when one leaves its default
    trace: Optional[str] = None
    trace_dir: Optional[str] = None
    audit: Optional[str] = None
    hang_timeout_s: Optional[float] = None
    inject: Tuple[str, ...] = ()

    def dataset(self) -> DatasetSpec:
        return DATASETS[self.benchmark]

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)

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

    def resolved_allreduce_dtype(self) -> str:
        """Canonical allreduce_dtype: 'float32', 'bfloat16', or 'int8'."""
        try:
            return _WIRE_DTYPES[self.allreduce_dtype]
        except KeyError:
            raise ValueError(
                f"unknown allreduce_dtype {self.allreduce_dtype!r} "
                f"(choose f32/float32, bf16/bfloat16, or int8)") from None

    def dp_explicit_collectives(self) -> bool:
        """True when dp runs the explicit collective engine (sharded
        update, a narrowed wire, or bucketed collectives) rather than the
        reference's GSPMD one; in the port both are parallel/dp.py's one
        engine, and this says which knobs its validation gates apply
        to."""
        return self.strategy == "dp" and (
            self.dp_shard_update
            or self.comm_buckets > 1
            or self.resolved_allreduce_dtype() != "float32")

    def dp_overlap_engine(self) -> bool:
        """True when dp keeps the params sharded between steps and
        all-gathers each bucket before the forward: the sharded update
        with more than one bucket."""
        return (self.dp_explicit_collectives() and self.dp_shard_update
                and self.comm_buckets > 1)

    def pipe_shard_engine(self) -> bool:
        """True when the gpipe-family runtime composes with the ZeRO-1
        shard axis (hybrid PP x ZeRO-1: --dp-shard-update on -f gpipe):
        each chunk's packed parameter row and its optimizer state stay
        device-major and 1/dp_replicas a rank between steps, each bucket
        is all-gathered before the chunk's first forward and
        reduce-scattered after the backward, and one sharded update runs
        a step (parallel/gpipe.py)."""
        return self.strategy == "gpipe" and self.dp_shard_update

    def resolved_stages(self) -> int:
        """The pipeline's stages: num_stages, else num_devices //
        (dp_replicas x tp_size)."""
        if self.stage_replication:
            return len(self.stage_replication)
        if self.num_stages is not None:
            return self.num_stages
        return max(1, self.num_devices
                   // (max(1, self.dp_replicas) * max(1, self.tp_size)))

    def resolved_batches(self) -> Tuple[int, int]:
        """(micro_batch_size, num_microbatches): for the one-apply
        strategies the per-device batch (the strategy's DEFAULT_BATCH row,
        dp's for fsdp) and 1; the reference's rules for gpipe and
        pipedream."""
        if self.strategy not in PIPELINE_STRATEGIES:
            key = self.strategy if self.strategy in DEFAULT_BATCH else "dp"
            b = self.batch_size or DEFAULT_BATCH[key][self.benchmark]
            return int(b), 1
        if self.strategy == "gpipe":
            if self.micro_batch_size and self.num_microbatches:
                # fully explicit grammar: the default matrix is not
                # consulted (benchmarks outside it work with both flags)
                return int(self.micro_batch_size), int(self.num_microbatches)
            mb, chunks = DEFAULT_BATCH["gpipe"][self.benchmark]
            mb = self.micro_batch_size or mb
            if self.num_microbatches:
                chunks = self.num_microbatches
            elif self.batch_size:
                # interpret batch_size as the effective global batch
                chunks = max(1, self.batch_size // mb)
            return int(mb), int(chunks)
        # pipedream: global batch split into microbatches of micro_batch_size.
        global_b = (self.batch_size
                    or DEFAULT_BATCH["pipedream"][self.benchmark])
        mb = self.micro_batch_size or max(
            1, global_b // (2 * self.resolved_stages()))
        chunks = self.num_microbatches or max(1, global_b // mb)
        return int(mb), int(chunks)

    def spawned_ranks(self) -> int:
        """How many rank processes the run spawns (distributed.spawn):
        ``num_devices`` for the rank strategies, ``tp_size`` x
        ``dp_replicas`` for a gpipe with tp_size > 1 (one process a
        shard of a replica, each walking every stage: parallel/tpp.py),
        the replica count of a uniform hybrid
        pipeline (``dp_replicas``, or a uniform ``stage_replication``'s
        factor: one process a replica, each walking its own stages), 0
        for the strategies that run in one process (an uneven
        ``stage_replication`` among them: parallel/hetero.py)."""
        if self.strategy in RANK_STRATEGIES:
            return self.num_devices
        if self.strategy == "gpipe" and self.tp_size > 1:
            return self.tp_size * max(1, self.dp_replicas)
        if self.strategy in PIPELINE_STRATEGIES:
            repl = tuple(self.stage_replication or ())
            if repl and len(set(repl)) == 1 and repl[0] > 1:
                return repl[0]
            if not repl and self.dp_replicas > 1:
                return self.dp_replicas
        return 0

    def global_batch(self) -> int:
        """The step's batch (the reference's rule): batch_size (or the
        default for the benchmark) rows per micro-step and device,
        grad_accum_steps micro-steps per step on single/dp/fsdp; ``dp``,
        ``fsdp`` and ``ep`` take num_devices devices' rows, ``sp`` shards
        the sequence, not the batch; a pipeline's is micro_batch_size x
        num_microbatches x dp_replicas, or with stage_replication
        micro_batch_size x num_microbatches (the replicas split each
        microbatch's rows)."""
        mb, chunks = self.resolved_batches()
        if self.strategy in PIPELINE_STRATEGIES:
            if self.stage_replication:
                return mb * chunks
            return mb * chunks * max(1, self.dp_replicas)
        accum = (self.grad_accum_steps
                 if self.strategy in ONE_APPLY_STRATEGIES else 1)
        devices = (self.num_devices if self.strategy in ("dp", "fsdp", "ep")
                   else 1)
        return mb * devices * accum

    def validate(self) -> None:
        if self.benchmark not in DATASETS:
            raise ValueError(f"unknown benchmark {self.benchmark!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "single" and self.num_devices != 1:
            raise ValueError("single strategy uses exactly 1 device")
        if self.num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        if self.warmup_epochs < 0:
            raise ValueError("warmup_epochs must be >= 0")
        if self.num_hosts != 1:
            raise NotImplementedError(
                f"num_hosts={self.num_hosts}: the multi-node launch is not "
                "ported to the PyTorch training path yet (ROADMAP A.8); "
                "the partitioner's two-level DP is "
                "(partition/optimizer.partition_hierarchical)")
        if self.profile_mode not in ("flops", "time"):
            raise ValueError(f"unknown profile mode {self.profile_mode!r}")
        if self.activation_log_freq < 1 or self.activation_log_steps < 1:
            raise ValueError(
                "activation_log_freq and activation_log_steps must be >= 1")
        self._validate_dp()
        self._validate_sharded()
        self._validate_checkpoints()
        for name, default, what in _TRAIN_NOT_PORTED:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{what} ({name}={getattr(self, name)!r}) is not ported "
                    "to the PyTorch training path yet (ROADMAP A.8)")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0 (0 = synchronous)")
        if self.anomaly_policy is not None or self.loss_scale is not None:
            raise NotImplementedError(
                "the stability guard (anomaly_policy / loss_scale) is not "
                "ported to the PyTorch training path yet (ROADMAP A.8)")
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: parameters are float32 "
                "(the reference's training reads param_dtype nowhere)")
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
        self._validate_pipeline()
        if self.lr_step_epochs < 1:
            raise ValueError("lr_step_epochs must be >= 1")

    def _validate_checkpoints(self) -> None:
        """The reference's checkpoint and elastic gates, worded as it
        words them."""
        if self.checkpoint_every_steps is not None:
            if self.checkpoint_every_steps < 1:
                raise ValueError("checkpoint_every_steps must be >= 1")
            if self.checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every_steps needs --checkpoint-dir for the "
                    "checkpoint location")
        if self.keep_checkpoints is not None and self.keep_checkpoints < 1:
            raise ValueError(
                "keep_checkpoints must be >= 1 (the newest checkpoint is "
                "never dropped)")
        if self.elastic_resume and self.checkpoint_dir is None:
            raise ValueError(
                "elastic_resume resharding needs --checkpoint-dir (there "
                "is no checkpoint to reshard without one)")
        if self.elastic_slices is None:
            return
        E = self.elastic_slices
        if E < 1 or (E & (E - 1)):
            raise ValueError(
                f"elastic_slices must be a positive power of two (the "
                f"canonical balanced reduction tree over E leaves must "
                f"decompose at any world cut); got {E}")
        if self.strategy != "dp" or not self.dp_shard_update:
            raise ValueError(
                "elastic_slices (world-invariant reduction order) runs "
                "on the dp ZeRO-1 engine (-f dp --dp-shard-update)")
        w = self.num_devices
        if w & (w - 1) or E % w:
            raise ValueError(
                f"elastic_slices ({E}) needs a power-of-two device "
                f"count dividing it (got {w}): device boundaries must "
                f"align with subtrees of the canonical reduction tree")
        if self.global_batch() % E:
            raise ValueError(
                f"global batch ({self.global_batch()}) must divide "
                f"into elastic_slices ({E}) equal slices")
        if self.grad_accum_steps > 1:
            raise ValueError(
                "elastic_slices already slices the global batch; "
                "grad_accum_steps > 1 is not composed with it")
        if self.resolved_allreduce_dtype() != "float32":
            raise ValueError(
                "elastic_slices is the exact-replay mode: quantized "
                "wire dtypes fold device indices into their rounding "
                "streams and can never be world-invariant (use f32)")

    def _validate_pipeline(self) -> None:
        """The reference's pipeline gates, worded as it words them, after
        the refusals of what the port does not carry (each naming its
        ROADMAP item)."""
        for name, default, what, item in _PIPE_NOT_PORTED:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{what} ({name}={getattr(self, name)!r}) is not ported "
                    f"to the PyTorch training path yet (ROADMAP {item})")
        if self.remat_layers and self.strategy not in ONE_APPLY_STRATEGIES:
            raise ValueError(
                f"remat_layers applies to the one-apply strategies "
                f"(single/dp/tp/fsdp), not {self.strategy!r} — the pipeline "
                f"strategies checkpoint per (microbatch, stage) via "
                f"remat_stages, and sp/ep bound activation memory by "
                f"sharding the sequence/experts instead")
        if self.dp_replicas < 1:
            raise ValueError("dp_replicas must be >= 1")
        if self.stage_replication is not None:
            repl = tuple(self.stage_replication)
            if self.strategy not in PIPELINE_STRATEGIES:
                raise ValueError(
                    "stage_replication applies to the pipeline strategies")
            if not repl or any(r < 1 for r in repl):
                raise ValueError("stage_replication factors must be >= 1")
            if self.dp_replicas > 1:
                raise ValueError(
                    "stage_replication and dp_replicas are mutually "
                    "exclusive (the tuple already encodes replication)")
            if sum(repl) != self.num_devices:
                raise ValueError(
                    f"stage_replication {repl} sums to {sum(repl)}; "
                    f"num_devices is {self.num_devices}")
            if self.num_stages is not None and self.num_stages != len(repl):
                raise ValueError(
                    f"num_stages ({self.num_stages}) != "
                    f"len(stage_replication) ({len(repl)})")
            mb, _ = self.resolved_batches()
            bad = [s for s, r in enumerate(repl) if mb % r]
            if bad:
                raise ValueError(
                    f"micro-batch {mb} must be divisible by every "
                    f"replication factor; stages {bad} of {repl} are not")
            if self.virtual_stages > 1:
                raise ValueError(
                    "stage_replication and virtual_stages (interleaved "
                    "schedule) are mutually exclusive")
        elif self.strategy in PIPELINE_STRATEGIES:
            s = self.resolved_stages()
            if s * max(1, self.dp_replicas) * max(1, self.tp_size) \
                    != self.num_devices:
                raise ValueError(
                    f"stages ({s}) x dp_replicas ({self.dp_replicas}) x "
                    f"tp_size ({self.tp_size}) must equal "
                    f"num_devices ({self.num_devices})"
                )
        if self.tp_size < 1:
            raise ValueError("tp_size must be >= 1")
        if self.tp_size > 1:
            if self.strategy != "gpipe":
                raise ValueError(
                    "tp_size > 1 (composed tensor x pipeline parallelism) "
                    "runs on the gpipe strategy (parallel/tpp.py)")
            if self.dataset().kind not in ("tokens", "seq2seq"):
                raise ValueError(
                    "tp_size > 1 requires a token or seq2seq benchmark "
                    "(transformer blocks are what gets Megatron-sliced)")
            if self.stage_replication is not None:
                raise ValueError(
                    "tp_size > 1 composes with uniform pipeline stages "
                    "(plus dp_replicas for 3-D parallelism); "
                    "stage_replication must stay default")
            if self.virtual_stages > 1:
                raise ValueError(
                    "tp_size > 1 with the interleaved schedule is not "
                    "supported")
            if self.pipe_schedule != "fill-drain":
                raise ValueError(
                    "tp_size > 1 composes with the fill-drain schedule "
                    "(parallel/tpp.py); event-mode schedules are scoped "
                    "to the 2-D data x stage mesh")
        if self.virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if self.pipe_schedule not in PIPE_SCHEDULES:
            raise ValueError(
                f"unknown pipe_schedule {self.pipe_schedule!r} "
                f"(choose from {', '.join(PIPE_SCHEDULES)})")
        if self.pipe_schedule != "fill-drain" and self.strategy != "gpipe":
            raise ValueError(
                f"pipe_schedule={self.pipe_schedule!r} runs on the "
                f"gpipe strategy's schedule runtime "
                f"(parallel/pipeline_rt.py); pipedream is the ASYNC "
                f"1F1B engine and {self.strategy!r} has no pipeline")
        if self.pipe_schedule != "fill-drain" and \
                self.stage_replication is not None:
            raise ValueError(
                "stage_replication (hetero pipeline) executes the "
                "fill-drain schedule only")
        if self.zb_h2_stash < 0:
            raise ValueError("zb_h2_stash must be >= 0")
        if self.sched_search_budget < 0:
            raise ValueError("sched_search_budget must be >= 0")
        if self.update_interval < 1:
            raise ValueError("update_interval must be >= 1")
        if self.update_interval > 1:
            # uniform stage_replication tuples run as dp_replicas and are
            # macrobatch-compatible; only uneven plans conflict
            uneven = (self.stage_replication
                      and len(set(self.stage_replication)) > 1)
            if self.strategy != "pipedream" or uneven:
                raise ValueError(
                    "update_interval > 1 (PipeDream macrobatch) requires the "
                    "uniform pipedream strategy")
            _, chunks = self.resolved_batches()
            if chunks % self.update_interval:
                raise ValueError(
                    f"num_microbatches ({chunks}) must be divisible by "
                    f"update_interval ({self.update_interval})")
        if self.grad_accum_steps > 1 and \
                self.strategy not in ONE_APPLY_STRATEGIES:
            raise ValueError(
                "grad_accum_steps > 1 is supported on single/dp/tp/fsdp "
                "(pipeline strategies already micro-batch)")
        self._validate_plan()
        if self.plan_bounds is not None:
            if self.strategy not in PIPELINE_STRATEGIES:
                raise ValueError(
                    "plan_bounds (explicit stage bounds) applies to the "
                    "pipeline strategies")
            if self.auto_partition:
                raise ValueError(
                    "--auto-partition solves the stage bounds; "
                    "--plan-bounds pins them — pick one")
            pb = tuple(int(x) for x in self.plan_bounds)
            chunks_n = self.resolved_stages() * max(1, self.virtual_stages)
            if len(pb) != chunks_n + 1:
                raise ValueError(
                    f"plan_bounds needs stages x virtual_stages + 1 = "
                    f"{chunks_n + 1} entries; got {len(pb)}")
            if pb[0] != 0 or any(a >= b for a, b in zip(pb, pb[1:])):
                raise ValueError(
                    f"plan_bounds must strictly increase from 0; got {pb}")
        if self.virtual_stages > 1:
            if self.strategy not in PIPELINE_STRATEGIES:
                raise ValueError(
                    "virtual_stages (interleaved schedule) requires a "
                    "pipeline strategy (gpipe or pipedream)")
            s = self.resolved_stages()
            _, chunks = self.resolved_batches()
            if chunks % s:
                raise ValueError(
                    f"interleaved schedule needs num_microbatches ({chunks}) "
                    f"divisible by stages ({s})")
        self._validate_costs()

    def _validate_plan(self) -> None:
        """The reference's --plan gates, worded as it words them."""
        if self.plan not in ("manual", "auto"):
            raise ValueError(
                f"unknown plan mode {self.plan!r} (choose manual or auto)")
        if self.plan != "auto":
            return
        if self.strategy != "gpipe":
            raise ValueError(
                "--plan auto solves the dp/pp/tp mix from the gpipe "
                "batch grammar (micro-batch x microbatches = the "
                "global batch the plan preserves); pass -f gpipe — "
                "the winner may rewrite the strategy to dp/tp/single")
        if self.auto_partition:
            raise ValueError(
                "--plan auto supersedes --auto-partition (it solves "
                "the stage split AND the mix); drop one")
        owned = (
            ("--stages", self.num_stages, None),
            ("--dp-replicas", self.dp_replicas, 1),
            ("--tp-size", self.tp_size, 1),
            ("--stage-replication", self.stage_replication, None),
            ("--virtual-stages", self.virtual_stages, 1),
            ("--pipe-schedule", self.pipe_schedule, "fill-drain"),
            ("--pipe-costs", self.pipe_costs, "unit"),
            ("pipe_cost_vectors", self.pipe_cost_vectors, None),
            ("--plan-bounds", self.plan_bounds, None),
            ("--dp-shard-update", self.dp_shard_update, False),
            ("--update-interval", self.update_interval, 1),
        )
        clash = [name for name, val, dflt in owned if val != dflt]
        if clash:
            raise ValueError(
                f"--plan auto owns the parallelism mix; leave "
                f"{', '.join(clash)} unset (the planner chooses them)")

    def _validate_costs(self) -> None:
        """The reference's cost-weighted timetable gates."""
        if self.pipe_costs not in ("unit", "profile"):
            raise ValueError(
                f"unknown pipe_costs {self.pipe_costs!r} (choose unit or "
                f"profile)")
        if self.pipe_costs == "profile":
            if self.strategy != "gpipe":
                raise ValueError(
                    "pipe_costs='profile' (cost-weighted timetables) "
                    "applies to -f gpipe's schedule runtime")
            if not self.auto_partition:
                raise ValueError(
                    "pipe_costs='profile' needs --auto-partition (the "
                    "profile graph is where the per-chunk costs come from)")
            if self.pipe_schedule == "fill-drain":
                raise ValueError(
                    "pipe_costs='profile' needs an event schedule "
                    "(--pipe-schedule 1f1b/interleaved/zero-bubble/"
                    "zero-bubble-h2/searched); the fill-drain autodiff "
                    "scan executes the unit timetable by construction")
        if self.pipe_cost_vectors is not None:
            if self.strategy != "gpipe":
                raise ValueError(
                    "pipe_cost_vectors applies to -f gpipe's schedule "
                    "runtime")
            if self.pipe_schedule == "fill-drain":
                raise ValueError(
                    "cost-weighted timetables execute on the EVENT "
                    "schedules (1f1b/interleaved/zero-bubble/"
                    "zero-bubble-h2/searched); the fill-drain autodiff "
                    "scan is lockstep by construction")
            normalize_costs(  # raises on malformed vectors
                self.pipe_cost_vectors,
                self.resolved_stages() * self.virtual_stages)

    def _validate_sharded(self) -> None:
        """The reference's sp and ep gates, worded as it words them."""
        if self.strategy == "sp" and self.dataset().kind not in ("tokens",
                                                                 "seq2seq"):
            raise ValueError("sp (sequence parallelism) requires a token or "
                             "seq2seq benchmark")
        if self.strategy == "ep":
            if self.dataset().kind != "tokens":
                raise ValueError("ep (expert parallelism) requires a token "
                                 "benchmark")
            if "moe" not in self.arch:
                raise ValueError("ep (expert parallelism) requires an MoE "
                                 "arch")

    def _validate_dp(self) -> None:
        """The reference's dp gates, worded as it words them."""
        if self.shard_opt_state and self.strategy != "dp":
            raise ValueError(
                "shard_opt_state (ZeRO-1) applies to the dp strategy "
                "(fsdp already shards everything)")
        self.resolved_allreduce_dtype()  # raises on unknown values
        if self.comm_buckets < 1:
            raise ValueError("comm_buckets must be >= 1")
        if self.comm_buckets > 1 and self.strategy != "dp" and \
                not self.pipe_shard_engine():
            raise ValueError(
                "comm_buckets > 1 (bucketed gradient collectives) applies "
                "to the dp strategy's explicit collective engine (-f dp; "
                "combine with --dp-shard-update for the fully overlapped "
                "just-in-time all-gather) or to -f gpipe with "
                "--dp-shard-update (hybrid PP x ZeRO-1 bucket count)")
        if self.dp_shard_update and self.strategy not in ("dp", "gpipe"):
            raise ValueError(
                "dp_shard_update (sharded weight update) applies to the dp "
                "strategy or to -f gpipe (hybrid PP x ZeRO-1 over the pipe "
                "mesh's 'data' axis; fsdp already shards everything)")
        if self.pipe_shard_engine():
            if self.tp_size > 1:
                raise ValueError(
                    "dp_shard_update on gpipe (hybrid PP x ZeRO-1) is "
                    "scoped to the 2-D data x stage mesh; tp_size > 1 "
                    "keeps the replicated update")
            if self.stage_replication is not None:
                raise ValueError(
                    "dp_shard_update on gpipe needs the uniform 2-D mesh; "
                    "stage_replication (hetero pipeline) keeps the "
                    "replicated update")
        if self.dp_shard_update and self.shard_opt_state:
            raise ValueError(
                "dp_shard_update supersedes shard_opt_state: the explicit "
                "engine already shards the optimizer state (pick one)")
        if self.shard_opt_state and self.strategy == "dp" and \
                self.resolved_allreduce_dtype() != "float32":
            raise ValueError(
                "shard_opt_state is a GSPMD placement knob; the compressed-"
                "allreduce engine pins the optimizer state replicated — "
                "use dp_shard_update for sharded state with bf16 wire")
        if self.resolved_allreduce_dtype() != "float32" and \
                self.strategy != "dp":
            raise ValueError(
                "allreduce_dtype applies to the dp strategy's gradient "
                "collectives")
        if self.dp_explicit_collectives():
            if "moe" in self.arch:
                raise ValueError(
                    "dp_shard_update / compressed allreduce run the train "
                    "step under shard_map, where MoE router statistics "
                    "would become per-shard (replicated dp routes over the "
                    "global batch); use replicated dp for MoE archs")
            if self.remat_layers:
                raise ValueError(
                    "remat_layers is incompatible with the explicit dp "
                    "collective engine (checkpointed traces cannot carry "
                    "the shard_map axis context); use replicated dp")
