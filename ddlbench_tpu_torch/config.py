"""Typed configuration of the PyTorch serving path.

The port's own copy of the pieces of ``ddlbench_tpu/config.py`` the serving
path reads: :class:`DatasetSpec` with the ``synthtext`` token workload, and
:class:`ServeConfig` with its resolvers and validation. The field names,
defaults and error messages are the reference's, so a config built for one
package means the same thing to the other.

Serving features the port does not carry yet (prefix cache, speculative
verify, sampling, the int8 pool, the SDC ledger, tp > 1, replicas > 1,
heartbeat, tracing) keep their fields, and :meth:`ServeConfig.validate`
raises ``NotImplementedError`` when one is set away from its default, so a
knob is never silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple


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
