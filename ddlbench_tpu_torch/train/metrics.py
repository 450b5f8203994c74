"""Metrics accumulation and the log-line schema
(``ddlbench_tpu/train/metrics.py``).

The lines are the reference's public metric interface, kept character for
character so its scrapers parse the port's output:

* per interval: ``train | <e>/<E> epoch (<p>%) | <X> samples/sec | loss L
  | mem <in use> GB in use, <peak> GB peak``;
* per epoch: ``epoch <e>/<E> done | <X> samples/sec | <S> sec`` with the
  input stall and the step percentiles appended, then ``valid | <e>/<E>
  epoch | loss L | accuracy A | top5 T``;
* at the end: ``valid accuracy: <A> | <X> samples/sec, <S> sec/epoch
  (average)``.

Each line also goes, as a JSON record, to an optional JSONL file. In a
dp run only rank 0 prints and writes. Device
memory is ``torch.cuda.memory_stats`` (allocated bytes: current and peak)
with the card's total memory as the limit; on the CPU it reads 0.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch


class AverageMeter:
    """Running value/average/sum/count accumulator (the reference's
    PipeDream-parity API)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


def device_memory_gb(device: Optional[torch.device] = None
                     ) -> Dict[str, float]:
    """In-use, peak and total device memory in GiB (the reference's keys;
    0 on the CPU)."""
    gb = 1024.0 ** 3
    if device is None or device.type != "cuda":
        return {"in_use": 0.0, "peak": 0.0, "limit": 0.0}
    stats = torch.cuda.memory_stats(device)
    return {
        "in_use": stats.get("allocated_bytes.all.current", 0) / gb,
        "peak": stats.get("allocated_bytes.all.peak", 0) / gb,
        "limit": torch.cuda.get_device_properties(device).total_memory / gb,
    }


class MetricLogger:
    """The reference-schema log lines plus a structured JSONL stream."""

    def __init__(self, total_epochs: int, log_interval: int = 25,
                 jsonl_path: Optional[str] = None,
                 device: Optional[torch.device] = None, rank: int = 0):
        self.total_epochs = total_epochs
        self.log_interval = log_interval
        self.device = device
        # a dp run's ranks all keep the records; only rank 0 emits them
        self.rank = rank
        self._jsonl = (open(jsonl_path, "a") if jsonl_path and rank == 0
                       else None)
        self.epoch_throughputs: list[float] = []
        self.epoch_times: list[float] = []
        # per-epoch time the loop spent making its batches
        self.epoch_stall_ms: list[float] = []
        self.valid_history: list[Dict[str, float]] = []

    def _emit(self, line: str, record: Dict[str, Any]) -> None:
        if self.rank != 0:
            return
        print(line, flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def train_interval(self, epoch: int, progress_pct: float,
                       samples_per_sec: float, loss: float) -> None:
        mem = device_memory_gb(self.device)
        line = (
            f"train | {epoch}/{self.total_epochs} epoch "
            f"({progress_pct:.0f}%) | {samples_per_sec:.2f} samples/sec | "
            f"loss {loss:.4f} | mem {mem['in_use']:.2f} GB in use, "
            f"{mem['peak']:.2f} GB peak")
        self._emit(line, {
            "kind": "train_interval", "epoch": epoch,
            "progress_pct": progress_pct,
            "samples_per_sec": samples_per_sec, "loss": loss,
            **{f"mem_{k}_gb": v for k, v in mem.items()}})

    def epoch_done(self, epoch: int, samples_per_sec: float,
                   epoch_seconds: float,
                   input_stall_ms: Optional[float] = None,
                   step_ms: Optional[Dict[str, float]] = None) -> None:
        self.epoch_throughputs.append(samples_per_sec)
        self.epoch_times.append(epoch_seconds)
        line = (f"epoch {epoch}/{self.total_epochs} done | "
                f"{samples_per_sec:.2f} samples/sec | "
                f"{epoch_seconds:.2f} sec")
        record = {"kind": "epoch", "epoch": epoch,
                  "samples_per_sec": samples_per_sec,
                  "epoch_seconds": epoch_seconds}
        if input_stall_ms is not None:
            self.epoch_stall_ms.append(input_stall_ms)
            line += f" | input stall {input_stall_ms:.1f} ms"
            record["input_stall_ms"] = input_stall_ms
        if step_ms:
            line += (f" | step p50 {step_ms['p50_ms']:.2f} ms, "
                     f"p95 {step_ms['p95_ms']:.2f} ms")
            for q in ("p50", "p95", "p99", "max"):
                record[f"step_time_{q}_ms"] = step_ms[f"{q}_ms"]
        self._emit(line, record)

    def valid_epoch(self, epoch: int, loss: float, accuracy: float,
                    top5: Optional[float] = None) -> None:
        line = (f"valid | {epoch}/{self.total_epochs} epoch | "
                f"loss {loss:.4f} | accuracy {accuracy:.4f}")
        record = {"kind": "valid", "epoch": epoch, "loss": loss,
                  "accuracy": accuracy}
        hist = {"epoch": epoch, "loss": loss, "accuracy": accuracy}
        if top5 is not None:
            line += f" | top5 {top5:.4f}"
            record["top5"] = top5
            hist["top5"] = top5
        self.valid_history = [h for h in self.valid_history
                              if h["epoch"] != epoch] + [hist]
        self._emit(line, record)

    def summary(self, valid_accuracy: float,
                step_time: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
        """The final line, and the run's summary dict: the averages over
        epochs, the validation curve, the run's step percentiles and the
        mean input stall per epoch."""
        avg_tp = (sum(self.epoch_throughputs)
                  / max(1, len(self.epoch_throughputs)))
        avg_t = sum(self.epoch_times) / max(1, len(self.epoch_times))
        record = {"kind": "summary", "valid_accuracy": valid_accuracy,
                  "samples_per_sec": avg_tp, "sec_per_epoch": avg_t}
        result = {"valid_accuracy": valid_accuracy,
                  "samples_per_sec": avg_tp, "sec_per_epoch": avg_t,
                  "valid_history": list(self.valid_history)}
        if step_time:
            extras = {f"step_time_{q}_ms": step_time[f"{q}_ms"]
                      for q in ("p50", "p95", "p99", "max")}
            if "warmup_compile_s" in step_time:
                extras["warmup_compile_s"] = step_time["warmup_compile_s"]
            record.update(extras)
            result.update(extras)
        if self.epoch_stall_ms:
            result["input_stall_ms_per_epoch"] = (
                sum(self.epoch_stall_ms) / len(self.epoch_stall_ms))
        self._emit(f"valid accuracy: {valid_accuracy:.4f} | "
                   f"{avg_tp:.2f} samples/sec, {avg_t:.2f} sec/epoch "
                   "(average)", record)
        return result

    def state_dict(self) -> Dict[str, Any]:
        """The counters a checkpoint carries (``resume.json``), so a
        resumed run's summary covers the whole run."""
        return {
            "epoch_throughputs": list(self.epoch_throughputs),
            "epoch_times": list(self.epoch_times),
            "epoch_stall_ms": list(self.epoch_stall_ms),
            "valid_history": [dict(h) for h in self.valid_history],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch_throughputs = list(state.get("epoch_throughputs", []))
        self.epoch_times = list(state.get("epoch_times", []))
        self.epoch_stall_ms = list(state.get("epoch_stall_ms", []))
        self.valid_history = [dict(h)
                              for h in state.get("valid_history", [])]

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
