"""Seeded serving workloads: arrival processes + heavy-tail length mixtures.

The port's copy of ``ddlbench_tpu/serve/workload.py``: plain and
shared-prefix traffic, deadlines, SLO tiers and traffic shapes. Every draw
comes from ``random.Random(seed)`` — CPython's Mersenne Twister, whose
``random()`` stream is stable across platforms and Python versions — in
the reference's order, and tiers and shaped arrivals from their own
streams ``Random(f"{seed}:tier")`` and ``Random(f"{seed}:shape")``
(string seeds go through SHA-512), so one seed gives the same arrival
times, prompt tokens, output lengths, deadlines and tiers in both
packages, byte for byte.

Arrival processes:

* ``closed``  — no arrival times; the driver keeps a fixed number of
  requests in flight and submits the next on each completion.
* ``poisson`` — open loop, exponential inter-arrivals at ``rate`` requests
  per time unit (one model pass; see serve/engine.py).
* ``bursty``  — square-wave-modulated Poisson: groups of ``burst_size`` at
  ``rate * burst_factor``, the gaps between groups at
  ``rate / burst_factor``.

Traffic shapes (``shape=``, poisson only) scale each inter-arrival by a
rate curve (``_shape_factor``: ``diurnal`` raised cosine, ``ramp``,
``spike``) and draw it from the shape stream, so prompts and output
lengths are the same for every shape at one seed.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional

import numpy as np

ARRIVALS = ("closed", "poisson", "bursty")

# rate-curve shapes layered on the poisson process (see _shape_factor)
SHAPES = ("diurnal", "ramp", "spike")

TIERS = ("interactive", "batch")


@dataclasses.dataclass
class ServeRequest:
    """One serving request: a prompt to continue by ``max_new`` tokens."""

    rid: int
    prompt: np.ndarray  # [S] int32 token ids
    max_new: int
    # virtual arrival time; None for closed-loop (the driver stamps the
    # submission time when it releases the request)
    arrival: Optional[float] = None
    # absolute virtual-time completion deadline; None = never shed or
    # timed out. With one, admission may SHED the request (its projected
    # completion already misses the deadline) and the engine cancels it
    # into the ``timeout`` terminal state once the deadline passes
    deadline: Optional[float] = None
    # SLO tier: "interactive" admits ahead of "batch", and batch requests
    # are evicted first under pool pressure
    tier: str = "interactive"

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def _bounded_pareto(u: float, lo: int, hi: int, alpha: float) -> int:
    """Inverse-transform bounded Pareto draw on [lo, hi] from one uniform."""
    x = lo * (1.0 - u * (1.0 - (lo / hi) ** alpha)) ** (-1.0 / alpha)
    return max(lo, min(hi, int(x)))


def heavy_tail_length(rng: random.Random, lo: int, typical: int, hi: int,
                      tail_frac: float = 0.25, alpha: float = 1.2) -> int:
    """Mixture length: uniform [lo, typical] body, bounded-Pareto tail
    anchored at ``typical`` and clipped to ``hi`` with probability
    ``tail_frac``. lo <= result <= hi always."""
    if rng.random() < tail_frac and hi > typical:
        return _bounded_pareto(rng.random(), typical, hi, alpha)
    return lo + int(rng.random() * (typical - lo + 1))


def _shape_factor(shape: str, i: int, n: int) -> float:
    """Arrival-rate multiplier for request ``i`` of ``n`` under a traffic
    shape: the peak is 1.0 (``rate`` stays the peak rate) and troughs
    bottom out at 0.15; ``spike`` is a 6.67x flash crowd over 15 % of the
    run."""
    x = i / max(1, n - 1)
    if shape == "diurnal":
        # raised cosine: trough at both ends, peak mid-run
        return 0.15 + 0.85 * 0.5 * (1.0 - math.cos(2.0 * math.pi * x))
    if shape == "ramp":
        return 0.15 + 0.85 * x
    if shape == "spike":
        return 1.0 if 0.45 <= x < 0.60 else 0.15
    raise ValueError(f"shape must be one of {SHAPES}, got {shape!r}")


def make_workload(*, seed: int, n_requests: int, vocab: int,
                  arrival: str = "poisson", rate: float = 0.5,
                  shape: Optional[str] = None,
                  burst_size: int = 8, burst_factor: float = 4.0,
                  prompt_lo: int = 4, prompt_typical: int = 16,
                  prompt_hi: int = 64, out_lo: int = 2, out_typical: int = 16,
                  out_hi: int = 64, tail_frac: float = 0.25,
                  prefix_groups: int = 0, prefix_len: int = 0,
                  max_len: Optional[int] = None,
                  deadline_slack: Optional[float] = None,
                  batch_frac: float = 0.0) -> List[ServeRequest]:
    """Synthesize a deterministic request list for one benchmark run.

    ``max_len`` (the engine's stream capacity) caps prompt + output: the
    prompt is clipped to ``max_len - out_lo`` and the output to the
    remaining room, so every generated request is admissible.

    Shared-prefix traffic (``prefix_groups > 0``, the workload a prefix
    cache exists for): ``prefix_groups`` fixed prefixes of ``prefix_len``
    tokens are drawn first; each request picks a group uniformly, and its
    prompt is that prefix followed by a unique tail whose length comes from
    the same heavy-tail mixture as plain traffic.

    ``deadline_slack`` gives every open-loop request ``deadline = arrival
    + deadline_slack`` (closed-loop requests have no arrival until the
    driver releases them, so the driver stamps theirs). ``batch_frac``
    draws each request into the "batch" tier with that probability.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}, got {arrival!r}")
    if shape is not None:
        if shape not in SHAPES:
            raise ValueError(
                f"shape must be one of {SHAPES}, got {shape!r}")
        if arrival != "poisson":
            raise ValueError(
                "traffic shapes modulate the poisson process; "
                f"pass arrival='poisson' (got {arrival!r})")
    if prefix_groups < 0 or prefix_len < 0:
        raise ValueError("prefix_groups and prefix_len must be >= 0")
    if deadline_slack is not None and deadline_slack <= 0:
        raise ValueError(
            f"deadline_slack must be > 0 time units, got {deadline_slack}")
    if not 0.0 <= batch_frac <= 1.0:
        raise ValueError(
            f"batch_frac is a probability in [0, 1], got {batch_frac}")
    if bool(prefix_groups) != bool(prefix_len):
        raise ValueError("shared-prefix traffic needs BOTH prefix_groups "
                         "and prefix_len (> 0)")
    if max_len is not None and prefix_len > max_len - out_lo - 1:
        raise ValueError(
            f"prefix_len {prefix_len} leaves no room for a tail + output "
            f"within max_len {max_len}")
    rng = random.Random(seed)
    # tiers and shaped arrivals ride streams of their own, so neither
    # moves the prompt and length draws of the main stream
    trng = random.Random(f"{seed}:tier")
    srng = random.Random(f"{seed}:shape")
    prefixes = [
        np.array([rng.randrange(vocab) for _ in range(prefix_len)], np.int32)
        for _ in range(prefix_groups)
    ]
    reqs: List[ServeRequest] = []
    t = 0.0
    for i in range(n_requests):
        s = heavy_tail_length(rng, prompt_lo, prompt_typical, prompt_hi,
                              tail_frac)
        m = heavy_tail_length(rng, out_lo, out_typical, out_hi, tail_frac)
        if prefix_groups:
            # the drawn length becomes the TAIL length (>= 1, so every
            # prompt diverges from its siblings after the shared head)
            group = rng.randrange(prefix_groups)
            s = max(1, s)
            if max_len is not None:
                s = max(1, min(s, max_len - out_lo - prefix_len))
            tail = np.array([rng.randrange(vocab) for _ in range(s)],
                            np.int32)
            prompt = np.concatenate([prefixes[group], tail])
            if max_len is not None:
                m = min(m, max_len - int(prompt.shape[0]))
        else:
            if max_len is not None:
                s = min(s, max_len - out_lo)
                m = min(m, max_len - s)
            prompt = np.array([rng.randrange(vocab) for _ in range(s)],
                              np.int32)
        when: Optional[float] = None
        if arrival == "poisson":
            if shape is not None:
                r = rate * _shape_factor(shape, i, n_requests)
                t += -math.log(1.0 - srng.random()) / r
            else:
                t += -math.log(1.0 - rng.random()) / rate
            when = t
        elif arrival == "bursty":
            in_burst = (i // burst_size) % 2 == 0
            r = rate * burst_factor if in_burst else rate / burst_factor
            t += -math.log(1.0 - rng.random()) / r
            when = t
        tier = "interactive"
        if batch_frac and trng.random() < batch_frac:
            tier = "batch"
        deadline = (when + deadline_slack
                    if deadline_slack is not None and when is not None
                    else None)
        reqs.append(ServeRequest(rid=i, prompt=prompt, max_new=m,
                                 arrival=when, deadline=deadline, tier=tier))
    return reqs
