"""Seeded serving workloads: arrival processes + heavy-tail length mixtures.

The port's copy of ``ddlbench_tpu/serve/workload.py`` for plain and
shared-prefix traffic (no deadlines, tiers or rate shapes yet). Every draw
comes from ``random.Random(seed)`` — CPython's Mersenne Twister, whose
``random()`` stream is stable across platforms and Python versions — in
the reference's order, so one seed gives the same arrival times, prompt
tokens and output lengths in both packages, byte for byte.

Arrival processes:

* ``closed``  — no arrival times; the driver keeps a fixed number of
  requests in flight and submits the next on each completion.
* ``poisson`` — open loop, exponential inter-arrivals at ``rate`` requests
  per time unit (one model pass; see serve/engine.py).
* ``bursty``  — square-wave-modulated Poisson: groups of ``burst_size`` at
  ``rate * burst_factor``, the gaps between groups at
  ``rate / burst_factor``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional

import numpy as np

ARRIVALS = ("closed", "poisson", "bursty")


@dataclasses.dataclass
class ServeRequest:
    """One serving request: a prompt to continue by ``max_new`` tokens."""

    rid: int
    prompt: np.ndarray  # [S] int32 token ids
    max_new: int
    # virtual arrival time; None for closed-loop (the driver stamps the
    # submission time when it releases the request)
    arrival: Optional[float] = None

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


def make_workload(*, seed: int, n_requests: int, vocab: int,
                  arrival: str = "poisson", rate: float = 0.5,
                  burst_size: int = 8, burst_factor: float = 4.0,
                  prompt_lo: int = 4, prompt_typical: int = 16,
                  prompt_hi: int = 64, out_lo: int = 2, out_typical: int = 16,
                  out_hi: int = 64, tail_frac: float = 0.25,
                  prefix_groups: int = 0, prefix_len: int = 0,
                  max_len: Optional[int] = None) -> List[ServeRequest]:
    """Synthesize a deterministic request list for one benchmark run.

    ``max_len`` (the engine's stream capacity) caps prompt + output: the
    prompt is clipped to ``max_len - out_lo`` and the output to the
    remaining room, so every generated request is admissible.

    Shared-prefix traffic (``prefix_groups > 0``, the workload a prefix
    cache exists for): ``prefix_groups`` fixed prefixes of ``prefix_len``
    tokens are drawn first; each request picks a group uniformly, and its
    prompt is that prefix followed by a unique tail whose length comes from
    the same heavy-tail mixture as plain traffic.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}, got {arrival!r}")
    if prefix_groups < 0 or prefix_len < 0:
        raise ValueError("prefix_groups and prefix_len must be >= 0")
    if bool(prefix_groups) != bool(prefix_len):
        raise ValueError("shared-prefix traffic needs BOTH prefix_groups "
                         "and prefix_len (> 0)")
    if max_len is not None and prefix_len > max_len - out_lo - 1:
        raise ValueError(
            f"prefix_len {prefix_len} leaves no room for a tail + output "
            f"within max_len {max_len}")
    rng = random.Random(seed)
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
            t += -math.log(1.0 - rng.random()) / rate
            when = t
        elif arrival == "bursty":
            in_burst = (i // burst_size) % 2 == 0
            r = rate * burst_factor if in_burst else rate / burst_factor
            t += -math.log(1.0 - rng.random()) / r
            when = t
        reqs.append(ServeRequest(rid=i, prompt=prompt, max_new=m,
                                 arrival=when))
    return reqs
