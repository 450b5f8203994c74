"""Self-drafting n-gram proposer for speculative decoding.

The port's copy of ``ddlbench_tpu/serve/draft.py`` (pure host code).
Speculative decoding (Leviathan et al. 2022) splits generation into a cheap
DRAFT and an exact VERIFY: a proposer guesses the next K tokens, the model
scores all K+1 positions in ONE pass, and the longest prefix of drafts
matching the model's own greedy choices is accepted.

This drafter proposes from the request's OWN token stream (prompt-lookup
style): it finds the most recent earlier occurrence of the last N tokens
and proposes the continuation that followed it. It is deterministic (no
RNG, so eviction and recompute replay the same speculative schedule),
reads only the request's prompt and emitted tokens, and proposes at most
``k`` tokens. The engine owns acceptance, so a bad proposal costs
acceptance rate, never correctness.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class NgramDrafter:
    """Propose up to ``k`` continuation tokens by matching the context's
    trailing ``n``-gram against its own history."""

    def __init__(self, n: int, k: int):
        if n < 1 or k < 1:
            raise ValueError(f"ngram drafter needs n >= 1 and k >= 1, "
                             f"got n={n} k={k}")
        self.n = int(n)
        self.k = int(k)

    def propose(self, context: Sequence[int],
                k_max: Optional[int] = None) -> List[int]:
        """Drafts for the token stream ``context`` (prompt + emitted
        tokens, most recent last): the continuation that followed the most
        recent PRIOR occurrence of the trailing n-gram, cut to ``min(k,
        k_max)`` tokens and to what the history holds. Empty when the
        n-gram never recurred or the context is shorter than n + 1."""
        k = self.k if k_max is None else min(self.k, int(k_max))
        n = self.n
        L = len(context)
        if k < 1 or L < n + 1:
            return []
        tail = list(context[L - n:])
        # j is the index AFTER a match (the first proposed token), scanned
        # right to left: the most recent occurrence that can supply all k
        # tokens wins; when every match sits too close to the end (a
        # periodic stream, whose matches overlap the tail), fall back to
        # the earliest match, whose continuation is the longest
        fallback = None
        for j in range(L - 1, n - 1, -1):
            if list(context[j - n:j]) == tail:
                if L - j >= k:
                    return [int(t) for t in context[j:j + k]]
                fallback = j
        if fallback is not None:
            return [int(t) for t in context[fallback:fallback + k]]
        return []
