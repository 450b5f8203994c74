"""Shared machinery for real-corpus data sources (translation + plain
text): the port's copy of ``ddlbench_tpu/data/corpus.py``.

The BPE tokenizer bootstrap (load the cached vocab next to the corpus,
else train on it and cache) and the fixed-shape row-stream batcher
(deterministic per-epoch shuffle from numpy's generator seeded by (seed,
epoch, salt), wrap-around tail, steps-per-epoch override): the rows a
batch takes are the reference's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from ddlbench_tpu_torch.data.bpe import BpeTokenizer


def bootstrap_tokenizer(data_dir: str, lines: Callable[[], Iterable[str]],
                        vocab_budget: int, num_merges: int,
                        tokenizer: Optional[BpeTokenizer]) -> BpeTokenizer:
    """Load ``bpe_vocab.json`` next to the corpus, else train on ``lines()``
    and cache it. Enforces the dataset spec's vocab budget."""
    vocab_path = os.path.join(data_dir, "bpe_vocab.json")
    if tokenizer is None:
        if os.path.exists(vocab_path):
            tokenizer = BpeTokenizer.load(vocab_path)
        else:
            tokenizer = BpeTokenizer.train(lines(), num_merges=num_merges)
            try:
                tokenizer.save(vocab_path)
            except OSError:
                pass
    if tokenizer.vocab_size > vocab_budget:
        raise ValueError(
            f"tokenizer vocab {tokenizer.vocab_size} exceeds the spec's "
            f"{vocab_budget}; lower num_merges")
    return tokenizer


class RowStreamData:
    """Fixed-shape [N, W] row matrices per split, served as shuffled batches.

    Subclasses fill ``self._rows[split]`` (tiled up to one batch if tiny)
    and implement ``batch`` by post-processing ``take_rows``. The epoch
    permutation is seeded, cached only for the current epoch, and the tail
    wraps so every batch has full shape.
    """

    def __init__(self, batch_size: int, seed: int, salt: int,
                 steps_per_epoch: Optional[int]):
        self.batch_size = batch_size
        self.seed = seed
        self._salt = salt
        self._steps_override = steps_per_epoch
        self._perm_cache: dict = {}
        self._rows: Dict[str, np.ndarray] = {}

    def _store_rows(self, split: str, rows: np.ndarray) -> None:
        if len(rows) < self.batch_size:
            rows = np.tile(rows, (-(-self.batch_size // len(rows)),)
                           + (1,) * (rows.ndim - 1))
        self._rows[split] = rows

    def steps_per_epoch(self, train: bool = True) -> int:
        n = max(1, len(self._rows["train" if train else "test"])
                // self.batch_size)
        if self._steps_override:
            n = min(n, self._steps_override)
        return n

    def _order(self, epoch: int, train: bool) -> np.ndarray:
        if not train:
            return np.arange(len(self._rows["test"]))
        order = self._perm_cache.get(epoch)
        if order is None:
            order = np.random.default_rng(
                (self.seed, epoch, self._salt)).permutation(
                    len(self._rows["train"]))
            self._perm_cache = {epoch: order}  # keep only the current epoch
        return order

    def take_rows(self, epoch: int, step: int, train: bool) -> np.ndarray:
        split = "train" if train else "test"
        rows = self._rows[split]
        n = len(rows)
        order = self._order(epoch, train)
        idx = order[(step * self.batch_size) % n:][:self.batch_size]
        if len(idx) < self.batch_size:  # wrap the tail
            idx = np.concatenate([idx, order[:self.batch_size - len(idx)]])
        return rows[idx]

    def epoch_iter(self, epoch: int, train: bool = True) -> Iterator:
        for step in range(self.steps_per_epoch(train)):
            yield self.batch(epoch, step, train)

    def close(self) -> None:
        pass
