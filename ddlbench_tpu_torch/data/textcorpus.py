"""Plain-text LM ingest: text file(s) -> BPE -> packed causal-LM windows
(the port of ``ddlbench_tpu/data/textcorpus.py``).

A directory holding ``train.txt`` (and optionally ``test.txt``,
``val.txt`` or ``valid.txt``) is tokenized with the port's BPE
(data/bpe.py: trained on the corpus itself on first use and cached next
to it as ``bpe_vocab.json``), document-packed into one id stream with an
EOS after each line, cut into [T+1] windows and served as fixed-shape
batches with the synthetic path's (inputs, labels) = (row[:-1], row[1:])
convention, shuffled per epoch with a seeded permutation
(data/corpus.py). The windows, the order and so every batch's ids are the
reference's; batches are int64 tensors on the run's device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ddlbench_tpu_torch.config import DatasetSpec
from ddlbench_tpu_torch.data.bpe import BpeTokenizer
from ddlbench_tpu_torch.data.corpus import RowStreamData, bootstrap_tokenizer

_SPLIT_FILES = {"train": ("train",), "test": ("test", "val", "valid")}


def find_text_corpus(data_dir: str, split: str) -> Optional[str]:
    """Path of the split's text file under data_dir, or None."""
    for base in _SPLIT_FILES[split]:
        path = os.path.join(data_dir, f"{base}.txt")
        if os.path.exists(path):
            return path
    return None


class TextCorpusData(RowStreamData):
    """SyntheticData-interface batches from a plain text corpus: windows
    are contiguous [T+1] slices of the EOS-joined token stream (document
    packing: no padding, every label position valid)."""

    def __init__(self, data_dir: str, spec: DatasetSpec, batch_size: int,
                 device: torch.device, seed: int = 1, num_merges: int = 512,
                 tokenizer: Optional[BpeTokenizer] = None,
                 steps_per_epoch: Optional[int] = None):
        if spec.kind != "tokens":
            raise ValueError(f"a text corpus feeds a token benchmark, not "
                             f"{spec.name} ({spec.kind})")
        super().__init__(batch_size, seed, salt=2,
                         steps_per_epoch=steps_per_epoch)
        self.spec, self.device = spec, torch.device(device)
        T = spec.seq_len
        train_path = find_text_corpus(data_dir, "train")
        if train_path is None:
            raise FileNotFoundError(
                f"no text corpus (train.txt) under {data_dir}")
        test_path = find_text_corpus(data_dir, "test")

        def train_lines():
            with open(train_path) as f:
                return list(f)

        self.tokenizer = bootstrap_tokenizer(
            data_dir, train_lines, spec.num_classes, num_merges, tokenizer)
        self._store_rows("train", self._windows_of(train_path, T))
        if test_path is None:
            self._rows["test"] = self._rows["train"]  # no re-tokenize
        else:
            self._store_rows("test", self._windows_of(test_path, T))
        self.num_tokens = int(self._rows["train"].size)

    def _windows_of(self, path: str, T: int) -> np.ndarray:
        stream = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    stream.extend(self.tokenizer.encode(line, add_eos=True))
        if not stream:
            raise ValueError(f"text corpus {path} is empty")
        W = T + 1
        if len(stream) < W:
            reps = -(-W // len(stream))
            stream = stream * (reps + 1)
        n = len(stream) // W
        return np.asarray(stream[:n * W], np.int64).reshape(n, W)

    def batch(self, epoch: int, step: int, train: bool = True):
        ids = torch.from_numpy(self.take_rows(epoch, step, train)).to(
            self.device)
        return ids[:, :-1], ids[:, 1:]
