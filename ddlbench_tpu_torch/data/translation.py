"""Real translation data: parallel corpus -> BPE -> prefix-LM token
streams (the port of ``ddlbench_tpu/data/translation.py``).

``TranslationData`` reads ``train.src``/``train.tgt`` (and ``test.*``,
``val.*`` or ``valid.*``) parallel line files, tokenizes them with the
port's BPE (data/bpe.py, trained on the corpus on first use and cached
next to it), packs them once into one [N, S+T+1] matrix (the source
padded to S; BOS, target, EOS padded to T+1) and serves shuffled
fixed-shape batches (data/corpus.py) with the synthetic path's (inputs,
labels) convention: source-internal (:func:`mask_source_labels`) and pad
positions are masked -1. The ids and masks are the reference's; batches
are int64 tensors on the run's device.

Fixed shapes are the reference's design choice, and it is priced:
``padding_efficiency()`` reports the valid-token fraction and
``bucketing_report(grid)`` the efficiency a length-bucketed sampler would
reach on the same corpus.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ddlbench_tpu_torch.config import DatasetSpec
from ddlbench_tpu_torch.data.bpe import BOS, EOS, PAD, BpeTokenizer
from ddlbench_tpu_torch.data.corpus import RowStreamData, bootstrap_tokenizer
from ddlbench_tpu_torch.data.synthetic import mask_source_labels

_SPLIT_FILES = {"train": ("train",), "test": ("test", "val", "valid")}


def find_parallel_corpus(data_dir: str,
                         split: str) -> Optional[Tuple[str, str]]:
    """(src_path, tgt_path) for a split under data_dir, or None."""
    for base in _SPLIT_FILES[split]:
        src = os.path.join(data_dir, f"{base}.src")
        tgt = os.path.join(data_dir, f"{base}.tgt")
        if os.path.exists(src) and os.path.exists(tgt):
            return src, tgt
    return None


def _read_pairs(src_path: str, tgt_path: str) -> List[Tuple[str, str]]:
    with open(src_path) as f:
        src = f.read().splitlines()
    with open(tgt_path) as f:
        tgt = f.read().splitlines()
    if len(src) != len(tgt):
        raise ValueError(
            f"parallel files disagree: {src_path} has {len(src)} lines, "
            f"{tgt_path} has {len(tgt)} (truncated download or bad "
            f"preprocessing?)")
    return [(a.strip(), b.strip()) for a, b in zip(src, tgt)
            if a.strip() and b.strip()]


def _pack(tok: BpeTokenizer, pairs: List[Tuple[str, str]], S: int, T: int):
    """Encode pairs into one [N, S+T+1] matrix: [src pad-to-S | BOS tgt EOS
    pad-to-T+1]. Sequences longer than their segment are truncated (EOS
    kept). Also returns the per-row (src_len, tgt_len) clipped lengths for
    the padding-efficiency accounting."""
    rows = []
    lens = []
    for src_text, tgt_text in pairs:
        s = tok.encode(src_text, add_eos=True)[:S]
        t = [BOS] + tok.encode(tgt_text, add_eos=True)
        t = t[:T] + [EOS] if len(t) > T + 1 else t
        t = t[:T + 1]
        row = s + [PAD] * (S - len(s)) + t + [PAD] * (T + 1 - len(t))
        rows.append(row)
        lens.append((len(s), len(t)))
    return np.asarray(rows, np.int64), np.asarray(lens, np.int64)


class TranslationData(RowStreamData):
    """SyntheticData-interface batches from a real parallel corpus: the
    stream is spec.seq_len = S + T long with S = spec.src_len."""

    def __init__(self, data_dir: str, spec: DatasetSpec, batch_size: int,
                 device: torch.device, seed: int = 1, num_merges: int = 512,
                 tokenizer: Optional[BpeTokenizer] = None,
                 steps_per_epoch: Optional[int] = None):
        if spec.kind != "seq2seq":
            raise ValueError(f"a parallel corpus feeds a seq2seq benchmark, "
                             f"not {spec.name} ({spec.kind})")
        super().__init__(batch_size, seed, salt=1,
                         steps_per_epoch=steps_per_epoch)
        self.spec, self.device = spec, torch.device(device)
        S = spec.src_len
        T = spec.seq_len - S
        train_files = find_parallel_corpus(data_dir, "train")
        if train_files is None:
            raise FileNotFoundError(
                f"no parallel corpus (train.src/train.tgt) under {data_dir}")
        test_files = find_parallel_corpus(data_dir, "test")

        def train_lines():
            with open(train_files[0]) as fs, open(train_files[1]) as ft:
                return list(fs) + list(ft)

        self.tokenizer = bootstrap_tokenizer(
            data_dir, train_lines, spec.num_classes, num_merges, tokenizer)
        self._lens = {}
        for split, files in (("train", train_files), ("test", test_files)):
            if files is None:  # no test split: reuse train (no re-tokenize)
                self._rows["test"] = self._rows["train"]
                self._lens["test"] = self._lens["train"]
                continue
            rows, lens = _pack(self.tokenizer, _read_pairs(*files), S, T)
            self._store_rows(split, rows)
            self._lens[split] = lens

    def batch(self, epoch: int, step: int, train: bool = True):
        ids = torch.from_numpy(self.take_rows(epoch, step, train)).to(
            self.device)
        x, labels = ids[:, :-1], ids[:, 1:]
        labels = mask_source_labels(labels, self.spec.src_len)
        # pad positions carry no loss: neither predicting a pad nor
        # predicting FROM a pad input position
        labels = torch.where((labels == PAD) | (x == PAD), -1, labels)
        return x, labels

    # -- padded-efficiency accounting (the priced fixed-shape choice) ------

    def padding_efficiency(self, train: bool = True) -> float:
        """Valid-token fraction of the fixed-shape [S + T+1] stream."""
        lens = self._lens["train" if train else "test"]
        total = lens.sum()
        cap = len(lens) * (self.spec.seq_len + 1)
        return float(total) / float(cap)

    def bucketing_report(self, grid: Optional[List[Tuple[int, int]]] = None,
                         train: bool = True) -> dict:
        """Efficiency a length-bucketed sampler would achieve on the same
        corpus: each pair goes to the smallest (S_b, T_b) grid bucket that
        fits it (clipped at the spec shape). Returns the comparison the
        fixed-shape choice rests on."""
        S = self.spec.src_len
        T = self.spec.seq_len - S + 1
        if grid is None:
            grid = [(S // 4, T // 4), (S // 2, T // 2),
                    (3 * S // 4, 3 * T // 4), (S, T)]
        lens = self._lens["train" if train else "test"]
        bucket_tokens = 0
        counts = [0] * len(grid)
        for sl, tl in lens:
            for gi, (gs, gt) in enumerate(grid):
                if sl <= gs and tl <= gt:
                    bucket_tokens += gs + gt
                    counts[gi] += 1
                    break
            else:
                bucket_tokens += S + T
                counts[-1] += 1
        valid = int(lens.sum())
        return {
            "fixed_efficiency": self.padding_efficiency(train),
            "bucketed_efficiency": valid / bucket_tokens,
            "buckets": [{"shape": list(g), "count": c}
                        for g, c in zip(grid, counts)],
            "num_compiles_fixed": 1,
            "num_compiles_bucketed": sum(1 for c in counts if c),
        }
