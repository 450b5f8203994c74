"""Byte-pair-encoding subword tokenizer for the translation and text
workloads (the port's copy of ``ddlbench_tpu/data/bpe.py``: the same
merges, ids and vocab file).

The reference tokenizes WMT with subword-nmt BPE: a vocab file of learned
merges, ``@@ ``-style continuation markers, and BOS/EOS/PAD/UNK specials
(pipedream-fork/profiler/translation/seq2seq/data/tokenizer.py). This module
implements the same capability self-contained: train merges on a corpus,
encode/decode text, save/load the vocab — no external models or downloads.

Implementation: classic BPE over whitespace-split words. Words are symbol
sequences ending in the end-of-word marker; training repeatedly merges the
most frequent adjacent symbol pair; encoding applies the learned merges in
rank order (lowest rank first), with a per-word cache.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Optional, Tuple

EOW = "</w>"

PAD, UNK, BOS, EOS = 0, 1, 2, 3
SPECIALS = ["<pad>", "<unk>", "<s>", "</s>"]


class BpeTokenizer:
    def __init__(self, merges: List[Tuple[str, str]], vocab: List[str]):
        self.merges = list(merges)
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.vocab = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self._cache: Dict[str, List[str]] = {}

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, lines: Iterable[str], num_merges: int = 512,
              min_pair_freq: int = 2) -> "BpeTokenizer":
        """Learn ``num_merges`` merges from an iterable of text lines."""
        word_freq = collections.Counter()
        for line in lines:
            word_freq.update(line.split())
        # each word as a tuple of symbols; char coverage forms the base vocab
        words = {w: tuple(w) + (EOW,) for w in word_freq}
        chars = sorted({c for w in words.values() for c in w})
        merges: List[Tuple[str, str]] = []
        for _ in range(num_merges):
            pair_freq = collections.Counter()
            for w, sym in words.items():
                f = word_freq[w]
                for a, b in zip(sym, sym[1:]):
                    pair_freq[(a, b)] += f
            if not pair_freq:
                break
            (a, b), f = pair_freq.most_common(1)[0]
            if f < min_pair_freq:
                break
            merges.append((a, b))
            merged = a + b
            new_words = {}
            for w, sym in words.items():
                out: List[str] = []
                i = 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                new_words[w] = tuple(out)
            words = new_words
        # vocab = base chars + EVERY merge product (not just final-state
        # symbols): an unseen word can stop merging at an intermediate
        # product (e.g. 'th' when training text always reached 'the'), which
        # must still encode — subword-nmt keeps all merge outputs too
        symbols = ({s for w in words.values() for s in w} | set(chars)
                   | {a + b for a, b in merges})
        vocab = SPECIALS + sorted(symbols)
        return cls(merges, vocab)

    # -- encoding ----------------------------------------------------------

    def _bpe_word(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        sym: List[str] = list(word) + [EOW]
        while len(sym) > 1:
            best = None
            best_rank = None
            for i, pair in enumerate(zip(sym, sym[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            sym[best:best + 2] = [sym[best] + sym[best + 1]]
        self._cache[word] = sym
        return sym

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = True) -> List[int]:
        ids: List[int] = [BOS] if add_bos else []
        for word in text.split():
            for tok in self._bpe_word(word):
                ids.append(self.token_to_id.get(tok, UNK))
        if add_eos:
            ids.append(EOS)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        for i in ids:
            if i in (PAD, BOS, EOS):
                continue
            tok = self.vocab[i] if 0 <= i < len(self.vocab) else SPECIALS[UNK]
            out.append(tok)
        text = "".join(t for t in out)
        return text.replace(EOW, " ").strip()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges, "vocab": self.vocab}, f)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["vocab"])
