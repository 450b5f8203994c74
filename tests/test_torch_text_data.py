"""The port's real-text data (ddlbench_tpu_torch/data/{bpe,corpus,
textcorpus,translation}.py, the token and seq2seq stores of
data/ondisk.py), the loop's source routing and the CLI's token knobs,
held against the JAX reference on the CPU.

The corpora are written here from a seed (a few hundred lines of made-up
words; a parallel pair whose targets reverse the source words), once per
package, so each trains its own tokenizer: the merges, the vocabulary,
the saved ``bpe_vocab.json`` (byte for byte), encode and decode must be
the reference's, and every batch's ids and masks EQUAL (the port's int64
tensors against the reference's int32 arrays), as must the translation
corpus's padding report. A generated on-disk token store and seq2seq
store are read by both packages: equal batches. ``make_data`` picks a
parallel corpus, a text corpus, a store or synthetic data as the
reference's ``_make_data`` does, and the CLI's ``-s --data-dir`` trains
on a text corpus and a parallel corpus on the CPU. Each of the six token
flags reaches RunConfig as the reference's CLI maps it.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import math
import os
import re

import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
from ddlbench_tpu.cli import build_parser as jax_cli_parser
from ddlbench_tpu.cli import config_from_args as jax_config_from_args
from ddlbench_tpu.data import bpe as jbpe
from ddlbench_tpu.data.ondisk import OnDiskData as JaxOnDisk
from ddlbench_tpu.data.textcorpus import TextCorpusData as JaxText
from ddlbench_tpu.data.translation import TranslationData as JaxMT

import ddlbench_tpu_torch.config as config
from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.data import bpe, native_loader, ondisk
from ddlbench_tpu_torch.data.synthetic import SyntheticData
from ddlbench_tpu_torch.data.textcorpus import TextCorpusData
from ddlbench_tpu_torch.data.translation import (TranslationData,
                                                 find_parallel_corpus)
from ddlbench_tpu_torch.train.loop import make_data

pytestmark = pytest.mark.torchport

CPU = torch.device("cpu")
B = 4
# small token and seq2seq specs (vocab room for the corpus's BPE)
TEXT = dict(name="tinytext", image_size=(32,), num_classes=1024,
            train_size=64, test_size=16, kind="tokens")
MT = dict(name="tinymt2", image_size=(32,), num_classes=1024,
          train_size=64, test_size=16, kind="seq2seq", src_len=12)


@pytest.fixture
def specs(monkeypatch):
    """The two specs registered in both packages' DATASETS."""
    out = {}
    for kw in (TEXT, MT):
        for mod in (config, jconfig):
            spec = mod.DatasetSpec(**kw)
            monkeypatch.setitem(mod.DATASETS, kw["name"], spec)
            monkeypatch.setitem(mod.DEFAULT_BATCH["single"], kw["name"], B)
        out[kw["name"]] = (config.DATASETS[kw["name"]],
                           jconfig.DATASETS[kw["name"]])
    return out


def _words(rng, n=60):
    letters = list("abcdefghiklmnoprstu")
    return ["".join(rng.choice(letters, size=int(rng.integers(2, 8))))
            for _ in range(n)]


def write_corpus(root, seed=0, lines=240):
    """train.txt, test.txt and a train/test parallel pair under ``root``
    (the source's words reversed, in reverse order, is the target)."""
    rng = np.random.default_rng(seed)
    words = _words(rng)
    os.makedirs(root, exist_ok=True)

    def line():
        return " ".join(rng.choice(words, size=int(rng.integers(3, 14))))

    for split, n in (("train", lines), ("test", lines // 4)):
        src = [line() for _ in range(n)]
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(src + [""] + [line() for _ in range(n)]))
        with open(os.path.join(root, f"{split}.src"), "w") as f:
            f.write("\n".join(src))
        with open(os.path.join(root, f"{split}.tgt"), "w") as f:
            f.write("\n".join(" ".join(w[::-1] for w in s.split()[::-1])
                              for s in src))
    return root


def _lines(root):
    with open(os.path.join(root, "train.txt")) as f:
        return list(f)


def test_bpe_matches_reference(tmp_path):
    """Training, the vocabulary, encode/decode and the saved file."""
    root = write_corpus(str(tmp_path))
    theirs = jbpe.BpeTokenizer.train(_lines(root), num_merges=200)
    ours = bpe.BpeTokenizer.train(_lines(root), num_merges=200)
    assert ours.merges == theirs.merges and ours.vocab == theirs.vocab
    assert len(ours.merges) == 200 and ours.vocab[:4] == bpe.SPECIALS
    for text in _lines(root)[:20] + ["unseen wordz qq", ""]:
        ids = ours.encode(text, add_bos=True)
        assert ids == theirs.encode(text, add_bos=True)
        assert ours.decode(ids) == theirs.decode(ids)
    for text in _lines(root)[:20]:  # every symbol known: a round trip
        assert ours.decode(ours.encode(text)) == " ".join(text.split())
    ours.save(str(tmp_path / "ours.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()
    back = bpe.BpeTokenizer.load(str(tmp_path / "theirs.json"))
    assert back.merges == ours.merges and back.vocab == ours.vocab


def _same(got, want):
    """The port's (x, y) int64 tensors equal the reference's arrays."""
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device == CPU
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


KEYS = [(0, 0, True), (0, 3, True), (1, 0, True), (2, 5, True),
        (0, 0, False), (0, 1, False)]


def test_text_corpus_batches_equal_reference(tmp_path, specs):
    """Document-packed [T+1] windows, the per-epoch order and the test
    split: every batch's ids equal the reference's."""
    ours_dir = write_corpus(str(tmp_path / "a"))
    theirs_dir = write_corpus(str(tmp_path / "b"))
    spec, jspec = specs["tinytext"]
    ours = TextCorpusData(ours_dir, spec, B, CPU, seed=3,
                          steps_per_epoch=7)
    theirs = JaxText(theirs_dir, jspec, B, seed=3, steps_per_epoch=7)
    assert ours.num_tokens == theirs.num_tokens
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 7
    assert ours.steps_per_epoch(False) == theirs.steps_per_epoch(False)
    assert (tmp_path / "a" / "bpe_vocab.json").read_bytes() == \
        (tmp_path / "b" / "bpe_vocab.json").read_bytes()
    for e, s, train in KEYS:
        x, y = ours.batch(e, s, train)
        _same((x, y), theirs.batch(e, s, train))
        assert x.shape == (B, 32) and torch.equal(x[:, 1:], y[:, :-1])
    assert not torch.equal(ours.batch(0, 0)[0], ours.batch(1, 0)[0])


def test_translation_batches_and_padding_report_equal_reference(
        tmp_path, specs):
    """The packed [src pad | BOS tgt EOS pad] rows, the source and pad
    masks, the per-epoch order, padding_efficiency and bucketing_report
    equal the reference's."""
    ours_dir = write_corpus(str(tmp_path / "a"))
    theirs_dir = write_corpus(str(tmp_path / "b"))
    spec, jspec = specs["tinymt2"]
    ours = TranslationData(ours_dir, spec, B, CPU, seed=2)
    theirs = JaxMT(theirs_dir, jspec, B, seed=2)
    assert find_parallel_corpus(ours_dir, "test") is not None
    for e, s, train in KEYS:
        x, y = ours.batch(e, s, train)
        _same((x, y), theirs.batch(e, s, train))
        assert (y[:, :spec.src_len - 1] == -1).all()
        assert ((x == bpe.PAD) <= (y == -1)).all()
    for train in (True, False):
        assert ours.padding_efficiency(train) == \
            theirs.padding_efficiency(train)
        assert ours.bucketing_report(train=train) == \
            theirs.bucketing_report(train=train)
    rep = ours.bucketing_report()
    assert 0 < rep["fixed_efficiency"] < rep["bucketed_efficiency"] <= 1


@pytest.mark.parametrize("kind", ["tokens", "seq2seq"])
def test_ondisk_token_stores_equal_reference(tmp_path, kind):
    """A generated store's (T+1, 4, 1) bytes as little-endian int32 ids
    modulo the vocabulary, the two next-token shifts, a seq2seq stream's
    source labels masked: every batch equal to the reference's, in the
    loader's shuffled order."""
    kw = dict(TEXT if kind == "tokens" else MT, name=f"store_{kind}",
              num_classes=1000)
    spec, jspec = config.DatasetSpec(**kw), jconfig.DatasetSpec(**kw)
    for split, count in (("train", 12), ("test", 4)):
        native_loader.generate_dataset(str(tmp_path), spec, split,
                                       count=count, seed=5)
    ours = ondisk.OnDiskData(str(tmp_path), spec, B, CPU, seed=5)
    theirs = JaxOnDisk(str(tmp_path), jspec, B, seed=5)
    try:
        assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 3
        for e, s, train in KEYS[:4] + KEYS[4:5]:
            x, y = ours.batch(e, s, train)
            _same((x, y), theirs.batch(e, s, train))
            assert int(x.max()) < 1000 and int(x.min()) >= 0
            if kind == "seq2seq":
                assert (y[:, :spec.src_len - 1] == -1).all()
                assert (y[:, spec.src_len - 1:] >= 0).all()
    finally:
        ours.close()
        theirs.close()


def test_make_data_picks_each_source(tmp_path, specs):
    """Synthetic; a parallel corpus for a seq2seq benchmark, a text
    corpus for a token benchmark; else the on-disk store (generated),
    as the reference's _make_data routes them."""
    corpus = write_corpus(str(tmp_path / "corpus"))

    def cfg(bench, **kw):
        return RunConfig(benchmark=bench, arch="transformer_t",
                         batch_size=B, steps_per_epoch=2, **kw)

    assert isinstance(make_data(cfg("tinytext"), CPU), SyntheticData)
    src = make_data(cfg("tinymt2", synthetic=False, data_dir=corpus), CPU)
    assert isinstance(src, TranslationData)
    src = make_data(cfg("tinytext", synthetic=False, data_dir=corpus), CPU)
    assert isinstance(src, TextCorpusData)
    assert not getattr(src, "stateful_stream", False)
    empty = str(tmp_path / "empty")
    for bench in ("tinytext", "tinymt2"):
        src = make_data(cfg(bench, synthetic=False, data_dir=empty), CPU)
        try:
            assert isinstance(src, ondisk.OnDiskData) and src.stateful_stream
            x, y = src.batch(0, 0)
            assert x.shape == (B, 32) and x.dtype == torch.int64
        finally:
            src.close()


@pytest.mark.parametrize("arch,bench", [("transformer_moe_t", "tinytext"),
                                        ("seq2seq_lstm_t", "tinymt2")])
def test_cli_trains_on_a_corpus(tmp_path, specs, capsys, arch, bench):
    """``-s --data-dir`` on the CPU: the corpus line, the reference's
    train/valid lines and a finite result."""
    corpus = write_corpus(str(tmp_path))
    rc = cli.main(["-b", bench, "-m", arch, "-s", "--data-dir", corpus,
                   "-e", "1", "--steps-per-epoch", "3", "-p", "1",
                   "--batch-size", str(B), "--dtype", "float32",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("text corpus: " if bench == "tinytext"
            else "translation data: vocab ") in out
    assert "valid accuracy: " in out
    result = json.loads(out.split("result: ", 1)[1].splitlines()[0])
    assert result["samples_per_sec"] > 0
    losses = [float(m) for m in re.findall(r"^train \|.*\| loss (\S+)", out,
                                            re.M)]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)


FLAGS = [(["--label-smoothing", "0.2"], "label_smoothing", 0.2),
         (["--attention-backend", "xla"], "attention_backend", "xla"),
         (["--no-fused-head-loss"], "fused_head_loss", False),
         (["--remat-layers"], "remat_layers", True),
         (["--moe-aux-weight", "0.05"], "moe_aux_weight", 0.05),
         (["--moe-capacity-factor", "2.0"], "moe_capacity_factor", 2.0)]


@pytest.mark.parametrize("argv,field,value", FLAGS)
def test_token_flag_reaches_run_config(argv, field, value):
    """Each token knob maps onto RunConfig as the reference's CLI maps
    it, default and set."""
    base = ["-b", "synthtext", "-m", "transformer_s"]
    for extra in ([], argv):
        ours = cli.config_from_args(cli.build_parser().parse_args(
            base + extra))
        theirs = jax_config_from_args(jax_cli_parser().parse_args(
            base + extra))
        assert getattr(ours, field) == getattr(theirs, field)
    assert getattr(ours, field) == value
    assert getattr(RunConfig(), field) == getattr(jconfig.RunConfig(), field)
