"""The port's lmbench (ddlbench_tpu_torch/tools/lmbench.py) end to end on
the CPU, following tests/test_lmbench.py: one row per configuration with
the reference row's keys, for the four forced cells (flash/xla attention x
fused head/logits), ``auto``, and a seq2seq (prefix-LM) benchmark."""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json

import pytest
import torch

import ddlbench_tpu_torch.config as config
import ddlbench_tpu_torch.models.seq2seq as s2s
from ddlbench_tpu_torch.tools import lmbench
from tiny_models import TINY_LM

pytestmark = pytest.mark.torchport

# the keys of the reference's row (ddlbench_tpu/tools/lmbench.py) before
# its backend provenance, which device.provenance() replaces
ROW_KEYS = {"config", "model", "benchmark", "batch", "seq_len", "remat",
            "tokens_per_sec", "ms_per_step"}


@pytest.fixture
def tinylm():
    config.DATASETS["tinylm"] = config.DatasetSpec(
        "tinylm", TINY_LM.image_size, TINY_LM.num_classes, TINY_LM.train_size,
        TINY_LM.test_size, kind="tokens")
    config.DEFAULT_BATCH["single"]["tinylm"] = 2
    yield ["-m", "transformer_t", "-b", "tinylm", "--steps", "2",
           "--warmup", "1", "--device", "cpu"]
    del config.DATASETS["tinylm"]
    del config.DEFAULT_BATCH["single"]["tinylm"]


def _rows(capsys, argv, configs, seq_len):
    assert lmbench.main(argv) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["config"] for r in rows] == list(configs)
    for r in rows:
        assert ROW_KEYS <= set(r)
        assert r["tokens_per_sec"] > 0 and r["ms_per_step"] > 0
        assert r["seq_len"] == seq_len and r["batch"] == 2
        assert r["platform"] == "cpu" and r["remat"] is False
        # the CPU path is the plain versions by design, never counted
        assert r["plain_launches"] == 0
    return rows


@pytest.mark.parametrize("extra,configs", [
    (["--dtype", "float32"], lmbench.DEFAULT_SWEEP),
    (["--configs", "auto"], ("auto",)),
])
def test_lmbench_rows(capsys, tinylm, extra, configs):
    _rows(capsys, tinylm + extra, configs, TINY_LM.seq_len)


@pytest.mark.parametrize("configs", ["flash+fused", "xla+logits,xla+fused"])
def test_lmbench_fused_config_rows(capsys, tinylm, configs):
    _rows(capsys, tinylm + ["--dtype", "float32", "--configs", configs],
          configs.split(","), TINY_LM.seq_len)


@pytest.fixture
def tinymt(monkeypatch):
    """A tiny synthmt: T 16 with an 8-token source, vocab 64, and the
    seq2seq_t model (tests/test_seq2seq.py's sizes)."""
    monkeypatch.setitem(config.DATASETS, "tinymt", config.DatasetSpec(
        "tinymt", (16,), 64, 1000, 100, kind="seq2seq", src_len=8))
    monkeypatch.setitem(config.DEFAULT_BATCH["single"], "tinymt", 2)
    monkeypatch.setitem(s2s._VARIANTS, "seq2seq_t",
                        dict(d_model=32, n_layers=2, n_heads=4))
    return ["-m", "seq2seq_t", "-b", "tinymt", "--steps", "2", "--warmup",
            "1", "--device", "cpu", "--dtype", "float32"]


def test_lmbench_seq2seq_rows(capsys, tinymt):
    """A seq2seq benchmark trains through the prefix path and the fused
    head (label smoothing 0.1 and Adam by default)."""
    _rows(capsys, tinymt + ["--configs", "flash+fused,flash+logits"],
          ["flash+fused", "flash+logits"], 16)


def test_lmbench_without_gpu_or_cpu_flag_raises(monkeypatch, tinylm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lmbench.main([a for a in tinylm if a not in ("--device", "cpu")])
