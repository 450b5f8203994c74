"""The port's lmbench (ddlbench_tpu_torch/tools/lmbench.py) end to end on
the CPU, following tests/test_lmbench.py: one row per configuration with
the reference row's keys, and the fused configurations refused by name."""

import json

import pytest
import torch

import ddlbench_tpu_torch.config as config
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


@pytest.mark.parametrize("extra,configs", [
    (["--dtype", "float32"], {"flash+logits", "xla+logits"}),
    (["--configs", "auto"], {"auto"}),
])
def test_lmbench_rows(capsys, tinylm, extra, configs):
    assert lmbench.main(tinylm + extra) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert {r["config"] for r in rows} == configs and len(rows) == len(configs)
    for r in rows:
        assert ROW_KEYS <= set(r)
        assert r["tokens_per_sec"] > 0 and r["ms_per_step"] > 0
        assert r["seq_len"] == TINY_LM.seq_len and r["batch"] == 2
        assert r["platform"] == "cpu" and r["remat"] is False


@pytest.mark.parametrize("configs", ["flash+fused", "xla+logits,xla+fused"])
def test_lmbench_refuses_fused_configs(capsys, tinylm, configs):
    with pytest.raises(SystemExit) as e:
        lmbench.main(tinylm + ["--configs", configs])
    assert e.value.code != 0
    assert "B4-B6" in capsys.readouterr().err


def test_lmbench_without_gpu_or_cpu_flag_raises(monkeypatch, tinylm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lmbench.main([a for a in tinylm if a not in ("--device", "cpu")])
