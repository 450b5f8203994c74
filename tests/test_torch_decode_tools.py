"""The port's decode tools on the CPU: tools/decodebench.py (the mirror of
tests/test_decode.py's decodebench case) and tools/mtacc.py (the mirror of
tests/test_mtacc.py, whose two cases the reference marks slow; the port's
train the d-32 model for 400 steps in about 15 s each).

decodebench: six decode rows on a tiny registered seq2seq spec, each with
the port's provenance; with ``--chunk-prefill --kv-dtype`` every kernel
row ``skipped`` (no card) beside its plain row; the reference's refused
flag and value named by their ROADMAP items; a failed row kept as
``error`` with the exit code 1. mtacc: the gate (every path's sequence
accuracy >= 0.95, greedy equal to the full-forward greedy) and the noisy
variant (token accuracy within 0.05 of the Bayes ceiling, below 1).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import unittest.mock as mock

import pytest

import ddlbench_tpu_torch.models.seq2seq as s2s
from ddlbench_tpu_torch.config import DatasetSpec
from ddlbench_tpu_torch.tools import decodebench, mtacc

pytestmark = pytest.mark.torchport

TINY = dict(d_model=32, n_layers=2, n_heads=4)
TINY_MTB = DatasetSpec("tinymtb", (16,), 64, 100, 10, kind="seq2seq",
                       src_len=8)
BENCH = ["-m", "seq2seq_bench_t", "-b", "tinymtb", "--batch", "2", "--beam",
         "2", "--repeats", "1", "--device", "cpu"]
PROVENANCE = ("schema_version", "platform", "device_kind", "device_count",
              "torch_version", "cuda_version")


@pytest.fixture
def tiny_bench():
    s2s._VARIANTS["seq2seq_bench_t"] = TINY
    with mock.patch.dict("ddlbench_tpu_torch.config.DATASETS",
                         {"tinymtb": TINY_MTB}):
        yield
    del s2s._VARIANTS["seq2seq_bench_t"]


def _rows(capsys):
    return [json.loads(line)
            for line in capsys.readouterr().out.splitlines()]


def test_decodebench_tool(tiny_bench, capsys):
    assert decodebench.main(BENCH) == 0
    rows = _rows(capsys)
    assert len(rows) == 6
    assert {(r["mode"], r["variant"]) for r in rows} == {
        ("greedy", "paged"), ("beam", "paged"), ("greedy", "cached"),
        ("beam", "cached"), ("greedy", "full"), ("beam", "full")}
    for r in rows:
        assert r["tokens_per_sec"] > 0 and r["plain_launches"] == 0
        assert r["platform"] == "cpu" and r["device_kind"] == "cpu"
        assert all(k in r for k in PROVENANCE)
        assert r["new_tokens"] == 2 * (16 - 8)
        assert r["beam"] == (2 if r["mode"] == "beam" else 1)


def test_decodebench_kernel_rows_skipped_on_the_cpu(tiny_bench, capsys):
    argv = BENCH + ["--skip-uncached", "--chunk-prefill", "--chunk-sizes",
                    "16", "--chunk-pages", "2", "--chunk-page-size", "16",
                    "--kv-dtype", "float32,bfloat16,int8",
                    "--cache-dtype", "bfloat16"]
    assert decodebench.main(argv) == 0
    rows = _rows(capsys)
    decode = [r for r in rows if "mode" in r]
    assert len(decode) == 4
    assert {r["cache_dtype"] for r in decode if r["variant"] == "paged"} \
        == {"bfloat16"}
    chunk = [r for r in rows if r["variant"].startswith("chunk-")]
    kv = [r for r in rows if r["variant"] == "kv-dtype"]
    assert len(chunk) == 2 and len(kv) == 3 * 2 * 2
    for r in chunk + kv:
        assert all(k in r for k in PROVENANCE)
        kernel = r.get("kernel", r["variant"] == "chunk-kernel")
        if kernel:
            assert "skipped" in r and "tokens_per_sec" not in r
        else:
            assert r["tokens_per_sec"] > 0
    assert {r["kv_dtype"] for r in kv} == {"float32", "bfloat16", "int8"}
    assert not any("error" in r for r in rows)


@pytest.mark.parametrize("argv,item", [
    (["--paged-kernel", "elementwise"], "ROADMAP A.8"),
    (["--cache-dtype", "int8"], "ROADMAP C.10"),
])
def test_decodebench_refusals_name_their_item(tiny_bench, capsys, argv,
                                              item):
    with pytest.raises(SystemExit) as e:
        decodebench.main(BENCH + argv)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_decodebench_error_row_fails_the_run(tiny_bench, capsys):
    """A row whose run raises is recorded as ``error`` (the reference's
    row) and the sweep goes on; the port then exits 1."""
    def broken(*a, **k):
        raise RuntimeError("planted")

    with mock.patch.object(decodebench.dec, "greedy_decode", broken):
        rc = decodebench.main(BENCH + ["--skip-uncached"])
    rows = _rows(capsys)
    assert rc == 1
    errors = [r for r in rows if "error" in r]
    assert [(r["mode"], r["variant"]) for r in errors] == [
        ("greedy", "paged"), ("greedy", "cached")]
    assert errors[0]["error"] == "RuntimeError: planted"
    assert len(rows) == 4


def _mtacc(capsys, argv):
    rc = mtacc.main(["--device", "cpu", "--eval-size", "32"] + argv)
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, doc


def test_seq2seq_trains_to_sequence_accuracy(capsys):
    rc, doc = _mtacc(capsys, [])
    assert rc == 0 and doc["pass"], doc
    assert set(doc["seq_accuracy"]) == {"greedy", "beam", "paged_beam",
                                        "full_forward_greedy"}
    for name, acc in doc["seq_accuracy"].items():
        assert acc >= 0.95, (name, acc)
    assert doc["greedy_equals_full_forward"]
    assert doc["seq_accuracy"]["greedy"] == \
        doc["seq_accuracy"]["full_forward_greedy"]
    assert doc["platform"] == "cpu"


def test_noisy_variant_has_headroom(capsys):
    rc, doc = _mtacc(capsys, ["--noise", "0.15", "--steps", "400"])
    assert rc == 0 and doc["pass"], doc
    ceiling = doc["token_ceiling"]
    assert 0.0 < ceiling < 1.0
    for name, acc in doc["token_accuracy"].items():
        assert ceiling - 0.05 <= acc < 1.0, (name, acc, ceiling)
