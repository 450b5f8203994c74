"""The port's speculative verify (ddlbench_tpu_torch/serve/draft.py, the
verify ops of models/, the engine's draft planning, acceptance and
rollback), the three serving levers together at int8, and servebench's
lever flags, held against the JAX reference on the CPU.

The drafter must propose what the reference's proposes. With the
reference's weights carried over, the port's engine must emit token
streams and ``token_times`` IDENTICAL to the JAX engine's, with an equal
``stats_summary()``, under the real n-gram drafter and under scripted
drafters that are always right, always wrong or right only at first (both
engines get the same one), through eviction mid-draft and the static
policy's reservation; greedy acceptance keeps the streams those of plain
decoding. Then int8 + prefix cache + speculation together, and the
servebench row with all four flags equal to the JAX row on every
virtual-time field.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import random
import unittest.mock as mock

import numpy as np
import pytest
import torch

from tiny_models import TINY_LM
from test_torch_serve_prefix import _serve, port_lm, run_both  # noqa: F401

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.draft import NgramDrafter as JaxDrafter

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, ServeConfig
from ddlbench_tpu_torch.serve.draft import NgramDrafter
from ddlbench_tpu_torch.serve.engine import ServeEngine
from ddlbench_tpu_torch.serve.workload import ServeRequest
from ddlbench_tpu_torch.tools import servebench

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
CPU = torch.device("cpu")
_CFG = dict(max_batch=2, pool_pages=17, page=4, max_len=16, prefill_chunk=4)


def test_drafter_matches_reference():
    rng = random.Random(3)
    for _ in range(300):
        n, k = rng.randint(1, 3), rng.randint(1, 4)
        ctx = [rng.randrange(4) for _ in range(rng.randint(0, 14))]
        k_max = rng.choice([None, 0, 1, 2, 5])
        assert NgramDrafter(n, k).propose(ctx, k_max) == \
            JaxDrafter(n, k).propose(ctx, k_max)
    d = NgramDrafter(2, 3)
    assert d.propose([5, 7, 8, 9, 1, 7, 8]) == [9, 1, 7]
    assert d.propose([1, 2, 3, 1, 2, 5, 9, 1, 2]) == [5, 9, 1]
    assert d.propose([4, 4, 4, 4, 4]) == [4, 4, 4]
    for bad in ((0, 3), (2, 0)):
        with pytest.raises(ValueError):
            NgramDrafter(*bad)


@pytest.mark.parametrize("spec", ["ngram:2:3", "ngram:1:1", "ngram:2",
                                  "foo:2:3", "ngram:a:3", "ngram:0:3",
                                  "ngram:2:0", "ngram:2:16"])
def test_spec_config_rules_match_reference(spec):
    def outcome(cfg):
        try:
            cfg.validate()
        except ValueError:
            return "ValueError"
        return cfg.spec_params()

    assert outcome(ServeConfig(speculative=spec)) == \
        outcome(JaxServeConfig(speculative=spec))


class _Scripted:
    """A drafter proposing each request's plain-decoding continuation
    (the request is told by its prompt), every draft from index
    ``wrong_from`` on shifted off the true token: 0 rejects everything, a
    large value accepts everything."""

    def __init__(self, streams, k, wrong_from):
        self.streams = streams  # prompt tuple -> plain token stream
        self.k = k
        self.wrong_from = wrong_from

    def propose(self, context, k_max=None):
        prompt = max((p for p in self.streams
                      if tuple(context[:len(p)]) == p), key=len)
        done = len(context) - len(prompt)
        k = self.k if k_max is None else min(self.k, k_max)
        out = list(self.streams[prompt][done:done + k])
        return [(t + 1) % VOCAB if j >= self.wrong_from else t
                for j, t in enumerate(out)]


def _streams(port_lm, kw, prompts, max_new, n_seq=0):
    """Each prompt's plain-decoding stream (the port's engine, no
    speculation)."""
    eng = ServeEngine(port_lm, ServeConfig(**kw), CPU)
    done = _serve(eng, ServeRequest, prompts, max_new, n_seq)
    return {tuple(int(t) for t in prompts[r]): f["tokens"]
            for r, f in done.items()}


_PROMPTS = [np.random.default_rng(31).integers(0, VOCAB, size=(6,)),
            np.tile(np.random.default_rng(32).integers(0, VOCAB, size=(3,)),
                    3)]

# name -> (config, drafter's first wrong draft or None for the real one)
SPEC_CASES = {
    "ngram": (_CFG, None),
    "always_right": (_CFG, 99),
    "always_wrong": (_CFG, 0),
    "right_at_first": (_CFG, 1),
    # 4 usable pages: the two rows collide and one is evicted mid-draft
    "eviction": (dict(_CFG, pool_pages=5), 1),
    # static admission reserves the worst case; rollback must keep it
    "static": (dict(_CFG, pool_pages=7, policy="static"), 1),
}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_spec_engine_streams_identical_to_jax(serve_factory, port_lm, name):
    kw, wrong_from = SPEC_CASES[name]
    max_new = 7
    plain = _streams(port_lm, kw, _PROMPTS, max_new)
    drafter = None
    if wrong_from is not None:
        drafter = lambda: _Scripted(plain, 3, wrong_from)  # noqa: E731
    spec = dict(kw, speculative="ngram:1:3" if name == "ngram"
                else "ngram:2:3")
    _, teng = run_both(serve_factory, port_lm, spec, _PROMPTS, max_new,
                       drafter=drafter)
    s = teng.stats_summary()
    assert s["spec_passes"] > 0 and s["spec_drafted"] > 0
    # greedy acceptance: the streams of plain decoding
    assert {tuple(int(t) for t in _PROMPTS[f["rid"]]): f["tokens"]
            for f in teng.finished} == plain
    if name == "always_right":
        assert s["spec_accept_rate"] == 1.0 and s["tokens_per_pass"] > 1.0
    if name == "always_wrong":
        assert s["spec_accepted"] == 0 and s["tokens_per_pass"] == 1.0
    if name == "right_at_first":
        assert 0.0 < s["spec_accept_rate"] < 1.0
    if name == "eviction":
        assert s["evicted"] >= 1
    assert teng.allocator.in_use == 0


def test_all_levers_at_int8_identical_to_jax(serve_factory, port_lm):
    """int8 pool + prefix cache + speculative verify together, on shared
    prefixes: full hits enter decode and then verify through copied int8
    pages and their scales."""
    rng = np.random.default_rng(47)
    head = rng.integers(0, VOCAB, size=(8,))
    prompts = [head, np.concatenate([head, rng.integers(0, VOCAB, (3,))]),
               head, head.copy()]
    kw = dict(_CFG, max_len=24, kv_dtype="int8")
    plain = _streams(port_lm, kw, prompts, 6, n_seq=2)
    _, teng = run_both(
        serve_factory, port_lm,
        dict(kw, prefix_cache=True, speculative="ngram:2:3"), prompts, 6,
        n_seq=2, drafter=lambda: _Scripted(plain, 3, 2))
    s = teng.stats_summary()
    assert s["prefix_hits"] >= 2 and s["cow_copies"] >= 2
    assert s["spec_drafted"] > 0 and 0.0 < s["spec_accept_rate"] < 1.0
    assert {tuple(int(t) for t in prompts[f["rid"]]): f["tokens"]
            for f in teng.finished} == plain


def test_engine_refuses_writes_past_the_rounding_table(port_lm):
    eng = ServeEngine(port_lm, ServeConfig(**_CFG, kv_dtype="int8"), CPU)
    assert eng.n_write_pos == 16 + 4
    assert eng.pools[1]["kv_seed"] == 1  # the embedding is layer 0
    assert eng.pools[1]["kv_u"].shape == (2, 20, 4, 8)
    with pytest.raises(ValueError, match="rounding table"):
        eng._check_write_positions(20)
    eng._check_write_positions(19)


SERVEBENCH_ARGS = [
    "-m", "transformer_t", "-b", "tinylm", "--arrival", "closed",
    "--concurrency", "4", "--requests", "8", "--max-batch", "2",
    "--pool-pages", "13", "--page", "4", "--max-len", "24",
    "--prompt-lens", "1,3,6", "--out-lens", "2,6,10",
    "--slo-ttft", "8", "--slo-itl", "2.5", "--seed", "5",
    "--kv-dtype", "int8", "--shared-prefix", "2:4", "--prefix-cache",
    "--speculative", "ngram:2:3",
]
_JAX_PROV = {"schema_version", "jax_backend", "jax_device_count",
             "cpu_requested", "cpu_fallback"}
# the port's provenance keys, and its count of plain-path calls on CUDA
_PORT_PROV = {"schema_version", "platform", "device_kind", "device_count",
              "torch_version", "cuda_version", "plain_launches"}


def test_servebench_levers_row_equals_jax_row(capsys, serve_factory,
                                              port_lm):
    import ddlbench_tpu.config as jconfig
    from ddlbench_tpu.tools import servebench as jax_servebench

    patched = dict(jconfig.DATASETS)
    patched["tinylm"] = TINY_LM
    with mock.patch.dict("ddlbench_tpu.config.DATASETS", patched):
        assert jax_servebench.main(SERVEBENCH_ARGS
                                   + ["--platform", "cpu"]) == 0
    jrows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]

    tiny = DatasetSpec("tinylm", TINY_LM.image_size, VOCAB, 1000, 100,
                       kind="tokens")
    args = servebench.build_parser().parse_args(
        SERVEBENCH_ARGS + ["--device", "cpu"])
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": tiny}):
        trows = [rec for rec, _, _ in servebench.run(args, port_lm, CPU)]
    assert [r["policy"] for r in trows] == [r["policy"] for r in jrows] \
        == ["continuous", "static"]
    for t, j in zip(trows, jrows):
        assert set(t) - _PORT_PROV == set(j) - _JAX_PROV
        for k in set(j) - _JAX_PROV:
            assert t[k] == j[k], k
        assert t["completed"] == 8 and t["kv_dtype"] == "int8"
        assert t["speculative"] == "ngram:2:3"
    cont = trows[0]
    assert cont["prefix_cache"] and cont["prefix_hits"] > 0
    assert cont["pool_bytes"] * 4 == 2 * 13 * 4 * 32 * 4 * 2
    assert not trows[1]["prefix_cache"] and trows[1]["prefix_hits"] == 0
