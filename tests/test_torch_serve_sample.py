"""The port's sampled decoding (ddlbench_tpu_torch/serve/engine.py
``sample_token``, ``_emit_token`` and the logits-returning passes) held
against the JAX reference on the CPU.

``sample_token`` is a copy of the reference's — float64 softmax, the
stable argsort for top-k (ties by vocab index), one uniform from
``random.Random(f"{seed}:{rid}:{token_index}")`` and a right-sided
searchsorted — so on the same logits it must return the same token, ties
included. With the reference's weights carried over (convert.py), the
port's logits match the reference's to a few ulps, so the sampled streams
of continuous, static, eviction-heavy and full-prefix-hit runs must be
IDENTICAL to the reference's, with equal ``token_times`` and
``stats_summary()``. Eviction regenerates a sampled stream because the
draw is keyed by token index, not by engine step: a sampler keyed by step
is a planted fault the eviction check must reject. Speculative decoding
with sampling is refused, as in the reference.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import numpy as np
import pytest

from tiny_models import TINY_LM

from ddlbench_tpu.config import ServeConfig as JaxServeConfig
from ddlbench_tpu.serve.engine import sample_token as jax_sample_token

from ddlbench_tpu_torch.config import ServeConfig
from ddlbench_tpu_torch.serve.engine import ServeEngine, sample_token
from ddlbench_tpu_torch.serve.workload import ServeRequest

from test_torch_serve import CONFIGS, CPU, _drain
from test_torch_serve_prefix import port_lm, run_both  # noqa: F401

pytestmark = pytest.mark.torchport

VOCAB = TINY_LM.num_classes
SAMPLE = dict(temperature=0.8, top_k=8, sample_seed=7)


@pytest.mark.parametrize("temperature,top_k,ties", [
    (0.8, 0, False), (0.8, 40, False), (1.0, 5, True), (0.3, 1, True),
    (2.0, 64, True)])
def test_sample_token_is_the_references(temperature, top_k, ties):
    rng = np.random.default_rng(11)
    for draw in range(40):
        if ties:
            # few distinct values: top-k cuts through runs of equal logits
            logits = rng.integers(0, 4, size=VOCAB).astype(np.float32)
        else:
            logits = rng.standard_normal(VOCAB).astype(np.float32) * 3
        rid, tok = draw % 5, draw // 5
        want = jax_sample_token(logits, temperature, top_k, 3, rid, tok)
        got = sample_token(logits, temperature, top_k, 3, rid, tok)
        assert got == want, (draw, got, want)
        if top_k:
            order = np.argsort(-logits.astype(np.float64), kind="stable")
            assert got in set(order[:top_k].tolist())


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(s,)).astype(np.int32) for s in lens]


@pytest.mark.parametrize("name,policy", [
    ("chunked", "continuous"), ("chunked", "static"),
    ("eviction", "continuous")])
def test_sampled_streams_identical_to_jax(serve_factory, port_lm, name,
                                          policy):
    kw, seed, lens, max_new = CONFIGS[name]
    kw = dict(kw, policy=policy, **SAMPLE)
    jeng, teng = run_both(serve_factory, port_lm, kw, _prompts(seed, lens),
                          max_new)
    if name == "eviction":
        assert teng.stats["evicted"] > 0
    # sampling, not greedy: the streams are not the argmax streams
    greedy = ServeEngine(port_lm, ServeConfig(**CONFIGS[name][0]), CPU)
    got = _drain(greedy, [ServeRequest(rid=i, prompt=p, max_new=max_new,
                                       arrival=0.0)
                          for i, p in enumerate(_prompts(seed, lens))])
    assert any(f["tokens"] != got[f["rid"]]["tokens"]
               for f in teng.finished)


def test_sampled_full_prefix_hit_identical_to_jax(serve_factory, port_lm):
    """A full page-aligned hit skips prefill; its first token is sampled
    from the decode pass's logits at token index 0."""
    kw = dict(max_batch=2, pool_pages=17, page=4, max_len=16,
              prefill_chunk=4, prefix_cache=True, **SAMPLE)
    head = _prompts(5, [8])[0]
    prompts = [head, head, head]  # the second and third are full hits
    jeng, teng = run_both(serve_factory, port_lm, kw, prompts, 5, n_seq=1)
    assert teng.stats["cow_copies"] >= 2
    assert teng.stats["prefix_hits"] >= 2


def _evicting_streams(port_lm, pool_pages):
    """Two 9-token prompts, 12 tokens each, sampled, on a pool of
    ``pool_pages``: 9 pages evict, 17 do not. Returns (streams,
    evictions)."""
    kw, seed, lens, max_new = CONFIGS["eviction"]
    eng = ServeEngine(port_lm, ServeConfig(
        **dict(kw, pool_pages=pool_pages, **SAMPLE)), CPU)
    got = _drain(eng, [ServeRequest(rid=i, prompt=p, max_new=max_new,
                                    arrival=0.0)
                       for i, p in enumerate(_prompts(seed, lens))])
    return {r: f["tokens"] for r, f in got.items()}, eng.stats["evicted"]


def eviction_regenerates_streams(port_lm) -> bool:
    """The check: an evicting run's sampled streams equal a roomy run's."""
    roomy, ev0 = _evicting_streams(port_lm, 17)
    tight, ev1 = _evicting_streams(port_lm, 9)
    assert ev0 == 0 and ev1 > 0
    return roomy == tight


def test_eviction_regenerates_sampled_streams(port_lm):
    assert eviction_regenerates_streams(port_lm)


def test_sampler_keyed_by_step_is_rejected(port_lm, monkeypatch):
    """Planted fault: the draw keyed by engine step in place of token
    index. Recompute then re-draws different tokens, and the eviction
    check must fail."""
    def by_step(self, raw, rid, token_index):
        return sample_token(raw, self.cfg.temperature, self.cfg.top_k,
                            self.cfg.sample_seed, rid,
                            int(self.stats["steps"]))

    monkeypatch.setattr(ServeEngine, "_emit_token", by_step)
    assert not eviction_regenerates_streams(port_lm)


def test_sampling_config_rules_match_reference():
    for kw in (dict(temperature=-0.1), dict(top_k=-1), dict(top_k=4),
               dict(temperature=0.8, speculative="ngram:2:3"),
               dict(flight_recorder=-1)):
        with pytest.raises(ValueError) as want:
            JaxServeConfig(**kw).validate()
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw).validate()
        assert str(got.value) == str(want.value)
    ServeConfig(temperature=0.8, top_k=5, flight_recorder=0).validate()
