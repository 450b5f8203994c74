"""The port's gradient accumulation held against the JAX reference's
``accum_loss_and_grads`` on the CPU.

On the tiny BatchNorm ResNet and MobileNetV2 of test_torch_image_train
(8x8 inputs, 10 classes), from the same weights and statistics, float32:

* K = 1 through ``accum_loss_and_grads`` equals the plain step bit for
  bit;
* K = 2 and 4 over a batch of 8: the loss within 1e-5 absolute of the
  reference's K-step loss, every gradient leaf and every running
  statistic (after K sequential updates) within 1e-4 relative L2, with
  test_torch_image_train's floor;
* the split is every K-th row: a planted contiguous-chunk split breaks
  those bars;
* one SGD step with K = 2 of the port's SingleStrategy matches the
  reference's single strategy at the same learning rate (single scales
  nothing by K), and the CLI's loop hands the step the resolved rate.

On the token paths, K = 2 over a batch of 4, float32: transformer_t on
tests/tiny_models.py's TINY_LM and a tiny seq2seq_t (test_torch_seq2seq's
sizes, its source labels masked, label smoothing 0.1), through the fused
LM head and through the logits, the xla attention backend (and flash,
the reference's Pallas kernels in interpret mode, for transformer_t).
One row has extra masked labels, so the two micro-steps count different
numbers of valid labels and their weights differ. The loss, the
(correct, valid) counts and every gradient leaf against the reference's
``accum_loss_and_grads`` at test_torch_train's tolerance (rtol 1e-4,
atol 1e-6); a planted uniform weighting of the micro-steps breaks it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.seq2seq as js2s
import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.common import (
    accum_loss_and_grads as jax_accum)
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
from ddlbench_tpu_torch.models import seq2seq as ts2s
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.parallel import common
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.train.loop import run_benchmark

from test_torch_image_train import (FLOOR, LEAF_RTOL, LOSS_ATOL, _batch,
                                    _leaves, _rel_l2, _to_port, tiny_pair)
from test_torch_train import _leaves as _token_leaves
from tiny_models import TINY_LM

pytestmark = pytest.mark.torchport

B = 8


def _pair(name, K):
    jm, tm = tiny_pair(name)
    jcfg = JaxRunConfig(benchmark="imagenet", arch="resnet50",
                        compute_dtype="float32", batch_size=B // K,
                        grad_accum_steps=K)
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(0))
    from_jax_params(tm, jax.device_get(ts.params))
    from_jax_state(tm, jax.device_get(ts.model_state))
    cfg = RunConfig(benchmark="imagenet", arch="resnet50",
                    compute_dtype="float32", batch_size=B // K,
                    grad_accum_steps=K)
    cfg.validate()
    assert cfg.global_batch() == jcfg.global_batch() == B
    return jm, tm, js, jcfg, ts, cfg


def _reference(jm, ts, x, y, K):
    """The reference's K-step (loss, grads, new state)."""
    _, ce, _, new_state, grads = jax.jit(
        lambda p, s, x, y: jax_accum(jm, p, s, x, y, jnp.float32, 0.0, 0.0,
                                     False, K))(
        ts.params, ts.model_state, jnp.asarray(x), jnp.asarray(y))
    return float(ce), grads, new_state


def _errors(tm, K, x, y, cfg, want_grads, want_state):
    ce, (correct, valid), grads = common.accum_loss_and_grads(
        tm, cfg, *_to_port(x, y), torch.float32, 0.0, K)
    assert int(valid) == B
    worst = {}
    for what, pairs in (
            ("grad", [(p.grad, g) for p, g in _leaves(tm, want_grads)]),
            ("stat", _leaves(tm, want_state, True))):
        floor = FLOOR * max(np.linalg.norm(w) for _, w in pairs)
        worst[what] = max(_rel_l2(g, w, floor) for g, w in pairs)
    return float(ce), worst


@pytest.mark.parametrize("name", ["mobilenet", "resnet"])
def test_k1_is_the_plain_step(name):
    _, tm, _, _, _, cfg = _pair(name, 1)
    x, y = _to_port(*_batch(0, B))
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    ce, stats, grads = common.accum_loss_and_grads(tm, cfg, x, y,
                                                   torch.float32, 0.0, 1)
    grads = [g.clone() for g in grads]
    tm.load_state_dict(state)
    ce1, stats1, grads1 = common.loss_and_grads(tm, cfg, x, y,
                                                torch.float32, 0.0)
    assert torch.equal(ce, ce1)
    assert all(int(a) == int(b) for a, b in zip(stats, stats1))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads1))


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("name", ["mobilenet", "resnet"])
def test_k_steps_match_jax(name, K):
    jm, tm, _, _, ts, cfg = _pair(name, K)
    x, y = _batch(1, B)
    want_ce, want_g, want_s = _reference(jm, ts, x, y, K)
    ce, worst = _errors(tm, K, x, y, cfg, want_g, want_s)
    assert abs(ce - want_ce) <= LOSS_ATOL
    assert worst["grad"] <= LEAF_RTOL and worst["stat"] <= LEAF_RTOL, worst


def _contiguous(t, K, k):
    """The planted fault: micro-step k takes rows [k B/K, (k+1) B/K)."""
    return t.reshape(K, t.shape[0] // K, *t.shape[1:])[k].contiguous()


@pytest.mark.parametrize("K", [2, 4])
def test_contiguous_split_is_rejected(monkeypatch, K):
    jm, tm, _, _, ts, cfg = _pair("resnet", K)
    x, y = _batch(1, B)
    want_ce, want_g, want_s = _reference(jm, ts, x, y, K)
    monkeypatch.setattr(common, "_micro_batch", _contiguous)
    ce, worst = _errors(tm, K, x, y, cfg, want_g, want_s)
    assert (abs(ce - want_ce) > LOSS_ATOL or worst["grad"] > LEAF_RTOL
            or worst["stat"] > LEAF_RTOL), (ce, want_ce, worst)


def test_single_step_takes_the_lr_unscaled():
    jm, tm, js, jcfg, ts, cfg = _pair("resnet", 2)
    x, y = _batch(2, B)
    lr = cfg.resolved_lr()
    ts, jmet = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                             jnp.float32(lr))
    ps = SingleStrategy(tm, cfg)
    ps.init()
    m = ps.train_step(*_to_port(x, y), lr)
    assert abs(m["loss"].item() - float(jmet["loss"])) <= LOSS_ATOL
    pairs = _leaves(tm, ts.params)
    floor = FLOOR * max(np.linalg.norm(w) for _, w in pairs)
    assert max(_rel_l2(p, w, floor) for p, w in pairs) <= LEAF_RTOL


def test_loop_passes_the_resolved_lr_with_accumulation():
    cfg = RunConfig(benchmark="cifar10", arch="resnet18", batch_size=2,
                    grad_accum_steps=2, epochs=1, steps_per_epoch=2,
                    compute_dtype="float32")
    _, tm = tiny_pair("resnet", (32, 32, 3))
    ps = SingleStrategy(tm, cfg)
    ps.init()
    seen = []
    step = ps.train_step

    def record(x, y, lr):
        seen.append((x.shape[0], lr))
        return step(x, y, lr)

    ps.train_step = record
    run_benchmark(cfg, ps, warmup_steps=1)
    assert seen == [(4, cfg.resolved_lr())] * 3


# ---- token and seq2seq paths --------------------------------------------

TOKEN_TOL = dict(rtol=1e-4, atol=1e-6)  # test_torch_train's
TOKEN_B, TOKEN_K = 4, 2
VOCAB, T = TINY_LM.num_classes, TINY_LM.seq_len
SRC = 8  # seq2seq_t's source length, as in test_torch_seq2seq
TINY_S2S = dict(d_model=32, n_layers=2, n_heads=4)


@pytest.fixture
def token_backend(request, monkeypatch):
    """Both packages' attention backend and the tiny seq2seq_t variant,
    restored afterwards."""
    monkeypatch.setitem(js2s._VARIANTS, "seq2seq_t", TINY_S2S)
    monkeypatch.setitem(ts2s._VARIANTS, "seq2seq_t", TINY_S2S)
    jtr.set_attention_backend(request.param)
    ttr.set_attention_backend(request.param)
    yield request.param
    jtr.set_attention_backend("auto")
    ttr.set_attention_backend("auto")


def _token_case(arch, fused, backend):
    """(reference model, its params and state, port model, port config,
    smoothing, x, y): one batch of TOKEN_B rows whose row 0 lies in
    micro-step 0 with 20 more labels masked than the others."""
    rng = np.random.default_rng(5)
    seq = rng.integers(0, VOCAB, (TOKEN_B, T + 1)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:].copy()
    if arch == "seq2seq_t":
        jm = js2s.build_seq2seq(arch, (T,), VOCAB, SRC)
        tm = ts2s.build_seq2seq(arch, (T,), VOCAB, SRC)
        y[:, :SRC - 1] = -1  # the source-internal labels
        bench, smoothing = "synthmt", 0.1
    else:
        jm = jtr.build_transformer(arch, (T,), VOCAB)
        tm = ttr.build_transformer(arch, (T,), VOCAB)
        bench, smoothing = "synthtext", 0.0
    y[0, -20:] = -1
    params, states, _ = init_model(jm, jax.random.key(0))
    from_jax_params(tm, jax.device_get(params))
    cfg = RunConfig(benchmark=bench, arch=arch, compute_dtype="float32",
                    attention_backend=backend, fused_head_loss=fused,
                    grad_accum_steps=TOKEN_K, batch_size=TOKEN_B // TOKEN_K)
    cfg.validate()
    assert cfg.resolved_label_smoothing() == smoothing
    return jm, params, states, tm, cfg, smoothing, x, y


def _token_violations(arch, fused, backend):
    """The port's K-step loss, counts and gradients against the
    reference's: the names of the quantities outside TOKEN_TOL."""
    jm, params, states, tm, cfg, smoothing, x, y = _token_case(
        arch, fused, backend)
    _, want_ce, (want_c, want_v), _, want_g = jax.jit(
        lambda p, s, x, y: jax_accum(jm, p, s, x, y, jnp.float32, 0.0,
                                     smoothing, fused, TOKEN_K))(
        params, states, jnp.asarray(x), jnp.asarray(y))
    micro_valid = [int((y[k::TOKEN_K] >= 0).sum()) for k in range(TOKEN_K)]
    assert len(set(micro_valid)) == TOKEN_K  # the weights differ
    ce, (c, v), grads = common.accum_loss_and_grads(
        tm, cfg, torch.from_numpy(x).long(), torch.from_numpy(y).long(),
        torch.float32, smoothing, TOKEN_K)

    def close(got, want):
        return np.allclose(got, want, **TOKEN_TOL)

    bad = [] if (int(c), int(v)) == (int(want_c), int(want_v)) \
        == (int(c), sum(micro_valid)) else ["counts"]
    bad += [] if close(float(ce), float(want_ce)) else ["loss"]
    pairs = _token_leaves(tm, want_g)
    assert len(pairs) == len(grads) and all(
        p.grad is g for (p, _), g in zip(pairs, grads))
    bad += [f"grad {i}" for i, (p, w) in enumerate(pairs)
            if not close(p.grad.numpy(), w)]
    return bad


TOKEN_CASES = [("transformer_t", True, "xla"),
               ("transformer_t", False, "xla"),
               ("transformer_t", True, "flash"),
               ("seq2seq_t", True, "xla"),
               ("seq2seq_t", False, "xla")]


@pytest.mark.parametrize("arch,fused,token_backend", TOKEN_CASES,
                         indirect=["token_backend"])
def test_token_k_steps_match_jax(arch, fused, token_backend):
    assert _token_violations(arch, fused, token_backend) == []


@pytest.mark.parametrize("arch", ["transformer_t", "seq2seq_t"])
@pytest.mark.parametrize("token_backend", ["xla"], indirect=True)
def test_uniform_micro_step_weights_are_rejected(monkeypatch, arch,
                                                 token_backend):
    """The planted fault: every micro-step weighted 1, whatever its count
    of valid labels."""
    real = common.loss_with_moe_aux

    def uniform(*a, **k):
        obj, ce, (c, v) = real(*a, **k)
        return obj, ce, (c, torch.ones_like(v))

    monkeypatch.setattr(common, "loss_with_moe_aux", uniform)
    bad = _token_violations(arch, True, token_backend)
    assert "loss" in bad and any(b.startswith("grad") for b in bad), bad
