"""The port's LSTM seq2seq (ddlbench_tpu_torch/models/lstm.py) held
against the JAX reference (ddlbench_tpu/models/lstm.py) on the CPU.

An LSTM layer (``torch.lstm`` with weight_ih = wx.T, weight_hh = wh.T,
bias_ih = b, bias_hh = 0) against the reference's ``lax.scan`` and
against a recurrence written out here, gate order (i, f, g, o), with and
without the residual, forward and gradients; the cross-attention's
source rule (source positions pass through exactly), its bfloat16 scale
(sqrt(512) rounded to 22.625) and the model's causality; one training
step of seq2seq_lstm_t (d 32, 2 layers, T 16, source 8, vocab 64) through
the fused head with smoothing 0.1 and through the logits: the CE, the
objective, every gradient and every parameter after the update; the zoo
registration; and the decoders' refusal (no decode protocol), with
decodebench's skip rows.

Tolerance in float32: rtol 1e-4, atol 1e-6 (the two sides run the same
math in different summation orders); bfloat16: atol 2^-6 on O(1) outputs.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.lstm as jlstm
from ddlbench_tpu.config import DatasetSpec as JaxSpec
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.common import \
    loss_with_moe_aux as jax_loss_with_aux

from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import lstm
from ddlbench_tpu_torch.models import seq2seq as s2s
from ddlbench_tpu_torch.models.layers import apply_model
from ddlbench_tpu_torch.models.zoo import MODEL_NAMES, get_model
from ddlbench_tpu_torch.parallel import common
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.tools import decodebench
from test_torch_train import _leaves

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
T, SRC, VOCAB, D = 16, 8, 64, 32
ARCH = "seq2seq_lstm_t"
TINY_MT = DatasetSpec("tinylstm", (T,), VOCAB, 64, 16, kind="seq2seq",
                      src_len=SRC)
LR = 0.01


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layer_pair(residual, seed=0):
    jl = jlstm.lstm_layer("l", D, residual=residual)
    p, _, _ = jl.init(jax.random.key(seed), (T, D))
    tl = lstm.LSTMLayer(D, D, torch.Generator(), residual=residual)
    with torch.no_grad():
        for n in ("wx", "wh", "b"):
            getattr(tl, n).copy_(torch.from_numpy(np.asarray(p[n])))
    return jl, p, tl


def _manual(x, wx, wh, b):
    """The reference's recurrence written out: xw = x @ wx + b, then per
    step gates = xw_t + h @ wh split (i, f, g, o)."""
    B, Tn, _ = x.shape
    H = wh.shape[0]
    xw = x @ wx + b
    h = c = x.new_zeros(B, H)
    out = []
    for t in range(Tn):
        i, f, g, o = (xw[:, t] + h @ wh).split(H, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("residual", [False, True])
def test_lstm_layer_matches_reference(residual):
    """Forward and every gradient against the reference's scan; the
    forget-gate bias starts at 1.0 on both sides."""
    jl, p, tl = _layer_pair(residual)
    H = D
    np.testing.assert_array_equal(tl.b.detach().numpy()[H:2 * H], 1.0)
    np.testing.assert_array_equal(np.asarray(p["b"]), tl.b.detach().numpy())
    x = _rand(1, 3, T, D)
    cot = _rand(2, 3, T, D)

    def jloss(p, x):
        y, _ = jl.apply(p, {}, x, True)
        return jnp.sum(y * cot), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tl(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for n in ("wx", "wh", "b"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   np.asarray(jgp[n]), **TOL)


def test_lstm_layer_matches_manual_recurrence():
    """torch.lstm with the reference's weights transposed computes the
    written-out recurrence (layer 1: no residual)."""
    _, _, tl = _layer_pair(False, seed=3)
    x = torch.from_numpy(_rand(4, 2, T, D))
    with torch.no_grad():
        tl.b.add_(torch.from_numpy(_rand(5, 4 * D)) * 0.1)
        want = _manual(x, tl.wx, tl.wh, tl.b)
        np.testing.assert_allclose(tl(x).numpy(), want.numpy(), **TOL)
        tl.residual = True
        np.testing.assert_allclose(tl(x).numpy(), (want + x).numpy(),
                                   **TOL)


def _attn_pair(dtype):
    ja = jlstm.cross_attention("a", D, SRC)
    p, _, _ = ja.init(jax.random.key(2), (T, D))
    ta = lstm.CrossAttention(D, SRC, torch.Generator())
    with torch.no_grad():
        for n in ("q", "k", "v", "o"):
            getattr(ta, n).copy_(torch.from_numpy(np.asarray(p[n])) * 8.0)
    jp = {n: jnp.asarray(getattr(ta, n).detach().numpy()).astype(dtype)
          for n in ("q", "k", "v", "o")}
    return ja, jp, ta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_source_rule_and_scale(dtype):
    """Source positions pass through exactly; target positions read only
    the source (a target token changes no other position); the output
    equals the reference's, whose bfloat16 scale is sqrt(512) rounded."""
    tdt = getattr(torch, dtype)
    ja, jp, ta = _attn_pair(dtype)
    x = _rand(6, 2, T, D)
    jy, _ = ja.apply(jp, {}, jnp.asarray(x).astype(dtype), True)
    with torch.no_grad():
        xt = torch.from_numpy(x).to(tdt)
        y = apply_model(lstm_chain(ta), xt, tdt)
        assert torch.equal(y[:, :SRC], xt[:, :SRC])
        x2 = xt.clone()
        x2[:, SRC + 3] += 1.0
        y2 = apply_model(lstm_chain(ta), x2, tdt)
        same = [t for t in range(T) if t != SRC + 3]
        assert torch.equal(y[:, same], y2[:, same])
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2.0 ** -6)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    scale = torch.tensor(512.0, dtype=torch.bfloat16).sqrt()
    assert float(scale) == 22.625 == float(
        jnp.sqrt(jnp.asarray(512, jnp.bfloat16)))


def lstm_chain(*layers):
    from ddlbench_tpu_torch.models.layers import LayerModel

    return LayerModel("chain", layers, (T, D), D)


@pytest.fixture(scope="module")
def pair():
    jm = jlstm.build_lstm_seq2seq(ARCH, (T,), VOCAB, SRC)
    params, states, _ = init_model(jm, jax.random.key(0))
    return jm, params, states


def _port(params):
    tm = lstm.build_lstm_seq2seq(ARCH, (T,), VOCAB, SRC)
    return from_jax_params(tm, jax.device_get(params))


def _batch(seed, B=4):
    seq = np.random.default_rng(seed).integers(0, VOCAB, (B, T + 1))
    y = seq[:, 1:].copy()
    y[:, :SRC - 1] = -1  # mask_source_labels
    return seq[:, :-1].astype(np.int32), y.astype(np.int32)


def test_model_is_causal(pair):
    """The recurrence and the source rule make the model causal: a token
    changes no logit before its position."""
    tm = _port(pair[1])
    x, _ = _batch(7)
    x2 = x.copy()
    x2[:, SRC + 4] = (x2[:, SRC + 4] + 1) % VOCAB
    with torch.no_grad():
        a = tm(torch.from_numpy(x).long())
        b = tm(torch.from_numpy(x2).long())
    assert torch.equal(a[:, :SRC + 4], b[:, :SRC + 4])
    assert not torch.equal(a[:, SRC + 4:], b[:, SRC + 4:])


@pytest.mark.parametrize("fused,smoothing", [(True, 0.1), (False, 0.1),
                                             (True, 0.0)])
def test_train_step_matches_jax(pair, fused, smoothing):
    """One SGD step of seq2seq_lstm_t: the CE, the objective, every
    gradient, and every parameter after the update (the reference's SGD
    rule: a first step moves p by -lr * g)."""
    jm, params, states = pair
    tm = _port(params)
    x, y = _batch(8)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    (jobj, jce), grads = jax.jit(jax.value_and_grad(
        lambda q: jax_loss_with_aux(jm, q, states, jx, jy, True,
                                    jnp.float32, 0.01, smoothing,
                                    fused)[:2], has_aux=True))(params)
    cfg = RunConfig(benchmark="synthmt", arch=ARCH, compute_dtype="float32",
                    fused_head_loss=fused, optimizer="sgd",
                    label_smoothing=smoothing)
    cfg.validate()
    obj, ce, (_, valid) = common.loss_with_moe_aux(
        tm, torch.from_numpy(x).long(), torch.from_numpy(y).long(),
        torch.float32, smoothing, fused, aux_weight=0.01)
    assert int(valid) == 4 * (T - SRC + 1)
    np.testing.assert_allclose(float(obj), float(jobj), **TOL)
    np.testing.assert_allclose(float(ce), float(jce), **TOL)
    ps = SingleStrategy(tm, cfg)
    ps.init()
    m = ps.train_step(torch.from_numpy(x).long(),
                      torch.from_numpy(y).long(), LR)
    np.testing.assert_allclose(m["loss"].item(), float(jce), **TOL)
    pairs = _leaves(tm, grads)
    assert len(pairs) == 15  # embed 2, lstm 3, attn 4, lstm 3, head 3
    for (p, g), (_, w) in zip(pairs, _leaves(tm, params)):
        np.testing.assert_allclose(p.grad.numpy(), g, **TOL)
        np.testing.assert_allclose(p.detach().numpy(), w - LR * g, **TOL)


def test_zoo_registers_the_lstm_arches():
    """seq2seq_lstm_s and _t build through the zoo on seq2seq data, with
    the reference's layer chain and parameter count."""
    assert {"seq2seq_lstm_s", "seq2seq_lstm_t"} <= set(MODEL_NAMES)
    jspec = JaxSpec("tinylstm", (T,), VOCAB, 64, 16, kind="seq2seq",
                    src_len=SRC)
    jm = jlstm.build_lstm_seq2seq(ARCH, jspec.image_size, VOCAB, SRC)
    params, _, _ = init_model(jm, jax.random.key(0))
    tm = get_model(ARCH, TINY_MT)
    assert [type(l).__name__ for l in tm.layers] == [
        "LSTMEmbed", "LSTMLayer", "CrossAttention", "LSTMLayer", "LMHead"]
    assert tm.src_len == SRC
    assert sum(p.numel() for p in tm.parameters()) == sum(
        np.size(a) for a in jax.tree.leaves(params))
    assert not tm.layers[1].residual and tm.layers[3].residual
    with pytest.raises(ValueError, match="seq2seq dataset"):
        get_model("seq2seq_lstm_s", "synthtext")
    with torch.device("meta"):
        big = lstm.build_lstm_seq2seq("seq2seq_lstm_s", (256,), 32_768, 128)
    assert sum(isinstance(l, lstm.LSTMLayer) for l in big.layers) == 4
    assert isinstance(big.layers[3], lstm.CrossAttention)  # after n // 2


def test_no_decode_protocol(pair):
    """As in the reference, the LSTM model has no cached or paged
    decoding: the decoders refuse it, and decodebench skips those rows
    and times the full-forward loops."""
    tm = _port(pair[1])
    assert not dec.supports_cache(tm) and not dec.supports_paged(tm)
    src = torch.zeros(1, SRC, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="cached-decode"):
        s2s.greedy_decode(tm, src, T)
    with pytest.raises(NotImplementedError, match="paged-decode"):
        dec.greedy_decode(tm, src, T, paged=True)
    full = s2s.greedy_decode(tm, src, T, use_cache=False)
    assert full.shape == (1, T)
    args = decodebench.build_parser().parse_args(
        ["-m", ARCH, "--batch", "1", "--beam", "2", "--repeats", "1",
         "--device", "cpu"])
    rows = list(decodebench.decode_rows(args, tm, TINY_MT,
                                        torch.device("cpu"), {}))
    skipped = {(r["mode"], r["variant"]): r.get("skipped") for r in rows}
    assert skipped == {
        ("greedy", "paged"): f"{ARCH} lacks paged support",
        ("beam", "paged"): f"{ARCH} lacks paged support",
        ("greedy", "cached"): f"{ARCH} lacks cached support",
        ("beam", "cached"): f"{ARCH} lacks cached support",
        ("greedy", "full"): None, ("beam", "full"): None}
    assert all(r["tokens_per_sec"] > 0 for r in rows if "skipped" not in r)
