"""The port's MoE transformer (ddlbench_tpu_torch/models/moe.py) held
against the JAX reference (ddlbench_tpu/models/moe.py) on the CPU.

Routing: ``switch_route``'s experts, queue slots, kept mask and gates
laid out as the reference's dense [S, E, C] dispatch must EQUAL it, drops
included, and its aux loss within 1e-6. The layer: the port's indexed
dispatch and combine against the reference's one-hot einsums (and against
a one-hot form written in torch here), forward and every gradient, with
and without drops: expert indices compared first, a differing token
accepted only where its top-2 gate margin is within 1e-5 (none occurs at
these seeds). The model: transformer_moe_t (tests/tiny_models.py: d 32,
2 layers, 4 heads, 8 experts, T 32, vocab 64) from the reference's
weights (convert.from_jax_params), one SGD step through the fused head
and through the logits, without and with label smoothing: the CE, the
router aux loss, the objective, every gradient and every parameter
after the update (the reference's SGD rule: a first step moves p by
-lr * g); gradient accumulation (K = 2, each micro-batch routed with its
own capacity); greedy and beam decoding over the dense and the paged
cache (PAGE 4 on both sides) against the full-forward loop and the
reference's tokens. The JAX side runs off-TPU: the "xla" attention and
its plain fused head.

Tolerance in float32: rtol 1e-4, atol 1e-6 (the two sides run the same
math in different summation orders); tokens equal.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.decode as jdec
import ddlbench_tpu.models.moe as jmoe
import ddlbench_tpu.models.transformer as jtr
import ddlbench_tpu.ops.paged_decode as jpd
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import apply_model as jax_apply
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.common import \
    accum_loss_and_grads as jax_accum
from ddlbench_tpu.parallel.common import \
    loss_with_moe_aux as jax_loss_with_aux
from tiny_models import N_EXPERTS, TINY_LM, tiny_moe

import ddlbench_tpu_torch.ops.paged_decode as pd
import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig, ServeConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models import decode as dec
from ddlbench_tpu_torch.models import moe
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.parallel import common
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.serve.engine import ServeEngine
from test_torch_train import _leaves

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
MARGIN = 1e-5  # a flipped expert's top-2 gate-probability gap
VOCAB, T = TINY_LM.num_classes, TINY_LM.seq_len
LR = 0.01
ARCH = "transformer_moe_t"


@pytest.fixture(autouse=True)
def xla_backend():
    jtr.set_attention_backend("xla")
    ttr.set_attention_backend("xla")
    yield
    jtr.set_attention_backend("auto")
    ttr.set_attention_backend("auto")


def _dense(route: moe.Route, E: int, C: int) -> np.ndarray:
    """The port's route as the reference's [S, E, C] 0/1 dispatch."""
    S = route.expert.shape[0]
    out = torch.zeros(S, E, C)
    k = route.keep
    out[torch.arange(S)[k], route.expert[k], route.slot[k]] = 1.0
    return out.numpy()


def _jax_apply_aux(jm, params, states, x):
    """The reference's train-mode logits and its MoE layers' aux losses,
    jitted."""
    def f(p, x):
        aux = []
        with jmoe.collect_aux_losses(aux):
            logits, _ = jax_apply(jm, p, states, x, True)
        return logits, aux

    return jax.jit(f)(params, jnp.asarray(x))


def _pair(cf, seed=0):
    """The reference's transformer_moe_t (its params) and the port's on
    the same weights."""
    jm = tiny_moe(capacity_factor=cf)
    params, states, _ = init_model(jm, jax.random.key(seed))
    tm = moe.build_transformer_moe(ARCH, TINY_LM.image_size, VOCAB, cf)
    from_jax_params(tm, jax.device_get(params))
    return jm, params, states, tm


def _tokens(seed, B):
    seq = np.random.default_rng(seed).integers(0, VOCAB, (B, T + 1))
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_switch_route_capacity():
    """The reference's capacity case: every token prefers expert 1, only
    C survive, in order, each combining with its softmax probability."""
    S, E, C = 12, 4, 2
    logits = torch.full((S, E), -5.0)
    logits[:, 1] = 5.0
    r = moe.switch_route(logits, C)
    d = _dense(r, E, C)
    np.testing.assert_array_equal(d.sum((1, 2)), [1, 1] + [0] * (S - 2))
    assert r.keep.tolist() == [True, True] + [False] * (S - 2)
    np.testing.assert_allclose(r.gate[:2].numpy(),
                               torch.softmax(logits, -1)[:2, 1].numpy(),
                               rtol=1e-6)
    jd, _, jaux = jmoe.switch_route(jnp.asarray(logits.numpy()), C)
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert float(r.aux) > 1.0
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cap", [1, 6, 40])
def test_switch_route_matches_reference(cap):
    """Random router logits: the dispatch (drops included), the combine
    weights and the aux loss equal the reference's."""
    g = np.random.default_rng(cap).standard_normal((40, 4)).astype(
        np.float32)
    jd, jc, jaux = jmoe.switch_route(jnp.asarray(g), cap)
    r = moe.switch_route(torch.from_numpy(g), cap)
    d = _dense(r, 4, cap)
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert int((~r.keep).sum()) == 40 - int(np.asarray(jd).sum())
    np.testing.assert_allclose(d * (r.gate * r.keep).numpy()[:, None, None],
                               np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)


def test_top1_gate_ties_take_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    _, expert, _ = moe.top1_gate(logits)
    assert expert.tolist() == [1, 0]
    _, jonehot, _ = jmoe._top1_gate(jnp.asarray(logits.numpy()))
    assert np.asarray(jonehot).argmax(-1).tolist() == [1, 0]


def _layer_inputs(seed, B=2, d=32, E=N_EXPERTS, f=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    p = {"gate": rng.standard_normal((d, E)).astype(np.float32) * 0.5,
         "experts": {
             "w1": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
             "b1": rng.standard_normal((E, f)).astype(np.float32) * 0.1,
             "w2": rng.standard_normal((E, f, d)).astype(np.float32) * 0.1,
             "b2": rng.standard_normal((E, d)).astype(np.float32) * 0.1}}
    return x, p


def _port_layer(p, E=N_EXPERTS, d=32, f=128):
    gate = torch.nn.Parameter(torch.from_numpy(p["gate"]))
    ex = moe.Experts(E, d, f, torch.Generator())
    with torch.no_grad():
        for n in ("w1", "b1", "w2", "b2"):
            getattr(ex, n).copy_(torch.from_numpy(p["experts"][n]))
    return gate, ex


def _flips(r, gate_logits, want_expert):
    """Tokens whose expert differs from ``want_expert``; each must lie
    within MARGIN of a tie."""
    probs = torch.softmax(gate_logits.float(), -1)
    top2 = probs.topk(2, -1).values
    diff = (r.expert.numpy() != want_expert).nonzero()[0]
    assert all(float(top2[i, 0] - top2[i, 1]) <= MARGIN for i in diff), diff
    return len(diff)


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_mlp_matches_reference(cf):
    """The indexed layer against the reference's one-hot einsums: the
    output and the gradients of x, the router and every expert weight
    (cf 0.5 drops about half the tokens; cf 8 none)."""
    x, p = _layer_inputs(int(cf * 10))
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, x):
        y = jmoe.moe_mlp(p, x, cf)
        return jnp.sum(y * cot), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    gate, ex = _port_layer(p)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, r = moe.moe_mlp(xt, gate, ex, cf)
    S = x.shape[0] * T
    C = moe.capacity(cf, S, N_EXPERTS)
    jlogits = jnp.asarray(x.reshape(S, -1)) @ p["gate"]
    _, jonehot, _ = jmoe._top1_gate(jlogits)
    assert _flips(r, torch.from_numpy(np.asarray(jlogits)),
                  np.asarray(jonehot).argmax(-1)) == 0
    dropped = int((~r.keep).sum())
    assert (dropped > S // 4) if cf < 1 else dropped == 0
    assert C == max(1, -(-int(cf * S) // N_EXPERTS))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(gate.grad.numpy(), np.asarray(jgp["gate"]),
                               **TOL)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(ex, n).grad.numpy(),
                                   np.asarray(jgp["experts"][n]), **TOL)


def _one_hot_form(x, gate, ex, cf):
    """The reference's dense one-hot dispatch/combine, written in torch."""
    B, _, d = x.shape
    S, E = B * T, gate.shape[1]
    C = moe.capacity(cf, S, E)
    xf = x.reshape(S, d)
    r = moe.switch_route(xf.float() @ gate.float(), C)
    dispatch = torch.from_numpy(_dense(r, E, C)).to(x.dtype)
    combine = (dispatch.float() * r.gate[:, None, None]).to(x.dtype)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, xf)
    return torch.einsum("sec,ecd->sd", combine, ex(expert_in)).reshape(
        B, T, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_indexed_form_equals_one_hot_form(dtype):
    """Dispatch and combine by index compute the one-hot einsums'
    function: the outputs and the input gradient agree to float32
    rounding, and in bfloat16 the combine rounds bf16(gate) * out once in
    both forms (within one bfloat16 ulp of the output)."""
    dt = getattr(torch, dtype)
    x, p = _layer_inputs(3)
    gate, ex = _port_layer(p)
    outs = []
    for form in (lambda *a: moe.moe_mlp(*a)[0], _one_hot_form):
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        y = form(xt, gate, ex, 0.5)
        y.float().sum().backward()
        outs.append((y.detach().float(), xt.grad.float()))
    (y1, g1), (y2, g2) = outs
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **tol)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), **tol)


def test_moe_forward_and_aux_collection():
    """One MoE block in two (the odd index), its aux recorded once per
    forward, at least 1 (its minimum, uniform routing)."""
    jm, params, states, tm = _pair(float(N_EXPERTS))
    assert [type(l).__name__ for l in tm.layers] == [
        "Embed", "TransformerBlock", "MoEBlock", "LMHead"]
    x, _ = _tokens(1, 2)
    jl, aux = _jax_apply_aux(jm, params, states, x)
    logits = tm(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               **TOL)
    got = moe.aux_losses(tm)
    assert len(got) == len(aux) == 1
    assert float(got[0]) >= 1.0 - 1e-5
    np.testing.assert_allclose(float(got[0]), float(aux[0]), rtol=1e-5)


def test_moe_capacity_drop_is_residual():
    """Capacity ~0 clamps to one slot an expert: every other token skips
    the experts and the block reduces to attention + residual there."""
    jm, params, states, tm = _pair(1e-9)
    x, _ = _tokens(2, 2)
    jl, _ = _jax_apply_aux(jm, params, states, x)
    h = tm.layers[1](tm.layers[0](_t(x)))
    blk = tm.layers[2]
    out = blk(h)
    r = blk.last_route
    assert int(r.keep.sum()) <= N_EXPERTS
    B, _, d = h.shape
    q, k, v = blk._qkv_heads(h)
    a = blk._proj(ttr.causal_attention(q, k, v).transpose(1, 2).reshape(
        B, T, d), h)
    drop = ~r.keep.reshape(B, T)
    np.testing.assert_array_equal(out[drop].detach().numpy(),
                                  a[drop].detach().numpy())
    np.testing.assert_allclose(tm.layers[3](out).detach().numpy(),
                               np.asarray(jl), **TOL)


def _cfgs(fused, smoothing, cf=1.25, **kw):
    common_kw = dict(benchmark="synthtext", arch=ARCH,
                     compute_dtype="float32", attention_backend="xla",
                     fused_head_loss=fused, optimizer="sgd",
                     label_smoothing=smoothing, moe_capacity_factor=cf, **kw)
    return JaxRunConfig(**common_kw), RunConfig(**common_kw)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_moe_train_step_matches_jax(fused, smoothing):
    """One SGD step of transformer_moe_t at capacity factor 1.25 (tokens
    drop): the CE, the aux loss, the objective, every gradient and every
    updated parameter."""
    jm, params, states, tm = _pair(1.25)
    jcfg, cfg = _cfgs(fused, smoothing)
    cfg.validate()
    x, y = _tokens(3, 2)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    (jobj, jce), grads = jax.jit(jax.value_and_grad(
        lambda q: jax_loss_with_aux(jm, q, states, jx, jy, True, jnp.float32,
                                    jcfg.moe_aux_weight, smoothing,
                                    fused)[:2], has_aux=True))(params)
    _, aux = _jax_apply_aux(jm, params, states, x)
    obj, ce, _ = common.loss_with_moe_aux(tm, _t(x), _t(y), torch.float32,
                                          smoothing, fused,
                                          aux_weight=cfg.moe_aux_weight)
    assert int((~tm.layers[2].last_route.keep).sum()) > 0  # drops
    np.testing.assert_allclose(float(ce), float(jce), **TOL)
    np.testing.assert_allclose(float(moe.aux_losses(tm)[0]), float(aux[0]),
                               **TOL)
    np.testing.assert_allclose(float(obj), float(jobj), **TOL)
    assert abs(float(obj) - float(ce)) > 1e-3  # the aux term is in

    ps = SingleStrategy(tm, cfg)
    ps.init()
    m = ps.train_step(_t(x), _t(y), LR)
    np.testing.assert_allclose(m["loss"].item(), float(jce), **TOL)
    pairs = _leaves(tm, grads)
    assert len(pairs) == 26  # embed 2, dense block 10, MoE block 11, head 3
    # the reference's first SGD step: momentum buffer = grad, p -= lr * g
    for (p, g), (_, w) in zip(pairs, _leaves(tm, params)):
        np.testing.assert_allclose(p.grad.numpy(), g, **TOL)
        np.testing.assert_allclose(p.detach().numpy(), w - LR * g, **TOL)


def test_moe_accum_k2_matches_jax():
    """K = 2 micro-steps, each routed with the capacity of its own 64
    tokens: the weighted CE and every gradient against the reference's
    accum_loss_and_grads (aux weight 0.01)."""
    jm, params, states, tm = _pair(1.25)
    _, cfg = _cfgs(True, 0.0, grad_accum_steps=2)
    x, y = _tokens(4, 4)
    y[0, :5] = -1  # the two micro-steps count different valid labels
    _, want_ce, (wc, wv), _, want_g = jax.jit(
        lambda p, s, x, y: jax_accum(jm, p, s, x, y, jnp.float32, 0.01,
                                     0.0, True, 2))(
        params, states, jnp.asarray(x), jnp.asarray(y))
    ce, (c, v), grads = common.accum_loss_and_grads(
        tm, cfg, _t(x), _t(y), torch.float32, 0.0, 2)
    assert (int(c), int(v)) == (int(wc), int(wv)) == (int(c), 4 * T - 5)
    np.testing.assert_allclose(float(ce), float(want_ce), **TOL)
    for p, g in _leaves(tm, want_g):
        np.testing.assert_allclose(p.grad.numpy(), g, **TOL)


def test_moe_cached_decode_matches_full_forward():
    """The mirror of tests/test_decode.py's MoE case: at capacity factor
    E nothing drops, so the cached greedy (each position's top-1 expert,
    no capacity) equals the full forward over the unpadded prefix, and
    the reference's cached tokens."""
    jm, params, states, tm = _pair(float(N_EXPERTS))
    assert dec.supports_cache(tm) and dec.supports_paged(tm)
    prompt = np.asarray(jax.random.randint(jax.random.key(7), (2, 6), 0,
                                           VOCAB, jnp.int32))
    want = np.asarray(jdec.greedy_decode(jm, params, states,
                                         jnp.asarray(prompt), 12))
    got = dec.greedy_decode(tm, _t(prompt), 12)
    x = _t(prompt)
    with torch.no_grad():
        for _ in range(6):
            x = torch.cat([x, tm(x)[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(got.numpy(), x.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_moe_beam_token_identical(monkeypatch):
    """The mirror of tests/test_paged_decode.py's MoE beam case, PAGE 4
    on both sides (the 16-token stream spans four pages): the paged beam
    equals the dense-cache beam and the reference's tokens, scores within
    rtol 1e-4."""
    monkeypatch.setattr(jpd, "PAGE", 4)
    monkeypatch.setattr(pd, "PAGE", 4)
    jm = jmoe.build_transformer_moe(ARCH, (16,), VOCAB, capacity_factor=8.0)
    params, states, _ = init_model(jm, jax.random.key(5))
    tm = moe.build_transformer_moe(ARCH, (16,), VOCAB, 8.0)
    from_jax_params(tm, jax.device_get(params))
    src = np.asarray(jax.random.randint(jax.random.key(7), (2, 5), 0, VOCAB,
                                        jnp.int32))
    want_x, want_s = jdec.beam_search_decode(jm, params, states,
                                             jnp.asarray(src), 16, beam=2)
    ref_x, ref_s = dec.beam_search_decode(tm, _t(src), 16, beam=2)
    got_x, got_s = dec.beam_search_decode(tm, _t(src), 16, beam=2,
                                          paged=True)
    np.testing.assert_array_equal(got_x.numpy(), ref_x.numpy())
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-5)


def test_remat_layers_refused_for_moe():
    """The reference's refusal, with its message: a checkpointed forward
    would record the router's aux loss twice."""
    for cls in (RunConfig, JaxRunConfig):
        with pytest.raises(ValueError, match="remat_layers is incompatible "
                                             "with MoE"):
            cls(benchmark="synthtext", arch="transformer_moe_s",
                remat_layers=True).validate()
    RunConfig(benchmark="synthtext", arch="transformer_moe_s").validate()


@pytest.mark.parametrize("name,value,match", [
    ("param_dtype", "bfloat16", "parameters are float32"),
    ("dp_replicas", 2, "ROADMAP A.7b")])
def test_schema_only_fields_refuse_what_the_port_does_not_do(name, value,
                                                             match):
    """param_dtype and dp_replicas carry the reference's defaults; a
    value the port does not run is refused, not silently ignored
    (remat_stages, once refused here, acts on the pipelines:
    tests/test_torch_gpipe.py; tp_size, once refused here, runs tpp:
    tests/test_torch_tpp.py; dp_replicas runs the hybrid pipelines,
    tests/test_torch_hybrid.py, and with tp_size > 1, once refused
    naming ROADMAP A.7b, 3-D tpp: tests/test_torch_tpp3d.py, so its row
    now validates as the reference's does)."""
    assert getattr(RunConfig(), name) == getattr(JaxRunConfig(), name)
    RunConfig(benchmark="synthtext", arch="transformer_moe_s",
              **{name: getattr(JaxRunConfig(), name)}).validate()
    extra = ({"strategy": "gpipe", "tp_size": 2, "num_devices": 8}
             if name == "dp_replicas" else {})
    cfg = RunConfig(benchmark="synthtext", arch="transformer_moe_s",
                    **{name: value}, **extra)
    if name == "dp_replicas":
        cfg.validate()
        JaxRunConfig(benchmark="synthtext", arch="transformer_moe_s",
                     **{name: value}, **extra).validate()
        assert cfg.spawned_ranks() == 4
        return
    with pytest.raises(NotImplementedError, match=match):
        cfg.validate()


def test_moe_has_no_serving_ops():
    """As in the reference, the MoE block has no serving ops: the engine
    refuses the model, naming the layer."""
    _, _, _, tm = _pair(1.25)
    with pytest.raises(NotImplementedError, match="MoEBlock"):
        ServeEngine(tm, ServeConfig(max_len=32), torch.device("cpu"))


@pytest.mark.parametrize("tool", ["servebench", "servechaos"])
def test_serving_tools_refuse_moe_as_an_argument_error(tool, capsys):
    """servebench and servechaos turn the engine's refusal into the
    parser's error (exit 2), naming the layer."""
    main = importlib.import_module(f"ddlbench_tpu_torch.tools.{tool}").main
    tiny = DatasetSpec("tinylm", (16,), VOCAB, 1000, 100, kind="tokens")
    with mock.patch.dict(tconfig.DATASETS, {"tinylm": tiny}):
        with pytest.raises(SystemExit) as e:
            main(["-m", ARCH, "-b", "tinylm", "--requests", "1",
                  "--max-len", "16", "--page", "4", "--pool-pages", "9",
                  "--device", "cpu"])
    assert e.value.code == 2 and "MoEBlock" in capsys.readouterr().err
