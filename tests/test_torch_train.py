"""The port's token-training slice held against the JAX reference.

``ddlbench_tpu_torch``'s SingleStrategy (models/layers.apply_model on cast
params, parallel/common.py's loss and update formulas) against
``ddlbench_tpu.parallel.single.SingleStrategy`` on the tiny LM of
tests/tiny_models.py (transformer_t, T 32, vocab 64), from the same weights
(convert.from_jax_params) and the same numpy batches, through the
materialised logits (``fused_head_loss=False``) and the fused LM head
(``True``, the default; the reference's chunked fused path on the CPU, the
port's plain versions of kernels B4-B6): the loss, the accuracy, every
gradient leaf and every parameter after each update, for two SGD and two
Adam steps, under the flash backend (the reference's Pallas kernels in
interpret mode, the port's plain versions) and the xla backend.

Tolerance in float32: rtol 1e-4, atol 1e-6 — the two sides run the same
math in different summation orders. The bfloat16 case has its own stated
tolerance (test_bf16_step_matches_jax).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.common import cast_params
from ddlbench_tpu.parallel.common import loss_and_grads as jax_loss_and_grads
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle
from tiny_models import TINY_LM, tiny_transformer

from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.convert import from_jax_opt_state, from_jax_params
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.models.layers import apply_slice
from ddlbench_tpu_torch.parallel.common import loss_and_grads
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
VOCAB = TINY_LM.num_classes
T = TINY_LM.seq_len
B = 2
LR = {"sgd": 0.01, "adam": 1e-3}


def _batch(seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, VOCAB, (B, T + 1)).astype(np.int32)
    return seq[:, :-1], seq[:, 1:]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaves(model, tree):
    """(port parameter, reference leaf as numpy) for every parameter of
    ``model``, matched by name against a per-layer params/grads list."""
    out = []
    for layer, ltree in zip(model.layers, tree):
        flat = dict(_flat(ltree))
        out.extend((p, np.asarray(flat[n]))
                   for n, p in layer.named_parameters())
    return out


@pytest.fixture(scope="module")
def jax_model():
    jm = tiny_transformer()
    params, states, _ = init_model(jm, jax.random.key(0))
    return jm, params, states


def _pair(jax_model, backend, optimizer, dtype="float32", remat=False,
          fused=False):
    jm, params, _ = jax_model
    jcfg = JaxRunConfig(benchmark="synthtext", arch="transformer_t",
                        compute_dtype=dtype, attention_backend=backend,
                        fused_head_loss=fused, optimizer=optimizer,
                        label_smoothing=0.0)
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(0))
    assert jax.tree.all(jax.tree.map(lambda a, b: bool((a == b).all()),
                                     ts.params, params))
    model = ttr.build_transformer("transformer_t", TINY_LM.image_size, VOCAB)
    from_jax_params(model, jax.device_get(params))
    cfg = RunConfig(arch="transformer_t", compute_dtype=dtype,
                    attention_backend=backend, optimizer=optimizer,
                    remat_layers=remat, fused_head_loss=fused)
    cfg.validate()
    ps = SingleStrategy(model, cfg)
    ps.init()
    return js, jcfg, ts, ps


@pytest.fixture
def backend(request):
    """The attention backend of both packages; a "+fused" suffix also
    trains through the fused LM head (fused_head_loss=True)."""
    name, _, fused = request.param.partition("+")
    jtr.set_attention_backend(name)
    ttr.set_attention_backend(name)
    yield name, fused == "fused"
    jtr.set_attention_backend("auto")
    ttr.set_attention_backend("auto")


@pytest.mark.parametrize("backend", ["flash", "xla", "flash+fused",
                                     "xla+fused"], indirect=True)
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_two_steps_match_jax(jax_model, backend, optimizer):
    jm, _, states = jax_model
    backend, fused = backend
    js, jcfg, ts, ps = _pair(jax_model, backend, optimizer, fused=fused)
    jgrads = jax.jit(lambda p, x, y: jax_loss_and_grads(
        jm, jcfg, p, states, x, y, jnp.float32, 0.0)[3])
    for step in range(2):
        x, y = _batch(step)
        want_g = jgrads(ts.params, jnp.asarray(x), jnp.asarray(y))
        ts, jm_metrics = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                                       jnp.float32(LR[optimizer]))
        m = ps.train_step(torch.from_numpy(x).long(),
                          torch.from_numpy(y).long(), LR[optimizer])
        np.testing.assert_allclose(m["loss"].item(),
                                   float(jm_metrics["loss"]), **TOL)
        np.testing.assert_allclose(m["accuracy"].item(),
                                   float(jm_metrics["accuracy"]), **TOL)
        pairs = _leaves(ps.model, want_g)
        assert len(pairs) == 25  # embed 2, two blocks of 10, head 3
        for p, g in pairs:
            np.testing.assert_allclose(p.grad.numpy(), g, **TOL)
        for p, w in _leaves(ps.model, ts.params):
            np.testing.assert_allclose(p.detach().numpy(), w, **TOL)


def test_eval_step_matches_jax(jax_model):
    """eval_step's logits branch: loss, top-1 and top-5 counts, count."""
    _check_eval_step(jax_model, fused=False)


def test_fused_eval_step_matches_jax(jax_model):
    """eval_step's fused branch (fused_linear_xent_eval, no [N, V]
    logits): the same metrics as the reference's fused eval."""
    _check_eval_step(jax_model, fused=True)


def _check_eval_step(jax_model, fused):
    js, _, ts, ps = _pair(jax_model, "xla", "sgd", fused=fused)
    x, y = _batch(50)
    y[0, :5] = -1  # masked label positions count nowhere
    want = js.eval_step(ts, jnp.asarray(x), jnp.asarray(y))
    got = ps.eval_step(torch.from_numpy(x).long(), torch.from_numpy(y).long())
    assert set(got) == set(want) == {"loss", "correct", "correct5", "count"}
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **TOL)
    for key in ("correct", "correct5", "count"):
        assert int(got[key]) == int(want[key]), key
    assert int(got["count"]) == B * T - 5


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resume_from_jax_opt_state(jax_model, optimizer):
    """The port resumed from the reference's TrainState after step 1
    (params and optimizer state) takes step 2 to the reference's
    parameters."""
    js, _, ts, _ = _pair(jax_model, "xla", optimizer)
    for step in range(2):
        x, y = _batch(10 + step)
        if step == 1:
            resume = jax.device_get(ts)
        ts, _ = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                              jnp.float32(LR[optimizer]))
    _, _, _, ps = _pair(jax_model, "xla", optimizer)
    from_jax_params(ps.model, resume.params)
    from_jax_opt_state(ps.opt, ps.model, resume.opt)
    ps.train_step(torch.from_numpy(x).long(), torch.from_numpy(y).long(),
                  LR[optimizer])
    for p, w in _leaves(ps.model, ts.params):
        np.testing.assert_allclose(p.detach().numpy(), w, **TOL)


def test_bf16_step_matches_jax(jax_model, fused=False):
    """One bfloat16 SGD step (flash backend), float32 master weights.

    Tolerances: the loss within rtol 1e-3 — bfloat16 keeps 8 significant
    bits (relative rounding 2^-9, about 2e-3, per operation), and the two
    frameworks round at different places (XLA fuses and keeps some
    intermediates in float32); measured 4e-6. The updated parameters
    within atol 1e-4: the lr-0.01 step moves no weight here by more than
    about 2e-3, and gradients that agree to a few bfloat16 ulps (2^-8
    relative each) put the two updates within about 2.5e-5 of each other
    (measured 2.4e-5), so 1e-4 leaves a 4x margin and stays 20x below the
    step a wrong gradient would change."""
    jtr.set_attention_backend("flash")
    ttr.set_attention_backend("flash")
    try:
        js, _, ts, ps = _pair(jax_model, "flash", "sgd", dtype="bfloat16",
                                 fused=fused)
        x, y = _batch(20)
        ts, jm_metrics = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                                       jnp.float32(0.01))
        m = ps.train_step(torch.from_numpy(x).long(),
                          torch.from_numpy(y).long(), 0.01)
    finally:
        jtr.set_attention_backend("auto")
        ttr.set_attention_backend("auto")
    np.testing.assert_allclose(m["loss"].item(), float(jm_metrics["loss"]),
                               rtol=1e-3)
    for p, w in _leaves(ps.model, ts.params):
        assert p.dtype == torch.float32  # the master copy stays float32
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-4)


def test_bf16_fused_step_matches_jax(jax_model):
    """The same bfloat16 SGD step through the fused LM head (the
    reference's chunked fused path, the port's plain versions of B4-B6),
    at the same stated tolerances: both round dz to bfloat16 before the
    head's products, as the logits path rounds its logits."""
    test_bf16_step_matches_jax(jax_model, fused=True)


def test_embed_returns_compute_dtype_under_bf16_apply(jax_model):
    """Under a bfloat16 apply the embedding's activations are bfloat16 and
    equal the reference's embed on cast params."""
    jm, params, _ = jax_model
    model = ttr.build_transformer("transformer_t", TINY_LM.image_size, VOCAB)
    from_jax_params(model, jax.device_get(params))
    x, _ = _batch(30)
    want, _ = jm.layers[0].apply(cast_params(params[0], jnp.bfloat16), {},
                                 jnp.asarray(x), True)
    with torch.no_grad():
        got = apply_slice(model.layers[:1], torch.from_numpy(x).long(),
                          torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_remat_gives_the_same_gradients(jax_model):
    _, params, _ = jax_model
    x, y = (torch.from_numpy(a).long() for a in _batch(40))
    grads = []
    for remat in (False, True):
        model = ttr.build_transformer("transformer_t", TINY_LM.image_size,
                                      VOCAB)
        from_jax_params(model, jax.device_get(params))
        cfg = RunConfig(arch="transformer_t", compute_dtype="float32",
                        remat_layers=remat)
        grads.append(loss_and_grads(model, cfg, x, y, torch.float32, 0.0)[2])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)


def test_synthetic_tokens():
    spec = DatasetSpec("tinylm", TINY_LM.image_size, VOCAB, 1000, 100,
                       kind="tokens")
    data = make_synthetic(spec, 3, torch.device("cpu"), steps_per_epoch=4)
    x, y = data.batch(0, 0)
    assert x.shape == y.shape == (3, T) and x.dtype == torch.int64
    assert 0 <= int(x.min()) and int(x.max()) < VOCAB
    assert torch.equal(x[:, 1:], y[:, :-1])  # labels = inputs shifted by one
    x2, y2 = data.batch(0, 0)
    assert torch.equal(x, x2) and torch.equal(y, y2)  # per (seed, epoch, step)
    assert not torch.equal(x, data.batch(0, 1)[0])
    assert not torch.equal(x, data.batch(1, 0)[0])
    assert not torch.equal(x, data.batch(0, 0, train=False)[0])
    assert data.steps_per_epoch() == 4


@pytest.mark.parametrize("knob", [
    # elastic_slices and checkpoint_dir run since checkpoints were
    # ported (tests/test_torch_elastic.py, test_torch_resume.py); the same
    # configs with a knob the port still refuses
    dict(strategy="dp", num_devices=2, dp_shard_update=True,
         elastic_slices=2, audit="a.json"),
    dict(checkpoint_dir="d", trace_dir="d"),
    dict(anomaly_policy="skip"), dict(loss_scale="dynamic"),
    # MoE under fsdp and dp and remat_layers under tp run since they were
    # ported; the same configs with a knob of ROADMAP A.8
    dict(strategy="fsdp", num_devices=2, arch="transformer_moe_t",
         hang_timeout_s=5.0),
    dict(strategy="dp", num_devices=2, arch="transformer_moe_t",
         trace="t.json"),
    dict(strategy="tp", num_devices=2, remat_layers=True,
         inject=("nan@3",)),
])
def test_unported_train_knobs_raise(knob):
    with pytest.raises(NotImplementedError):
        RunConfig(**knob).validate()


def test_run_config_defaults_to_the_fused_head():
    """As in the reference, training takes the fused LM-head loss by
    default, and the default config validates."""
    cfg = RunConfig()
    assert cfg.fused_head_loss is True
    assert JaxRunConfig().fused_head_loss is True
    cfg.validate()
    RunConfig(benchmark="synthmt", arch="seq2seq_s").validate()
