"""The port's seq2seq prefix-LM (ddlbench_tpu_torch/models/seq2seq.py) and
its synthetic translation data held against the JAX reference.

A tiny seq2seq_t (d 32, 2 layers, 4 heads, T 16 with an 8-token source,
vocab 64: tests/test_seq2seq.py's sizes), with the reference's weights
carried over by convert.from_jax_params (the embedding's segment table
included) and the same numpy batches fed to both packages: the forward
logits, the source-label mask, two Adam steps at label smoothing 0.1
(synthmt's defaults) through the fused LM head and through the logits,
under the flash backend (the reference's Pallas kernels in interpret mode,
the port's plain versions) and the xla backend, and the eval step.

Tolerance in float32: rtol 1e-4, atol 1e-6 (tests/test_torch_train.py's):
the two sides run the same math in different summation orders.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.seq2seq as js2s
import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.config import DatasetSpec as JaxDatasetSpec
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.data.synthetic import \
    mask_source_labels as jax_mask_source_labels
from ddlbench_tpu.models.layers import apply_model as jax_apply_model
from ddlbench_tpu.parallel.common import loss_and_grads as jax_loss_and_grads
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle

import ddlbench_tpu_torch.models.seq2seq as s2s
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.data.synthetic import (make_synthetic,
                                               mask_source_labels)
from ddlbench_tpu_torch.models import transformer as ttr
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
T, SRC, VOCAB, B = 16, 8, 64, 2
TINY = dict(d_model=32, n_layers=2, n_heads=4)
TINY_MT = DatasetSpec("tinymt", (T,), VOCAB, 1000, 100, kind="seq2seq",
                      src_len=SRC)


@pytest.fixture(scope="module", autouse=True)
def tiny_variant():
    js2s._VARIANTS["seq2seq_t"] = TINY
    s2s._VARIANTS["seq2seq_t"] = TINY
    yield
    del s2s._VARIANTS["seq2seq_t"]


def _batch(seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, VOCAB, (B, T + 1)).astype(np.int32)
    y = seq[:, 1:].copy()
    y[:, :SRC - 1] = -1  # the source-internal labels
    return seq[:, :-1], y


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaves(model, tree):
    out = []
    for layer, ltree in zip(model.layers, tree):
        flat = dict(_flat(ltree))
        out.extend((p, np.asarray(flat[n]))
                   for n, p in layer.named_parameters())
    return out


def _pair(backend, fused):
    jm = js2s.build_seq2seq("seq2seq_t", (T,), VOCAB, SRC)
    jcfg = JaxRunConfig(benchmark="synthmt", arch="seq2seq_t",
                        compute_dtype="float32", attention_backend=backend,
                        fused_head_loss=fused)
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(0))
    model = s2s.build_seq2seq("seq2seq_t", (T,), VOCAB, SRC)
    from_jax_params(model, jax.device_get(ts.params))
    cfg = RunConfig(benchmark="synthmt", arch="seq2seq_t",
                    compute_dtype="float32", attention_backend=backend,
                    fused_head_loss=fused)
    cfg.validate()
    assert cfg.resolved_optimizer() == jcfg.resolved_optimizer() == "adam"
    assert (cfg.resolved_label_smoothing()
            == jcfg.resolved_label_smoothing() == 0.1)
    ps = SingleStrategy(model, cfg)
    ps.init()
    return jm, js, jcfg, ts, ps


@pytest.fixture
def backend(request):
    jtr.set_attention_backend(request.param)
    ttr.set_attention_backend(request.param)
    yield request.param
    jtr.set_attention_backend("auto")
    ttr.set_attention_backend("auto")


def test_forward_logits_match_jax():
    jm, _, _, ts, ps = _pair("xla", True)
    x, _ = _batch(0)
    want, _ = jax_apply_model(jm, ts.params, ts.model_state, jnp.asarray(x),
                              False)
    with torch.no_grad():
        got = ps.model(torch.from_numpy(x).long())
    assert [n for n, _ in ps.model.layers[0].named_parameters()] == [
        "tok", "pos", "seg"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_synthetic_source_labels_are_masked():
    """Positions < src_len - 1 carry label -1 (position src_len - 1
    predicts the first target token), as the reference's
    mask_source_labels; the port's batches are seq2seq streams."""
    labels = np.random.default_rng(1).integers(0, VOCAB, (3, T))
    got = mask_source_labels(torch.from_numpy(labels), SRC)
    want = jax_mask_source_labels(jnp.asarray(labels), SRC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    data = make_synthetic(TINY_MT, 3, torch.device("cpu"), steps_per_epoch=2)
    x, y = data.batch(0, 0)
    assert x.shape == y.shape == (3, T)
    assert (y[:, :SRC - 1] == -1).all() and (y[:, SRC - 1:] >= 0).all()
    assert torch.equal(x[:, SRC:], y[:, SRC - 1:-1])
    assert int((y >= 0).sum()) == 3 * (T - SRC + 1)


@pytest.mark.parametrize("backend", ["flash", "xla"], indirect=True)
@pytest.mark.parametrize("fused", [True, False])
def test_two_adam_steps_match_jax(backend, fused):
    jm, js, jcfg, ts, ps = _pair(backend, fused)
    lr = jcfg.resolved_lr()
    jgrads = jax.jit(lambda p, x, y: jax_loss_and_grads(
        jm, jcfg, p, ts.model_state, x, y, jnp.float32, 0.1)[3])
    for step in range(2):
        x, y = _batch(10 + step)
        want_g = jgrads(ts.params, jnp.asarray(x), jnp.asarray(y))
        ts, jmet = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                                 jnp.float32(lr))
        m = ps.train_step(torch.from_numpy(x).long(),
                          torch.from_numpy(y).long(), lr)
        np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                                   **TOL)
        np.testing.assert_allclose(m["accuracy"].item(),
                                   float(jmet["accuracy"]), **TOL)
        pairs = _leaves(ps.model, want_g)
        assert len(pairs) == 26  # embed 3, two blocks of 10, head 3
        for p, g in pairs:
            np.testing.assert_allclose(p.grad.numpy(), g, **TOL)
        for p, w in _leaves(ps.model, ts.params):
            np.testing.assert_allclose(p.detach().numpy(), w, **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_eval_step_matches_jax(fused):
    _, js, _, ts, ps = _pair("xla", fused)
    x, y = _batch(20)
    want = js.eval_step(ts, jnp.asarray(x), jnp.asarray(y))
    got = ps.eval_step(torch.from_numpy(x).long(), torch.from_numpy(y).long())
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **TOL)
    for key in ("correct", "correct5", "count"):
        assert int(got[key]) == int(want[key]), key
    assert int(got["count"]) == B * (T - SRC + 1)


def test_zoo_builds_seq2seq_on_seq2seq_data_only():
    assert get_model("seq2seq_t", TINY_MT).layers[1].prefix_len == SRC
    with pytest.raises(ValueError, match="seq2seq dataset"):
        get_model("seq2seq_t", "synthtext")
    with pytest.raises(ValueError, match="token dataset"):
        get_model("transformer_t", TINY_MT)
    # the recurrent arches are ported too, on seq2seq data only
    assert type(get_model("seq2seq_lstm_t", TINY_MT).layers[1]).__name__ \
        == "LSTMLayer"
    with pytest.raises(ValueError, match="seq2seq dataset"):
        get_model("seq2seq_lstm_s", "synthtext")
    with pytest.raises(ValueError, match="src_len"):
        JaxDatasetSpec("bad", (T,), VOCAB, 1, 1, kind="seq2seq", src_len=T)
    with pytest.raises(ValueError, match="src_len"):
        DatasetSpec("bad", (T,), VOCAB, 1, 1, kind="seq2seq", src_len=T)
