"""The port's replicated data-parallel engine held to the reference's.

``ddlbench_tpu_torch``'s DPStrategy (parallel/dp.py) on gloo ranks on the
CPU (tests/torch_dp_ranks.py, started once for the file) against
``ddlbench_tpu.parallel.dp.DPStrategy``'s replicated (GSPMD) engine on the
virtual CPU mesh, at worlds and ``num_devices`` 2 and 4, in float32, from
the same weights (convert.from_jax_params) and the same numpy global
batches, over 4 steps:

* the tiny dense model under SGD and Adam, K 1 and 2, label smoothing
  0.1: every step's loss and the final parameters within
  test_torch_train.py's rtol 1e-4, atol 1e-6;
* the tiny BatchNorm model (sync-BN: models/layers.batch_parallel): the
  losses and running statistics within rtol 2e-4, atol 1e-6, the
  parameters within rtol 5e-3, atol 1e-5, the reference's own bars
  between its explicit and GSPMD BatchNorm (tests/test_dp_shard.py::
  test_bn_sync_statistics_close_to_replicated): the one-pass global
  statistics reduce in another order on each side;
* the tiny transformer through the fused LM head (the reference's chunked
  fused path, the port's plain versions of B4-B6), Adam at K 1 and SGD at
  K 2: at rtol 1e-4, atol 1e-6.

Also the training loop's learning rate per step (the world and K scaling
of SGD, Adam unscaled, the gradual warmup) against the reference loop's,
the eval step, and ``-f dp -g 2 --device cpu`` end to end through the
CLI, whose rank 0 alone prints the records and the reference's comm
volume.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import (LayerModel, conv_bn, dense, flatten,
                                        global_avg_pool)
from ddlbench_tpu.parallel.api import make_strategy as jax_make_strategy
from ddlbench_tpu.parallel.dp import DPStrategy as JaxDP
from ddlbench_tpu.train.comm_stats import comm_stats as jax_comm_stats
from ddlbench_tpu.train.loop import run_benchmark as jax_run_benchmark
from tiny_models import TINY_LM, tiny_dense_model, tiny_transformer
from torch_dp_ranks import RankPool

from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.convert import to_port_layout

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
BN_LOSS = dict(rtol=2e-4, atol=1e-6)
BN_PARAMS = dict(rtol=5e-3, atol=1e-5)
STEPS = 4


def _bn_model():
    return LayerModel("tinybn", [conv_bn("c1", 4), global_avg_pool(),
                                 flatten(), dense("fc", 4)], (4, 4, 1), 4)


JAX_MODELS = {"dense": tiny_dense_model, "bn": _bn_model,
              "transformer_t": tiny_transformer}


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _batches(model, B, steps=STEPS, seed=100):
    rng = np.random.default_rng(seed)
    if model == "transformer_t":
        out = []
        for _ in range(steps):
            seq = rng.integers(0, TINY_LM.num_classes,
                               (B, TINY_LM.seq_len + 1)).astype(np.int32)
            out.append((seq[:, :-1], seq[:, 1:]))
        return out
    return [(rng.normal(size=(B, 4, 4, 1)).astype(np.float32),
             rng.integers(0, 4, B).astype(np.int32)) for _ in range(steps)]


def _jax_run(model, cfg, batches, lr):
    """The reference's replicated dp over ``batches``: (its initial
    params and states, per-step losses, final params, final states)."""
    strat = JaxDP(JAX_MODELS[model](), cfg)
    ts = strat.init(jax.random.key(0))
    init = jax.device_get(ts.params), jax.device_get(ts.model_state)
    losses = []
    for x, y in batches:
        ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                 jnp.float32(lr))
        losses.append(float(m["loss"]))
    return (init, losses, jax.device_get(ts.params),
            jax.device_get(ts.model_state))


def _by_name(tree):
    out = {}
    for i, layer in enumerate(tree):
        def walk(d, prefix):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    out[f"{i}.{prefix}{k}"] = np.asarray(v)
        walk(layer, "")
    return out


def _compare(ranks, model, world, kw, lr, loss_tol, param_tol,
             state_tol=None):
    base = dict(strategy="dp", compute_dtype="float32", **kw)
    jcfg = JaxRunConfig(num_devices=world, **base)
    jcfg.validate()
    batches = _batches(model, jcfg.global_batch())
    (params, states), losses, jparams, jstates = _jax_run(model, jcfg,
                                                          batches, lr)
    out = ranks.run("train", world, model=model, cfg=base, batches=batches,
                    lr=lr, params=params, states=states)
    got = out[0]
    np.testing.assert_allclose(got["losses"], losses, **loss_tol)
    for name, v in _by_name(jparams).items():
        np.testing.assert_allclose(got["params"][name],
                                   to_port_layout(v), err_msg=name,
                                   **param_tol)
    if state_tol is not None:
        for name, v in _by_name(jstates).items():
            np.testing.assert_allclose(got["buffers"][name], v,
                                       err_msg=name, **state_tol)
    for other in out[1:]:
        np.testing.assert_array_equal(other["losses"], got["losses"])
    return got


DENSE = dict(benchmark="mnist", batch_size=2, momentum=0.5,
             weight_decay=1e-4, label_smoothing=0.1)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("world", [2, 4])
def test_dense_matches_jax(ranks, world, optimizer, accum):
    lr = 0.2 if optimizer == "sgd" else 1e-2
    _compare(ranks, "dense", world,
             dict(DENSE, optimizer=optimizer, grad_accum_steps=accum), lr,
             TOL, TOL)


@pytest.mark.parametrize("world,accum", [(2, 1), (4, 1), (2, 2)])
def test_batchnorm_matches_jax(ranks, world, accum):
    """Sync-BN: the global batch's statistics (each micro-step's, with
    K 2), on every rank."""
    got = _compare(ranks, "bn", world,
                   dict(benchmark="mnist", batch_size=4, momentum=0.5,
                        weight_decay=1e-4, grad_accum_steps=accum), 0.2,
                   BN_LOSS, BN_PARAMS, BN_LOSS)
    assert not np.allclose(got["buffers"]["0.bn.mean"], 0.0)


@pytest.mark.parametrize("world,optimizer,accum", [(2, "adam", 1),
                                                   (4, "sgd", 2)])
def test_fused_head_transformer_matches_jax(ranks, world, optimizer, accum):
    lr = 1e-2 if optimizer == "adam" else 0.5
    _compare(ranks, "transformer_t", world,
             dict(benchmark="synthtext", arch="transformer_t", batch_size=1,
                  optimizer=optimizer, grad_accum_steps=accum,
                  fused_head_loss=True, attention_backend="xla"), lr,
             TOL, TOL)


def test_eval_step_matches_jax(ranks):
    cfg = dict(benchmark="mnist", strategy="dp", compute_dtype="float32")
    jcfg = JaxRunConfig(num_devices=4, **cfg)
    strat = JaxDP(tiny_dense_model(), jcfg)
    ts = strat.init(jax.random.key(0))
    x, y = _batches("dense", 16, 1)[0]
    want = jax.device_get(strat.eval_step(ts, *strat.shard_batch(x, y)))
    got = ranks.run("evaluate", 4, model="dense", cfg=cfg, batch=(x, y),
                    params=jax.device_get(ts.params))[0]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), **TOL)
    for k in ("correct", "correct5", "count"):
        assert got[k] == int(want[k]), k


LOOP = dict(benchmark="mnist", arch="lenet", strategy="dp",
            compute_dtype="float32", batch_size=2, steps_per_epoch=3,
            epochs=2, log_interval=3)


@pytest.mark.parametrize("kw", [
    dict(optimizer="sgd", grad_accum_steps=2, warmup_epochs=1),
    dict(optimizer="sgd", warmup_epochs=2, lr_step_epochs=1),
    dict(optimizer="adam", warmup_epochs=1),
    dict(optimizer="sgd", scale_lr_by_world=False),
])
def test_loop_lr_matches_jax(ranks, kw):
    """The learning rate of every step (the warm-up step's first) of the
    port's loop against the reference loop's, at world 2."""
    jcfg = JaxRunConfig(num_devices=2, **LOOP, **kw)
    strat = jax_make_strategy(jcfg)
    step, want = strat.train_step, []

    def recording(ts, x, y, lr):
        want.append(float(lr))
        return step(ts, x, y, lr)

    strat.train_step = recording
    jax_run_benchmark(jcfg, strat, warmup_steps=1)
    got = ranks.run("loop_lrs", 2, cfg=dict(LOOP, **kw))
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-7, atol=0)
    assert len(got[0]) == 1 + 2 * 3


def test_ranks_run_one_thread_each(ranks):
    """The pool's gloo ranks each run torch on one thread, so the four
    share the cores with the other test workers."""
    assert ranks.run("threads", 4) == [1, 1, 1, 1]


def test_cli_dp_end_to_end(capfd, tmp_path, monkeypatch):
    """-f dp -g 2 --device cpu trains transformer_t on gloo ranks: rank 0
    alone prints the reference's lines and writes the records, the comm
    volume is the reference's for the same run, and the result is rank
    0's summary."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jsonl = tmp_path / "m.jsonl"
    argv = ["-f", "dp", "-g", "2", "-b", "synthtext", "-m", "transformer_t",
            "-e", "1", "--steps-per-epoch", "1", "--batch-size", "1",
            "--dtype", "float32", "--attention-backend", "xla",
            "--jsonl", str(jsonl)]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capfd.readouterr().out.splitlines()
    jcfg = JaxRunConfig(benchmark="synthtext", arch="transformer_t",
                        strategy="dp", num_devices=2, batch_size=1)
    cs = jax_comm_stats(JaxDP(tiny_transformer_synthtext(), jcfg))
    want = (f"comm volume/step: {cs['total_bytes'] / 1e6:.2f} MB "
            f"(boundaries 0.00 MB, allreduce "
            f"{cs['allreduce_bytes'] / 1e6:.2f} MB)")
    assert out.count(want) == 1, out
    assert sum(line.startswith("train | 1/1 epoch") for line in out) == 1
    assert sum(line.startswith("valid accuracy: ") for line in out) == 1
    assert out[0].startswith("run manifest: {")
    result = json.loads(out[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])
    kinds = [json.loads(line)["kind"]
             for line in jsonl.read_text().splitlines()]
    assert kinds == ["train_interval", "epoch", "valid", "summary"]


def tiny_transformer_synthtext():
    import ddlbench_tpu.models.transformer as jtr

    return jtr.build_transformer("transformer_t", (1024,), 32_768)
