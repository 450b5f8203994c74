"""Composed tensor x pipeline parallelism (parallel/tpp.py,
``TPGPipeStrategy``) held to the reference's and to the port's gpipe.

One gloo rank a tensor-parallel shard (tests/torch_dp_ranks.RankPool,
cases in tests/torch_tp_ranks.py), each walking gpipe's fill-drain over
its two stages on the CPU:

* the reference's tier-1 pin (tests/test_tpp.py
  ``test_tpp_matches_gpipe_loss_trajectory``): 2 stages x 2 shards on
  the tiny LM (T 32, vocab 64), micro-batch 2 x 2 microbatches, float32,
  the unfused head, the plain attention, lr 0.05, two steps on the
  reference's random batches from the reference's initial weights. The
  port's trajectory equals the reference's tpp and gpipe trajectories
  within rtol 1e-5, atol 1e-6 (the reference holds its two to rtol
  2e-4, atol 2e-5), and the stage bounds are the unsliced model's;
* each rank's gradients on one more batch, the sliced leaves put back
  together from the ranks, against the port's gpipe at 2 stages on the
  same weights: every leaf within 1e-5 relative L2, the replicated
  leaves equal on both ranks;
* the reference's ``tp_size`` gates (tests/test_tpp.py
  ``test_tp_size_config_validation``) and the port's: fill-drain only,
  no interleaving, no ``dp_shard_update``; ``dp_replicas`` > 1 (3-D
  tpp, tests/test_torch_tpp3d.py) validates;
* ``-f gpipe --tp-size 2 -g 4 --device cpu`` through the CLI: the
  reference's note on the fused head once, rank 0's lines, a finite
  eval loss.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from tiny_models import TINY_LM
from torch_dp_ranks import RankPool
from torch_tp_ranks import tpp_model

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.transformer import tp_merge_layer_params

pytestmark = pytest.mark.torchport

BASE = dict(benchmark="tinylm", arch="transformer_t", strategy="gpipe",
            micro_batch_size=2, num_microbatches=2,
            compute_dtype="float32", fused_head_loss=False,
            steps_per_epoch=2, attention_backend="xla")
LR = 0.05


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _batches(B, T, steps, seed=10):
    out = []
    for step in range(steps):
        x = jax.random.randint(jax.random.key(seed + step), (B, T), 0,
                               TINY_LM.num_classes, jnp.int32)
        y = jax.random.randint(jax.random.key(seed + 40 + step), (B, T), 0,
                               TINY_LM.num_classes, jnp.int32)
        out.append((np.asarray(x), np.asarray(y)))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_tpp_matches_reference_trajectory(ranks):
    from ddlbench_tpu.parallel.api import make_strategy

    import ddlbench_tpu.models.transformer as jtr

    # make_strategy sets the reference's process-wide attention backend:
    # kept to this block, so the reference's own tests see their default
    with mock.patch.dict(jconfig.DATASETS, {"tinylm": TINY_LM}), \
            mock.patch.object(jtr, "_ATTENTION_BACKEND", ["auto"]):
        cfg_ref = JaxRunConfig(num_devices=2, num_stages=2, **BASE)
        cfg_tpp = JaxRunConfig(num_devices=4, num_stages=2, tp_size=2,
                               **BASE)
        ref, jtpp = make_strategy(cfg_ref), make_strategy(cfg_tpp)
        ts_r, ts_t = ref.init(jax.random.key(0)), jtpp.init(jax.random.key(0))
        params = jax.device_get(init_model(ref.model, jax.random.key(0))[0])
        batches = _batches(cfg_ref.global_batch(), TINY_LM.seq_len, 2)
        losses_r, losses_t = [], []
        for x, y in batches:
            ts_r, m_r = ref.train_step(ts_r, *ref.shard_batch(x, y),
                                       jnp.float32(LR))
            ts_t, m_t = jtpp.train_step(ts_t, *jtpp.shard_batch(x, y),
                                        jnp.float32(LR))
            losses_r.append(float(m_r["loss"]))
            losses_t.append(float(m_t["loss"]))
    cfg = {k: v for k, v in BASE.items() if k not in ("strategy",)}
    got = ranks.run("torch_tp_ranks:tpp", 2, cfg=dict(
        cfg, num_devices=4, num_stages=2), params=params, batches=batches,
        lr=LR)
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["bounds"] == list(jtpp.bounds) == list(ref.bounds)
    np.testing.assert_allclose(got[0]["losses"], losses_t, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0]["losses"], losses_r, rtol=1e-5,
                               atol=1e-6)
    assert losses_r[0] != losses_r[-1]  # the trajectory moved


def test_tpp_gradients_match_port_gpipe(ranks):
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
    from tiny_models import tiny_transformer

    params = jax.device_get(init_model(tiny_transformer(),
                                       jax.random.key(3))[0])
    (x, y), = _batches(4, TINY_LM.seq_len, 1, seed=20)
    cfg = {k: v for k, v in BASE.items() if k not in ("strategy",)}
    got = ranks.run("torch_tp_ranks:tpp", 2, cfg=dict(
        cfg, num_devices=4, num_stages=2), params=params, batches=[],
        lr=LR, grad_batch=(x, y))
    gp = GPipeStrategy(tpp_model(params), RunConfig(
        num_devices=2, num_stages=2, **BASE), [torch.device("cpu")] * 2)
    gp.init()
    m, want = gp.reduced_grads(torch.from_numpy(np.array(x)).long(),
                               torch.from_numpy(np.array(y)).long())
    assert abs(got[0]["grad_loss"] - float(m["loss"])) <= 1e-6 * abs(
        float(m["loss"]))
    g0, g1 = got[0]["grads"], got[1]["grads"]
    assert g0.keys() == want.keys()
    by_layer = {}
    for name in want:
        i, key = name.split(".", 1)
        if g0[name].shape == tuple(want[name].shape):
            np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)
            assert _rel(g0[name], want[name].numpy()) <= 1e-5, name
        else:
            by_layer.setdefault(i, []).append(key)
    assert sorted(by_layer) == ["1", "2"]  # the two dense blocks
    for i, keys in by_layer.items():
        merged = tp_merge_layer_params(
            [{k: torch.from_numpy(g[f"{i}.{k}"]) for k in keys}
             for g in (g0, g1)], {})
        for k, t in merged.items():
            assert _rel(t.numpy(), want[f"{i}.{k}"].numpy()) <= 1e-5, (i, k)


@pytest.mark.parametrize("case", [
    "valid", "pipedream", "image", "devices", "schedule", "interleaved",
    "shard_update", "dp_replicas"])
def test_tp_size_gates(case):
    """The reference's gates (tests/test_tpp.py:67), worded as it words
    them; 3-D parallelism validates."""
    kw = dict(strategy="gpipe", benchmark="synthtext", arch="transformer_t",
              num_devices=4, tp_size=2, num_stages=2, micro_batch_size=2,
              num_microbatches=2)
    want = {"pipedream": (ValueError, "tp_size"),
            "image": (ValueError, "token or seq2seq"),
            "devices": (ValueError, "must equal"),
            "schedule": (ValueError, "fill-drain"),
            "interleaved": (ValueError, "interleaved"),
            "shard_update": (ValueError, "tp_size > 1 keeps the replicated"),
            "dp_replicas": None}
    kw.update({"valid": {},
               "pipedream": dict(strategy="pipedream", micro_batch_size=None,
                                 num_microbatches=None),
               "image": dict(benchmark="mnist", arch="resnet18"),
               "devices": dict(num_stages=4),
               "schedule": dict(pipe_schedule="1f1b"),
               "interleaved": dict(virtual_stages=2, num_devices=4),
               "shard_update": dict(dp_shard_update=True),
               "dp_replicas": dict(dp_replicas=2, num_devices=8)}[case])
    cfg = RunConfig(**kw)
    if case == "valid":
        cfg.validate()
        assert cfg.spawned_ranks() == 2 and cfg.global_batch() == 4
        return
    if case == "dp_replicas":  # 3-D tpp, tests/test_torch_tpp3d.py
        cfg.validate()
        assert cfg.spawned_ranks() == 4 and cfg.global_batch() == 8
        return
    err, match = want[case]
    with pytest.raises(err, match=match):
        cfg.validate()


def test_cli_tpp_end_to_end(capfd, monkeypatch):
    from ddlbench_tpu_torch import cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["-f", "gpipe", "--tp-size", "2", "-g", "4", "-b", "synthtext",
            "-m", "transformer_t", "-e", "1", "--steps-per-epoch", "1",
            "--micro-batch-size", "1", "--num-microbatches", "2",
            "--dtype", "float32", "--device", "cpu"]
    assert cli.main(argv) == 0
    cap = capfd.readouterr()
    out, err = cap.out.splitlines(), cap.err
    assert err.count("tpp: fused projection+loss head is not supported "
                     "under tp_size > 1; using the unfused CE head") == 1
    assert sum(line.startswith("schedule advisor") for line in out) == 2
    assert sum(line.startswith("train | 1/1 epoch") for line in out) == 1
    result = json.loads(out[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])
