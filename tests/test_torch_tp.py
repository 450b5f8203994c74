"""The port's ``-f tp`` (parallel/sharded.py ``TPStrategy``) held to the
reference's ``TPStrategy`` and to the port's single.

On gloo ranks of tests/torch_dp_ranks.RankPool (cases in
tests/torch_shard_ranks.py and tests/torch_tp_ranks.py), in float32,
from the reference's initial weights and the same global batches:

* against the reference's ``TPStrategy`` on 2 and 4 virtual CPU devices
  (tests/torch_shard_ref.compare_step): two SGD steps' losses and
  accuracies, every parameter after them, the running statistics and
  the eval sums, on transformer_t (Megatron-sliced blocks, the rest
  gathered on use, the fused head's plain versions) within rtol 1e-4,
  atol 1e-6 (tests/test_torch_dp.py's bar) and on the tiny BatchNorm
  model (every leaf gathered on use) within the BatchNorm bars of
  tests/test_torch_fsdp.py;
* against the port's single on the same weights and batch: the loss
  and every reduced gradient within 1e-5 relative L2 a leaf (single and
  tp reduce the same sums in another order), and after the two steps
  every parameter within 1e-5 relative L2 (one update formula:
  parallel/common.flat_optimizer);
* the elements each rank holds of each leaf equal the reference's shard
  of it (``_leaf_spec(x, 'model', n, prefer_last=True)``);
* an MoE arch trains (the batch is replicated, so it routes as single
  does): the loss and gradients at world 2 against single's;
* ``-f tp -g 2 --device cpu`` through the CLI.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json

import jax
import numpy as np
import pytest
import torch

from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.sharded import TPStrategy as JaxTP
from ddlbench_tpu.parallel.sharded import _leaf_spec
from torch_dp_ranks import RankPool, _port_batch
from torch_shard_ranks import build
from torch_shard_ref import (JAX_MODELS, _by_name, _image_batches,
                             _token_batches, compare_step)

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        to_port_layout)
from ddlbench_tpu_torch.parallel.common import loss_and_grads
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

BN_LOSS = dict(rtol=2e-4, atol=1e-6)
BN_PARAMS = dict(rtol=5e-3, atol=1e-5)
LM_CFG = dict(benchmark="synthtext", compute_dtype="float32", momentum=0.5,
              weight_decay=0.0, batch_size=2, optimizer="sgd")
BN_CFG = dict(benchmark="mnist", compute_dtype="float32", momentum=0.5,
              weight_decay=1e-4, batch_size=4, optimizer="sgd")
REL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _cfg(model):
    return LM_CFG if model != "bn" else BN_CFG


def _single(model, params, states=None):
    net = build(model)
    from_jax_params(net, params)
    if states is not None:
        from_jax_state(net, states)
    strat = SingleStrategy(net, RunConfig(**_cfg(model)))
    strat.init()
    return strat


def _batches(model, B, steps):
    rng = np.random.default_rng(2)  # compare_step's
    return (_image_batches(rng, B, steps) if model == "bn"
            else _token_batches(rng, B, steps))[0]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["transformer_t", "bn"])
def test_tp_matches_reference_and_single(ranks, model, world):
    B = 2 * world
    bn = model == "bn"
    got = compare_step(ranks, "tp", JaxTP, model, world, _cfg(model), B,
                       **(dict(loss_tol=BN_LOSS, param_tol=BN_PARAMS,
                               state_tol=BN_LOSS) if bn else {}))
    # the port's single from the same weights over the same batches
    params, states = jax.device_get(init_model(JAX_MODELS[model](),
                                               jax.random.key(0))[:2])
    single = _single(model, params, states)
    losses = [float(single.train_step(_port_batch(x),
                                      torch.from_numpy(np.array(y)),
                                      0.1)["loss"])
              for x, y in _batches(model, B, 2)]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=REL)
    for i, layer in enumerate(single.model.layers):
        for n, p in layer.named_parameters():
            assert _rel(got[0]["params"][f"{i}.{n}"],
                        p.detach().numpy()) <= REL, (i, n)


@pytest.mark.parametrize("model,world", [
    ("transformer_t", 2), ("transformer_t", 4), ("bn", 2), ("bn", 4),
    ("moe_t", 2)])
def test_tp_gradients_and_layout(ranks, model, world):
    jm = JAX_MODELS[model]()
    params, states = jax.device_get(init_model(jm, jax.random.key(1))[:2])
    batch = _batches(model, 4, 1)[0]
    cfg = dict(_cfg(model), moe_aux_weight=0.01)
    got = ranks.run("torch_tp_ranks:tp_grads", world, model=model, cfg=cfg,
                    batch=batch, params=params, states=states)
    single = _single(model, params, states)
    single.cfg = RunConfig(**cfg)
    ce, _, grads = loss_and_grads(
        single.model, single.cfg, _port_batch(batch[0]),
        torch.from_numpy(np.array(batch[1])), torch.float32, 0.0)
    want = {f"{i}.{n}": g for (i, n), g in zip(
        [(i, n) for i, layer in enumerate(single.model.layers)
         for n, _ in layer.named_parameters()], grads)}
    for r in got:
        assert abs(r["loss"] - float(ce)) <= REL * abs(float(ce))
        assert r["grads"].keys() == want.keys()
        for name, g in want.items():
            assert _rel(r["grads"][name], g.numpy()) <= REL, name
    # each rank holds what the reference's placement gives each device
    for name, leaf in _by_name(params).items():
        spec = _leaf_spec(leaf, "model", world, prefer_last=True)
        split = any(ax is not None for ax in spec)
        want_n = leaf.size // world if split else leaf.size
        assert all(r["counts"][name] == want_n for r in got), name
    assert sum(got[0]["counts"].values()) < sum(
        v.size for v in _by_name(params).values())


def test_cli_tp_end_to_end(capfd, monkeypatch):
    from ddlbench_tpu_torch import cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["-f", "tp", "-g", "2", "-b", "synthtext", "-m", "transformer_t",
            "-e", "1", "--steps-per-epoch", "1", "--batch-size", "1",
            "--dtype", "float32", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capfd.readouterr().out.splitlines()
    assert out.count("comm volume/step: 0.00 MB (boundaries 0.00 MB, "
                     "allreduce 0.00 MB)") == 1, out
    assert sum(line.startswith("train | 1/1 epoch") for line in out) == 1
    result = json.loads(out[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])
