"""``remat_layers`` (each layer recomputed in the backward: the
reference's ``jax.checkpoint`` a layer) under fsdp and tp, and for the
BatchNorm models on single, dp and fsdp, held to the reference.

On gloo ranks of tests/torch_dp_ranks.RankPool (fsdp and tp:
tests/torch_shard_ref.compare_step; dp: tests/test_torch_dp's
comparison), from the reference's initial weights, over the same numpy
global batches, both sides with ``remat_layers=True``:

* fsdp and tp at worlds 2 and 4 on the tiny LM and on "bn" (a
  convolution with BatchNorm, sync-BN under fsdp): two SGD steps' losses
  and accuracy, every parameter and running statistic after them, the
  eval sums, at the bars of the strategies' own tests (rtol 1e-4, atol
  1e-6; "bn" 2e-4 on the loss and statistics, 5e-3 / 1e-5 on the
  parameters, whose BatchNorm gradients cancel in float32);
* the port with remat on against off, both strategies and both models:
  the losses and parameters within 1e-6 relative, the running
  statistics bitwise (the recompute updates none), and fsdp's re-gather
  count the same (the recompute runs on the backward's one gather);
* "bn" on single (two steps against the reference's SingleStrategy)
  and dp (world 2, the replicated engine) with remat: the same bars,
  and single's statistics bitwise those of its run without remat.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.parallel.sharded import FSDPStrategy as JaxFSDP
from ddlbench_tpu.parallel.sharded import TPStrategy as JaxTP
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle
from test_torch_dp import _compare as dp_compare
from torch_dp_ranks import RankPool, _port_batch
from torch_shard_ref import (JAX_MODELS, _by_name, _image_batches,
                             compare_step)
from torch_shard_ranks import build

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import (from_jax_params, from_jax_state,
                                        to_port_layout)
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

BN_LOSS = dict(rtol=2e-4, atol=1e-6)
BN_PARAMS = dict(rtol=5e-3, atol=1e-5)
ON_OFF = dict(rtol=1e-6, atol=1e-8)
LM_CFG = dict(benchmark="synthtext", compute_dtype="float32", momentum=0.5,
              weight_decay=0.0, batch_size=2, optimizer="sgd",
              remat_layers=True)
BN_CFG = dict(benchmark="mnist", compute_dtype="float32", momentum=0.5,
              weight_decay=1e-4, batch_size=4, optimizer="sgd",
              remat_layers=True)
STRATS = {"fsdp": JaxFSDP, "tp": JaxTP}


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _cfg(model):
    return LM_CFG if model != "bn" else BN_CFG


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["transformer_t", "bn"])
@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_remat_matches_reference(ranks, strategy, model, world):
    bn = model == "bn"
    B = (4 if bn else 2) * world
    compare_step(ranks, strategy, STRATS[strategy], model, world,
                 _cfg(model), B,
                 **(dict(loss_tol=BN_LOSS, param_tol=BN_PARAMS,
                         state_tol=BN_LOSS) if bn else {}))


@pytest.mark.parametrize("model", ["transformer_t", "bn"])
@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_remat_on_and_off_agree(ranks, strategy, model):
    rng = np.random.default_rng(5)
    if model == "bn":
        batches, _ = _image_batches(rng, 8, 2)
    else:
        batches = [(seq[:, :-1], seq[:, 1:].copy()) for seq in (
            rng.integers(0, 64, (4, 33)).astype(np.int32)
            for _ in range(2))]
    params = _init_weights(model)
    runs = {}
    for remat in (False, True):
        runs[remat] = ranks.run(
            "torch_shard_ranks:train", 2, strategy=strategy, model=model,
            cfg=dict(_cfg(model), remat_layers=remat), batches=batches,
            lr=0.1, params=params[0], states=params[1])
    for off, on in zip(runs[False], runs[True]):
        np.testing.assert_allclose(on["losses"], off["losses"], **ON_OFF)
        for name, v in off["params"].items():
            np.testing.assert_allclose(on["params"][name], v, **ON_OFF,
                                       err_msg=name)
        for name, v in off["buffers"].items():
            np.testing.assert_array_equal(on["buffers"][name], v,
                                          err_msg=name)
        assert on["regathers"] == off["regathers"]
    if model == "bn":
        assert not np.allclose(runs[True][0]["buffers"]["0.bn.mean"], 0.0)
    if strategy == "fsdp":
        assert runs[True][0]["regathers"] > 0


def _init_weights(model):
    """The reference's initial (params, states) of ``model``, as numpy."""
    from ddlbench_tpu.models.layers import init_model

    return jax.device_get(init_model(JAX_MODELS[model](),
                                     jax.random.key(0))[:2])


def test_bn_single_remat_matches_reference():
    """single with remat on "bn" against the reference's SingleStrategy
    with remat (jax.checkpoint, the state returned functionally): the
    losses, every parameter and running statistic after two steps; the
    statistics bitwise those of the port's run without remat."""
    rng = np.random.default_rng(7)
    batches, _ = _image_batches(rng, 8, 2)
    jcfg = JaxRunConfig(strategy="single", **BN_CFG)
    jstrat = JaxSingle(JAX_MODELS["bn"](), jcfg)
    ts = jstrat.init(jax.random.key(0))
    params, states = jax.device_get((ts.params, ts.model_state))
    want = []
    for x, y in batches:
        ts, m = jstrat.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                                  jnp.float32(0.1))
        want.append(float(m["loss"]))
    jparams = _by_name(jax.device_get(ts.params))
    jstates = _by_name(jax.device_get(ts.model_state))
    runs = {}
    for remat in (True, False):
        net = build("bn")
        from_jax_params(net, params)
        from_jax_state(net, states)
        strat = SingleStrategy(net, RunConfig(strategy="single",
                                              **dict(BN_CFG,
                                                     remat_layers=remat)))
        strat.init()
        losses = [float(strat.train_step(
            _port_batch(x), torch.from_numpy(np.array(y)), 0.1)["loss"])
            for x, y in batches]
        runs[remat] = (losses, {f"{i}.{n}": p.detach().numpy() for i, layer
                                in enumerate(net.layers)
                                for n, p in layer.named_parameters()},
                       {f"{i}.{n}": b.detach().numpy() for i, layer in
                        enumerate(net.layers)
                        for n, b in layer.named_buffers()})
    losses, got, bufs = runs[True]
    np.testing.assert_allclose(losses, want, **BN_LOSS)
    for name, v in jparams.items():
        np.testing.assert_allclose(got[name], to_port_layout(v),
                                   **BN_PARAMS, err_msg=name)
    for name, v in jstates.items():
        np.testing.assert_allclose(bufs[name], v, **BN_LOSS, err_msg=name)
    for name, v in runs[False][2].items():
        np.testing.assert_array_equal(bufs[name], v, err_msg=name)
    np.testing.assert_allclose(losses, runs[False][0], **ON_OFF)


def test_bn_dp_remat_matches_reference(ranks):
    """The replicated dp engine with remat on "bn" (sync-BN, the
    recompute's statistics all-reduced again, its running statistics
    left alone) against the reference's dp with remat."""
    got = dp_compare(ranks, "bn", 2,
                     dict(benchmark="mnist", batch_size=4, momentum=0.5,
                          weight_decay=1e-4, remat_layers=True), 0.2,
                     BN_LOSS, BN_PARAMS, BN_LOSS)
    assert not np.allclose(got["buffers"]["0.bn.mean"], 0.0)
