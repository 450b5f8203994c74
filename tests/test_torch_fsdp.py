"""The port's fsdp (ZeRO-3) held to the reference's.

``FSDPStrategy`` (parallel/sharded.py: each layer's parameters packed,
sharded over gloo ranks of tests/torch_dp_ranks.RankPool, all-gathered
on use in the forward and again in the backward, the gradients
reduce-scattered) against the reference's ``FSDPStrategy`` on 2 and 4
virtual CPU devices, from the same weights and global batches, in
float32:

* transformer_t through the fused LM head (the port's plain versions of
  B4-B6), SGD, at K 1 and at ``grad_accum_steps`` 2: two steps' losses
  and accuracies, every parameter and the eval sums within rtol 1e-4,
  atol 1e-6 (test_torch_dp.py's bar);
* the tiny BatchNorm model (sync-BN over the global batch:
  models/layers.batch_parallel): the losses and running statistics
  within rtol 2e-4, atol 1e-6 and the parameters within rtol 5e-3, atol
  1e-5, test_torch_dp.py's BatchNorm bars (the one-pass global
  statistics reduce in another order on each side);
* each rank holds 1/n of every layer's packed parameters, padded to the
  world, and the optimizer state of that shard only;
* an MoE arch and ``remat_layers`` under fsdp and tp validate (they run
  in tests/test_torch_moe_dp.py and test_torch_remat_sharded.py), and
  ``remat_layers`` with an MoE arch stays refused
  (tests/test_torch_tp.py holds ``tp`` itself).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import math

import numpy as np

import pytest

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.parallel.sharded import FSDPStrategy as JaxFSDP
from torch_dp_ranks import RankPool, build_model
from torch_shard_ref import compare_step

from ddlbench_tpu_torch.config import RunConfig

pytestmark = pytest.mark.torchport

BN_LOSS = dict(rtol=2e-4, atol=1e-6)
BN_PARAMS = dict(rtol=5e-3, atol=1e-5)
LM_CFG = dict(benchmark="synthtext", compute_dtype="float32", momentum=0.5,
              weight_decay=0.0, batch_size=2, optimizer="sgd")
BN_CFG = dict(benchmark="mnist", compute_dtype="float32", momentum=0.5,
              weight_decay=1e-4, batch_size=4, optimizer="sgd")


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("accum", [1, 2])
def test_fsdp_transformer_matches_reference(ranks, accum, world):
    cfg = dict(LM_CFG, grad_accum_steps=accum)
    got = compare_step(ranks, "fsdp", JaxFSDP, "transformer_t", world, cfg,
                       2 * world * accum)
    # each layer whose backward reads its weights (the two blocks and the
    # head; the embedding's reads only the token ids) gathered again for
    # every micro-step's backward: its saved weights were not kept
    assert [r["regathers"] for r in got] == [3 * 2 * accum] * world


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_bn_model_matches_reference(ranks, world):
    compare_step(ranks, "fsdp", JaxFSDP, "bn", world, BN_CFG, 4 * world,
                 loss_tol=BN_LOSS, param_tol=BN_PARAMS, state_tol=BN_LOSS)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["transformer_t", "bn"])
def test_fsdp_shard_bytes(ranks, model, world):
    got = ranks.run("torch_shard_ranks:train", world, strategy="fsdp",
                    model=model, cfg=dict(LM_CFG if model != "bn"
                                          else BN_CFG),
                    batches=[], lr=0.1)
    net = build_model(model)
    padded = sum(-(-sum(p.numel() for p in layer.parameters()) // world)
                 * world for layer in net.layers)
    whole = sum(p.numel() for p in net.parameters())
    for r in got:
        assert r["param_bytes"] == 4 * padded // world
        assert r["opt_bytes"] == 4 * padded // world  # SGD: m only
        # 1/n of the whole plus at most world - 1 pad elements a layer
        assert 4 * whole / world <= r["param_bytes"] <= 4 * (
            whole / world + len(net.layers) * (world - 1) / world)
    assert math.isclose(sum(r["param_bytes"] for r in got), 4 * padded)


def test_fsdp_refusals():
    """MoE archs under fsdp (ROADMAP A.6b) and remat_layers under fsdp
    and tp (A.7b) were refused until they were ported
    (tests/test_torch_moe_dp.py, test_torch_remat_sharded.py): they
    validate now, as the reference's do; the reference's own refusal of
    remat_layers with an MoE arch stays, worded as the port words it."""
    for kw in (dict(strategy="fsdp", arch="transformer_moe_s"),
               dict(strategy="tp", arch="transformer_s", remat_layers=True),
               dict(strategy="fsdp", arch="transformer_s",
                    remat_layers=True)):
        for cls in (RunConfig, JaxRunConfig):
            cls(num_devices=2, benchmark="synthtext", **kw).validate()
    with pytest.raises(ValueError, match="remat_layers is incompatible "
                                         "with MoE"):
        RunConfig(strategy="fsdp", num_devices=2, benchmark="synthtext",
                  arch="transformer_moe_s", remat_layers=True).validate()


@pytest.mark.parametrize("strategy", ["sp", "ep", "fsdp"])
def test_cli_sharded_end_to_end(capfd, monkeypatch, strategy):
    """-f sp|ep|fsdp -g 2 --device cpu trains on gloo ranks through the
    CLI's entry points: rank 0 alone prints the reference's lines, the
    comm volume is the reference's zero line for these strategies, and
    the result is rank 0's summary with a finite eval loss."""
    import json

    import numpy as np

    from ddlbench_tpu_torch import cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    arch = "transformer_moe_t" if strategy == "ep" else "transformer_t"
    argv = ["-f", strategy, "-g", "2", "-b", "synthtext", "-m", arch,
            "-e", "1", "--steps-per-epoch", "1", "--batch-size", "1",
            "--dtype", "float32", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capfd.readouterr().out.splitlines()
    assert out.count("comm volume/step: 0.00 MB (boundaries 0.00 MB, "
                     "allreduce 0.00 MB)") == 1, out
    assert sum(line.startswith("train | 1/1 epoch") for line in out) == 1
    assert sum(line.startswith("valid accuracy: ") for line in out) == 1
    result = json.loads(out[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])


@pytest.mark.parametrize("model", ["transformer_t", "bn"])
def test_convert_carries_reference_weights_into_shards(ranks, model):
    """convert.to_fsdp_shards packs each layer of the reference's weights
    as fsdp does and fills every rank's shard: gathered, the whole."""
    import jax

    from ddlbench_tpu.models import init_model
    from torch_shard_ref import JAX_MODELS, _by_name

    from ddlbench_tpu_torch.convert import to_port_layout

    params = jax.device_get(init_model(JAX_MODELS[model](),
                                       jax.random.key(5))[0])
    got = ranks.run("torch_shard_ranks:load_shards", 2, strategy="fsdp",
                    model=model, cfg=dict(LM_CFG if model != "bn"
                                          else BN_CFG), params=params)
    for name, want in _by_name(params).items():
        np.testing.assert_array_equal(got[1][name], to_port_layout(want),
                                      err_msg=name)
