"""The port's expert parallelism held to the reference's.

The ep step (parallel/ep.py: batch and experts sharded over gloo ranks of
tests/torch_dp_ranks.RankPool, the dispatch buffer exchanged by two
all_to_alls) against the reference's ``EPStrategy`` on 2 and 4 virtual
CPU devices, on tests/tiny_models.tiny_moe (8 experts, T 32, vocab 64),
one row a rank, from the same weights and batches, aux weight 0.01:

* at capacity factor 8, where no token drops, and at 1.25, where each
  rank's 32 tokens get 5 slots an expert and tokens drop (the capacity
  counts the rank's own tokens, so the drops are the reference's ep
  drops, not single's): two steps' losses and accuracies, every
  parameter (the experts gathered from the ranks) and the eval sums
  within rtol 1e-4, atol 1e-6 (test_torch_dp.py's bar);
* at capacity factor 8 and aux weight 0 the step equals the port's
  single step on the same rows within the same bar (the one case where
  the reference's test holds ep to single);
* each rank holds E/n of every expert stack, and the optimizer state of
  those only;
* the config gates: an MoE arch, a token benchmark, experts divisible by
  the world.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import numpy as np
import pytest
import torch

from ddlbench_tpu.parallel.ep import EPStrategy as JaxEP
from torch_dp_ranks import RankPool
from torch_shard_ref import TOL, compare_step

from ddlbench_tpu_torch import distributed
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.moe import build_transformer_moe
from ddlbench_tpu_torch.parallel.ep import EPStrategy, expert_param_specs

pytestmark = pytest.mark.torchport

EP_CFG = dict(benchmark="synthtext", arch="transformer_moe_t",
              compute_dtype="float32", momentum=0.5, weight_decay=0.0,
              batch_size=1, moe_aux_weight=0.01, optimizer="sgd")


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _tiny(cf=8.0):
    return build_transformer_moe("transformer_moe_t", (32,), 64,
                                 capacity_factor=cf)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["moe_t", "moe_t_125"])
def test_ep_step_matches_reference(ranks, model, world):
    got = compare_step(ranks, "ep", JaxEP, model, world, EP_CFG, world)
    dropped = sum(r["dropped"] for r in got)
    if model == "moe_t":
        assert dropped == 0
    else:
        assert dropped > 0  # the reference's ep drops, matched above


def test_ep_equals_single_without_drops(ranks):
    """cf 8, aux 0: ep at world 2 against the port's single step (the
    reference's update formulas on one process) on the same 2 rows."""
    from ddlbench_tpu_torch.parallel.common import (flat_optimizer,
                                                    loss_and_grads)

    cfg = dict(EP_CFG, moe_aux_weight=0.0)
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 64, (2, 33)).astype(np.int32)
    batch = (seq[:, :-1], seq[:, 1:])
    got = ranks.run("torch_shard_ranks:train", 2, strategy="ep",
                    model="moe_t", cfg=cfg, batches=[batch], lr=0.1)
    net = _tiny()
    rc = RunConfig(strategy="single", **cfg)
    params = list(net.parameters())
    init, update = flat_optimizer(rc)
    ce, _, grads = loss_and_grads(net, rc, torch.from_numpy(batch[0]),
                                  torch.from_numpy(batch[1]), torch.float32,
                                  0.0)
    with torch.no_grad():
        new, _ = update(params, grads, init(params), 0.1)
    np.testing.assert_allclose(got[0]["losses"][0], float(ce), **TOL)
    want = {f"{i}.{n}": t for (i, n), t in zip(
        [(i, n) for i, layer in enumerate(net.layers)
         for n, _ in layer.named_parameters()], new)}
    for name, t in want.items():
        np.testing.assert_allclose(got[0]["params"][name], t.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_ep_shards_experts_and_their_state(ranks, world):
    got = ranks.run("torch_shard_ranks:train", world, strategy="ep",
                    model="moe_t", cfg=dict(EP_CFG), batches=[], lr=0.1)
    net = _tiny()
    specs = expert_param_specs(net)
    assert sum(specs.values()) == 4  # w1, b1, w2, b2 of the one MoE block
    named = {f"{i}.{n}": p for i, layer in enumerate(net.layers)
             for n, p in layer.named_parameters()}
    rep = sum(4 * p.numel() for n, p in named.items() if not specs[n])
    experts = sum(4 * p.numel() for n, p in named.items() if specs[n])
    for r in got:
        assert r["param_bytes"] == rep + experts // world
        assert r["opt_bytes"] == rep + experts // world  # SGD: m only


def test_ep_config_gates():
    with pytest.raises(ValueError, match="MoE arch"):
        RunConfig(strategy="ep", benchmark="synthtext",
                  arch="transformer_s", num_devices=2).validate()
    with pytest.raises(ValueError, match="token benchmark"):
        RunConfig(strategy="ep", benchmark="mnist",
                  arch="transformer_moe_s", num_devices=2).validate()
    with pytest.raises(ValueError, match="grad_accum_steps"):
        RunConfig(strategy="ep", benchmark="synthtext", num_devices=2,
                  arch="transformer_moe_s", grad_accum_steps=2).validate()
    cfg = RunConfig(strategy="ep", num_devices=3, **EP_CFG)
    with pytest.raises(ValueError, match="8 experts not divisible by 3"):
        EPStrategy(_tiny(), cfg, distributed.Comm.describe(3))


def test_convert_carries_reference_experts_into_rank_slices(ranks):
    """convert.from_jax_params(..., expert_rank=(r, n)) gives each rank
    its slice of the reference's expert stacks: gathered, the whole."""
    import jax

    from ddlbench_tpu.models import init_model
    from tiny_models import tiny_moe
    from torch_shard_ref import _by_name

    from ddlbench_tpu_torch.convert import to_port_layout

    params = jax.device_get(init_model(tiny_moe(), jax.random.key(5))[0])
    got = ranks.run("torch_shard_ranks:load_shards", 4, strategy="ep",
                    model="moe_t", cfg=dict(EP_CFG), params=params)
    for name, want in _by_name(params).items():
        np.testing.assert_array_equal(got[0][name], to_port_layout(want),
                                      err_msg=name)
