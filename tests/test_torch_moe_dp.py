"""MoE archs under replicated dp and fsdp: routing over the global batch
(models/moe.global_routing), held to the reference's ``DPStrategy`` and
``FSDPStrategy`` and to the port's single on the global batch.

On gloo ranks of tests/torch_dp_ranks.RankPool (cases in
tests/torch_moe_ranks.py) at worlds 2 and 4, the tiny MoE (the tiny LM's
transformer_moe_t: a dense block, an MoE block of 8 experts) at capacity
factor 1.25, so tokens drop, with ``moe_aux_weight`` 0.01, float32, SGD,
from the reference's initial weights, at K 1 and 2 micro-steps:

* one step's forward and backward on a global batch against the port's
  single on that batch: the routes concatenated in rank order (each
  token's expert, its place in the global queue, kept or dropped) equal
  single's exactly, the dropped tokens among them (more than none); the
  aux loss within 1e-6 relative; the loss within 1e-6 and every
  gradient leaf within 1e-5 relative L2 of single's (the order of the
  sums differs);
* two steps against the reference's strategy: the losses (rtol 1e-4,
  atol 1e-6), every parameter after them and the eval sums, the bars of
  tests/test_torch_dp.py;
* the reference's refusal of MoE under the explicit dp engine, kept.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.parallel.dp import DPStrategy as JaxDP
from ddlbench_tpu.parallel.sharded import FSDPStrategy as JaxFSDP
from tiny_models import TINY_LM, tiny_moe
from torch_dp_ranks import RankPool
from torch_shard_ranks import build
from torch_shard_ref import _by_name

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, to_port_layout
from ddlbench_tpu_torch.parallel.common import loss_and_grads

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)  # test_torch_dp.py's bar
SINGLE_LOSS = 1e-6
SINGLE_GRAD_REL = 1e-5
CF = 1.25
LR = 0.1
CFG = dict(benchmark="synthtext", compute_dtype="float32", momentum=0.5,
           weight_decay=0.0, optimizer="sgd", moe_aux_weight=0.01,
           moe_capacity_factor=CF, attention_backend="xla")


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _batches(B, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, TINY_LM.num_classes,
                           (B, TINY_LM.seq_len + 1)).astype(np.int32)
        y = seq[:, 1:].copy()
        y[0, :4] = -1  # a masked stretch on rank 0's rows
        out.append((seq[:, :-1], y))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _reference(strategy, cfg, batches, eval_batch):
    """The reference's run: (initial params, losses, final params by
    name, eval sums)."""
    jcfg = JaxRunConfig(strategy=strategy, **cfg)
    jcfg.validate()
    model = tiny_moe(capacity_factor=CF)
    strat = (JaxDP(model, jcfg) if strategy == "dp" else
             JaxFSDP(model, jcfg, devices=jax.devices()[:cfg["num_devices"]]))
    ts = strat.init(jax.random.key(0))
    params = jax.device_get(ts.params)
    losses = []
    for x, y in batches:
        ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                 jnp.float32(LR))
        losses.append(float(m["loss"]))
    ev = strat.eval_step(ts, *strat.shard_batch(*eval_batch))
    return (params, losses, _by_name(jax.device_get(ts.params)),
            {k: float(v) for k, v in ev.items()})


def _single(params, cfg, batch):
    """The port's single on the global batch: (loss, gradients by name,
    the MoE block's route)."""
    from ddlbench_tpu_torch.models.moe import moe_blocks

    net = build("moe_t", CF)
    from_jax_params(net, params)
    scfg = RunConfig(strategy="single", **{**cfg, "num_devices": 1})
    x, y = (torch.from_numpy(np.array(t)).long() for t in batch)
    ce, _, grads = loss_and_grads(net, scfg, x, y, torch.float32,
                                  scfg.resolved_label_smoothing())
    names = [f"{i}.{n}" for i, layer in enumerate(net.layers)
             for n, _ in layer.named_parameters()]
    route = moe_blocks(net)[0].last_route
    return float(ce), {n: g.numpy() for n, g in zip(names, grads)}, route


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("strategy", ["dp", "fsdp"])
def test_moe_routes_over_the_global_batch(ranks, strategy, world, accum):
    per = 2 * accum
    cfg = dict(CFG, num_devices=world, batch_size=per,
               grad_accum_steps=accum)
    B = per * world
    batches = _batches(B, 2, seed=world + 10 * accum)
    grad_batch, eval_batch = _batches(B, 2, seed=99)
    params, losses, jparams, jeval = _reference(strategy, cfg, batches,
                                                eval_batch)
    got = ranks.run("torch_moe_ranks:train", world, strategy=strategy,
                    cfg=cfg, batches=batches, lr=LR, params=params,
                    grad_batch=grad_batch, eval_batch=eval_batch)
    # against single on the global batch
    s_loss, s_grads, route = _single(params, cfg, grad_batch)
    for key in ("expert", "slot", "keep"):
        whole = np.concatenate([r["routes"][0][key] for r in got])
        np.testing.assert_array_equal(whole, getattr(route, key).numpy(),
                                      err_msg=key)
    dropped = sum(int((~r["routes"][0]["keep"]).sum()) for r in got)
    assert dropped == int((~route.keep).sum()) > 0
    for r in got:
        assert abs(r["routes"][0]["aux"] - float(route.aux)) <= (
            SINGLE_LOSS * float(route.aux))
        assert abs(r["grad_loss"] - s_loss) <= SINGLE_LOSS * s_loss
        assert r["grads"].keys() == s_grads.keys()
        for name, g in s_grads.items():
            assert _rel(r["grads"][name], g) <= SINGLE_GRAD_REL, name
    # against the reference's strategy
    r0 = got[0]
    np.testing.assert_allclose(r0["losses"], losses, **TOL)
    assert all(r["losses"] == r0["losses"] for r in got)
    for name, want in jparams.items():
        np.testing.assert_allclose(r0["params"][name], to_port_layout(want),
                                   **TOL, err_msg=name)
    for key in ("correct", "correct5", "count"):
        assert r0["eval"][key] == jeval[key], key
    np.testing.assert_allclose(r0["eval"]["loss"], jeval["loss"], **TOL)


@pytest.mark.parametrize("kw", [dict(dp_shard_update=True),
                                dict(allreduce_dtype="bf16")])
def test_explicit_engine_refuses_moe(kw):
    """The reference refuses an MoE arch under the explicit dp engine
    (its router statistics would become per-shard); the port keeps the
    refusal, worded as the reference words it, while the replicated
    engine takes the arch."""
    base = dict(strategy="dp", num_devices=2, benchmark="synthtext",
                arch="transformer_moe_s")
    for cls in (RunConfig, JaxRunConfig):
        cls(**base).validate()
        with pytest.raises(ValueError, match="use replicated dp for MoE "
                                             "archs"):
            cls(**base, **kw).validate()
