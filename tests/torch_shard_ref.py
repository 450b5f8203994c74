"""The reference's side of the sharded strategies' tests (sp, ep,
fsdp): its strategies on the virtual CPU mesh, run on the batches the
port's ranks (tests/torch_shard_ranks.py) get, and the comparison."""

import jax
import jax.numpy as jnp
import numpy as np

import ddlbench_tpu.models.seq2seq as jax_s2s
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import (LayerModel, conv_bn, dense, flatten,
                                        global_avg_pool)
from tiny_models import TINY_LM, tiny_moe, tiny_transformer
from torch_shard_ranks import TINY_SRC

from ddlbench_tpu_torch.convert import to_port_layout

TOL = dict(rtol=1e-4, atol=1e-6)  # test_torch_dp.py's bar


def _token_batches(rng, B, steps, src_len=0):
    out = []
    for _ in range(steps + 1):  # the last one is the eval batch
        seq = rng.integers(0, TINY_LM.num_classes,
                           (B, TINY_LM.seq_len + 1)).astype(np.int32)
        x, y = seq[:, :-1], seq[:, 1:].copy()
        if src_len:
            y[:, :src_len - 1] = -1  # source labels are masked
        out.append((x, y))
    return out[:-1], out[-1]


def _tiny_seq2seq():
    jax_s2s._VARIANTS.setdefault("seq2seq_t", dict(d_model=32, n_layers=2,
                                                   n_heads=4))
    return jax_s2s.build_seq2seq("seq2seq_t", TINY_LM.image_size,
                                 TINY_LM.num_classes, TINY_SRC)


def _bn_model():
    return LayerModel("tinybn", [conv_bn("c1", 4), global_avg_pool(),
                                 flatten(), dense("fc", 4)], (4, 4, 1), 4)


def _moe_125():
    return tiny_moe(capacity_factor=1.25)


JAX_MODELS = {"transformer_t": tiny_transformer, "moe_t": tiny_moe,
              "moe_t_125": _moe_125, "seq2seq_t": _tiny_seq2seq,
              "bn": _bn_model}


def _by_name(tree):
    out = {}
    for i, layer in enumerate(tree):
        def walk(d, prefix):
            for key, val in d.items():
                if isinstance(val, dict):
                    walk(val, f"{prefix}{key}.")
                else:
                    out[f"{i}.{prefix}{key}"] = np.asarray(val)
        walk(layer, "")
    return out


def _image_batches(rng, B, steps):
    out = [(rng.normal(size=(B, 4, 4, 1)).astype(np.float32),
            rng.integers(0, 4, B).astype(np.int32))
           for _ in range(steps + 1)]
    return out[:-1], out[-1]


def _jax_run(strategy_cls, model, cfg, batches, eval_batch, lr, n):
    strat = strategy_cls(JAX_MODELS[model](), cfg,
                         devices=jax.devices()[:n])
    ts = strat.init(jax.random.key(0))
    init = jax.device_get(ts.params), jax.device_get(ts.model_state)
    losses, accs = [], []
    for x, y in batches:
        ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                 jnp.float32(lr))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    ev = strat.eval_step(ts, *strat.shard_batch(*eval_batch))
    return (init, losses, accs, _by_name(jax.device_get(ts.params)),
            _by_name(jax.device_get(ts.model_state)),
            {k: float(v) for k, v in ev.items()})


def compare_step(ranks, strategy, strategy_cls, model, world, cfg, B,
                 steps=2, lr=0.1, src_len=0, loss_tol=TOL, param_tol=TOL,
                 state_tol=TOL):
    """The port's ``strategy`` against the reference's ``strategy_cls``
    at ``world`` ranks and devices, from the reference's initial weights,
    over ``steps`` global batches of ``B`` rows: every step's loss and
    accuracy, every parameter and running statistic after them, and the
    eval sums on one more batch. ``model`` names JAX_MODELS' entry (the
    port's twin: tests/torch_shard_ranks.build; "moe_t_125" is "moe_t"
    at capacity factor 1.25). Returns the rank results."""
    rng = np.random.default_rng(2)
    batches, eval_batch = (_image_batches(rng, B, steps) if model == "bn"
                           else _token_batches(rng, B, steps, src_len))
    jcfg = JaxRunConfig(strategy=strategy, num_devices=world, **cfg)
    (params0, states0), losses, accs, params, states, ev = _jax_run(
        strategy_cls, model, jcfg, batches, eval_batch, lr, world)
    got = ranks.run("torch_shard_ranks:train", world, strategy=strategy,
                    model=model.replace("_125", ""), cfg=cfg,
                    batches=batches, lr=lr, params=params0, states=states0,
                    capacity_factor=1.25 if model.endswith("_125") else 8.0,
                    eval_batch=eval_batch)
    r0 = got[0]
    np.testing.assert_allclose(r0["losses"], losses, **loss_tol)
    np.testing.assert_allclose(r0["accuracy"], accs, atol=1e-6)
    assert all(r["losses"] == r0["losses"] for r in got)
    for name, want in params.items():
        np.testing.assert_allclose(r0["params"][name], to_port_layout(want),
                                   **param_tol, err_msg=name)
    for name, want in states.items():
        np.testing.assert_allclose(r0["buffers"][name], want, **state_tol,
                                   err_msg=name)
    for key in ("correct", "correct5", "count"):
        assert r0["eval"][key] == ev[key], key
    np.testing.assert_allclose(r0["eval"]["loss"], ev["loss"], **loss_tol)
    return got
