"""Megatron's slicing in the port held to the reference's.

* ``models/transformer.tp_split_layer_params`` (the port's copy of the
  reference's splitter) against the reference's, bitwise, on every
  layer of transformer_t and of the tiny MoE model at 2 and 4 shards:
  the dense blocks split, the embedding, the head and the MoE blocks left
  whole; ``tp_merge_layer_params`` puts the shards back together.
* A sliced block's forward and backward on gloo ranks
  (tests/torch_dp_ranks.RankPool, tests/torch_tp_ranks.block) at tp 2
  and 4, under ``tensor_parallel`` (the row-parallel sums forward, the
  replicated inputs' gradients summed backward), against the
  reference's unsliced block in float32: the output, the input's
  gradient, the LayerNorm and ``b2`` gradients (whole on every rank:
  nothing else sums them) and the sliced leaves' gradients put back
  together from the ranks, each within 1e-6 relative L2 (the partial
  products add in another order than the whole matmul; measured 1.0e-7
  to 3.3e-7 a leaf; an elementwise bar would fail on the bias
  gradients' cancelling sums).
* ``convert.tp_shard_params`` against the reference's splitter leaf for
  leaf, and loaded into a model sliced to that shard.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.models.transformer as jtr
from ddlbench_tpu.models.layers import init_model
from tiny_models import tiny_moe, tiny_transformer
from torch_dp_ranks import RankPool

from ddlbench_tpu_torch.convert import (from_jax_params, tp_shard_params,
                                        to_port_layout)
from ddlbench_tpu_torch.models.transformer import (build_transformer,
                                                   slice_block,
                                                   tp_merge_layer_params,
                                                   tp_split_layer_params)

pytestmark = pytest.mark.torchport

REL = 1e-6  # relative L2 of a float32 array against the reference's


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= REL, (what, err)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _params(model, seed=0):
    return jax.device_get(init_model(model, jax.random.key(seed))[0])


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["transformer_t", "moe_t"])
def test_split_matches_reference_bitwise(model, n):
    params = _params(tiny_transformer() if model == "transformer_t"
                     else tiny_moe())
    split_layers = 0
    for layer in params:
        want_sh, want_rp = jtr.tp_split_layer_params(layer, n)
        got_sh, got_rp = tp_split_layer_params(layer, n)
        assert len(got_sh) == n
        for got, want in zip(got_sh, want_sh):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]),
                                              np.asarray(want[key]))
        assert dict(_leaves(got_rp)).keys() == dict(_leaves(want_rp)).keys()
        for (k, a), (_, b) in zip(_leaves(got_rp), _leaves(want_rp)):
            np.testing.assert_array_equal(a, b, err_msg=k)
        if want_sh[0]:
            split_layers += 1
            assert "experts" not in layer
            merged = tp_merge_layer_params(
                [{k: torch.from_numpy(np.array(v)) for k, v in sh.items()}
                 for sh in got_sh], {})
            for key, t in merged.items():
                np.testing.assert_array_equal(t.numpy(), layer[key])
    # transformer_t: both blocks; the MoE model: its one dense block
    assert split_layers == (2 if model == "transformer_t" else 1)


@pytest.mark.parametrize("n", [2, 4])
def test_sliced_block_matches_unsliced_reference(ranks, n):
    B, T, d, H = 2, 16, 32, 4
    layer = jtr.transformer_block("b", d, H)
    p, s, _ = layer.init(jax.random.key(1), (T, d))
    # nonzero biases and LN affines, so their gradients are not trivial
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), jax.device_get(p))
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    g = rng.standard_normal((B, T, d)).astype(np.float32)

    def f(p, x):
        return layer.apply(p, s, x, True)[0]

    y_ref, vjp = jax.vjp(f, p, jnp.asarray(x))
    dp_ref, dx_ref = jax.device_get(vjp(jnp.asarray(g)))
    got = ranks.run("torch_tp_ranks:block", n, params=p, x=x, g=g,
                    n_heads=H)
    for y, dx, _ in got:
        _close(y, y_ref, "y")
        _close(dx, dx_ref, "dx")
    want = dict(_leaves(dp_ref))
    for name in ("ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "b2"):
        for _, _, grads in got:  # whole on every rank
            _close(grads[name], want[name], name)
    merged = tp_merge_layer_params(
        [{k: torch.from_numpy(v) for k, v in grads.items()
          if k in jtr.TP_SLICED_KEYS} for _, _, grads in got], {})
    for name, t in merged.items():
        _close(t.numpy(), want[name], name)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_conversion(n):
    params = _params(tiny_transformer(), seed=4)
    full = from_jax_params(build_transformer("transformer_t", (32,), 64),
                           params)
    for r in range(n):
        shard = tp_shard_params(params, r, n)
        for layer, got in zip(params, shard):
            sh, rp = jtr.tp_split_layer_params(layer, n)
            want = {**rp, **sh[r]} if sh[r] else layer
            assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
            for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
                np.testing.assert_array_equal(a, b, err_msg=k)
        model = build_transformer("transformer_t", (32,), 64)
        assert [slice_block(layer, r, n) for layer in model.layers] == [
            False, True, True, False]
        from_jax_params(model, shard)
        for i, (layer, whole) in enumerate(zip(model.layers, full.layers)):
            named = {k: v.detach() for k, v in whole.named_parameters()}
            sh, _ = tp_split_layer_params(named, n)
            for k, p in layer.named_parameters():
                want = sh[r][k] if sh[r] and k in sh[r] else named[k]
                np.testing.assert_array_equal(
                    p.detach().numpy(), to_port_layout(want.numpy()),
                    err_msg=f"{i}.{k}")
