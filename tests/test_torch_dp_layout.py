"""The port's flat-vector layout, int8 wire, warmup and comm accounting of
dp held bit for bit to the reference's functions (no processes).

* ``flat_meta`` on the leaf shapes of the tiny models, transformer_s and
  resnet50 at worlds 2, 4, 8 and buckets 1, 3, 8, and the port's leaf
  order (``ref_param_order``: per layer the sorted nested keys, a
  convolution kernel as HWIO) against ``jax.tree.leaves``;
* ``pack_flat`` of the port's parameters against the reference's of the
  same weights, bit for bit, and the pack/unpack and device-major round
  trips;
* ``sum_safe_qmax``, ``stochastic_round_int8`` and ``quantize_int8`` under
  the dp engine's key derivation (threefry, ops/threefry.py), and
  ``gradual_warmup_lr``;
* ``comm_stats`` for the reference's ``_dp_stats`` configurations
  (lenet on mnist at world 8: tests/test_dp_shard.py,
  tests/test_comm_overlap.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.parallel import common as jc
from ddlbench_tpu.parallel.api import make_strategy as jax_make_strategy
from ddlbench_tpu.train.comm_stats import comm_stats as jax_comm_stats
from tiny_models import tiny_dense_model, tiny_transformer
from torch_dp_ranks import build_model

from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.distributed import Comm
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.ops import threefry
from ddlbench_tpu_torch.parallel import common as pc
from ddlbench_tpu_torch.parallel.dp import DPStrategy
from ddlbench_tpu_torch.train.comm_stats import comm_stats

pytestmark = pytest.mark.torchport


def _bn_model():
    from ddlbench_tpu.models.layers import (LayerModel, conv_bn, dense,
                                            flatten, global_avg_pool)

    return LayerModel("tinybn", [conv_bn("c1", 4), global_avg_pool(),
                                 flatten(), dense("fc", 4)], (4, 4, 1), 4)


TINY = {"dense": tiny_dense_model, "bn": _bn_model,
        "transformer_t": tiny_transformer}


def _abstract(jm):
    return jax.eval_shape(lambda k: init_model(jm, k)[0], jax.random.key(0))


def _jax_meta(abs_params, world, buckets):
    groups = [len(jax.tree.leaves(p)) for p in abs_params]
    return jc.flat_meta(abs_params, world, buckets=buckets,
                        leaf_groups=groups)


def _same_meta(ours, theirs):
    assert ours.shapes == theirs.shapes
    assert ours.sizes == theirs.sizes
    assert (ours.length, ours.padded) == (theirs.length, theirs.padded)
    assert ours.bucket_leaves == theirs.bucket_leaves
    assert ours.bucket_padded == theirs.bucket_padded
    assert ours.bucket_offsets == theirs.bucket_offsets


@pytest.fixture(scope="module")
def big_shapes():
    """(reference abstract params, port model) of transformer_s on
    synthtext and resnet50 on imagenet."""
    return {name: (_abstract(jax_get_model(name, bench)),
                   get_model(name, bench))
            for name, bench in (("transformer_s", "synthtext"),
                                ("resnet50", "imagenet"))}


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("buckets", [1, 3, 8])
def test_flat_meta_matches_jax(big_shapes, world, buckets):
    """The layer-aligned layout of the port's models equals the
    reference's: leaf order and shapes, bucket bounds, pads, offsets."""
    pairs = [(_abstract(TINY[n]()), build_model(n)) for n in TINY]
    for abs_params, model in pairs + list(big_shapes.values()):
        ours, _ = pc.model_flat_meta(model, world, buckets)
        _same_meta(ours, _jax_meta(abs_params, world, buckets))


def test_bucket_bounds_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        sizes = [int(s) for s in rng.integers(0, 50, rng.integers(1, 12))]
        for buckets in (1, 2, 3, 5, 16):
            assert pc._bucket_bounds(sizes, buckets) == \
                jc._bucket_bounds(sizes, buckets)


@pytest.fixture(scope="module")
def bn_pair():
    jm = _bn_model()
    params, _, _ = init_model(jm, jax.random.key(3))
    tm = from_jax_params(build_model("bn"), jax.device_get(params))
    return params, tm


@pytest.mark.parametrize("buckets", [1, 3])
def test_pack_flat_matches_jax_bitwise(bn_pair, buckets):
    """The port's packed vector of the same weights is the reference's,
    element for element (the convolution kernel raveled as HWIO)."""
    params, tm = bn_pair
    ours, leaves = pc.model_flat_meta(tm, 4, buckets)
    theirs = _jax_meta(params, 4, buckets)
    got = pc.pack_flat(leaves, ours).detach().numpy()
    want = np.asarray(jc.pack_flat(params, theirs))
    np.testing.assert_array_equal(got, want)
    back = pc.unpack_flat(torch.from_numpy(want.copy()), ours)
    for p, t in zip(leaves, back):
        assert torch.equal(p.detach(), t)


def test_device_major_round_trip_matches_jax(bn_pair):
    params, tm = bn_pair
    for world, buckets in ((2, 1), (4, 3), (8, 2)):
        ours, _ = pc.model_flat_meta(tm, world, buckets)
        theirs = _jax_meta(params, world, buckets)
        flat = np.arange(ours.padded, dtype=np.float32)
        dm = pc.to_device_major(torch.from_numpy(flat), ours, world)
        np.testing.assert_array_equal(
            dm.numpy(), np.asarray(jc.to_device_major(jnp.asarray(flat),
                                                      theirs, world)))
        np.testing.assert_array_equal(
            pc.from_device_major(dm, ours, world).numpy(), flat)
        perm, inv = pc.device_major_perm(ours, world)
        jperm, jinv = jc.device_major_perm(theirs, world)
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(inv, jinv)
        assert pc.bucket_content_lengths(ours) == \
            jc.bucket_content_lengths(theirs)
        shard = dm[:ours.padded // world]
        for b in range(ours.num_buckets):
            np.testing.assert_array_equal(
                pc.shard_bucket_slice(shard, ours, world, b).numpy(),
                np.asarray(jc.shard_bucket_slice(jnp.asarray(shard.numpy()),
                                                 theirs, world, b)))


def test_sum_safe_qmax_matches_jax():
    for world in (1, 2, 3, 4, 8, 127):
        assert pc.sum_safe_qmax(world) == jc.sum_safe_qmax(world)
    with pytest.raises(ValueError, match="127"):
        pc.sum_safe_qmax(128)


@pytest.mark.parametrize("world,qstep,rank,k,b", [(2, 0, 1, 0, 0),
                                                  (4, 7, 3, 1, 2),
                                                  (8, 123, 5, 0, 1)])
def test_int8_quantize_under_the_dp_key_matches_jax(world, qstep, rank, k,
                                                    b):
    """The dp engine's stochastic-rounding key (tag 0x1A8, the step
    counter, the rank, the micro-step, the bucket) and the quantised
    bucket equal the reference's bit for bit, with the shared absmax."""
    seed = 11
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.key(seed), 0x1A8), qstep), rank)
    jkey = jax.random.fold_in(jax.random.fold_in(jkey, k), b)
    tkey = threefry.fold_in(threefry.fold_in(threefry.fold_in(
        threefry.prng_key(seed), 0x1A8), qstep), rank)
    tkey = threefry.fold_in(threefry.fold_in(tkey, k), b)
    g = (np.random.default_rng(world).normal(size=4099) * 1e-3).astype(
        np.float32)
    absmax = np.float32(np.abs(g).max() * 1.5)  # another rank's larger max
    qmax = jc.sum_safe_qmax(world)
    jq, js = jc.quantize_int8(jnp.asarray(g), jkey, qmax=qmax,
                              absmax=jnp.asarray(absmax))
    tq, ts = pc.quantize_int8(torch.from_numpy(g), tkey, qmax,
                              torch.tensor(absmax))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert int(tq.abs().max()) <= qmax
    jr = jc.stochastic_round_int8(jnp.asarray(g * 3e4), jkey, qmax=127)
    tr = pc.stochastic_round_int8(torch.from_numpy(g * 3e4), tkey, 127)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    zq, zs = pc.quantize_int8(torch.zeros(4), tkey)
    assert float(zs) == 1.0 and not zq.any()


def test_gradual_warmup_lr_matches_jax():
    for args in [(0.4, 4, 0, 0, 10, 2), (0.4, 4, 1, 9, 10, 2),
                 (0.4, 4, 2, 3, 10, 2), (0.1, 1, 0, 0, 5, 3),
                 (0.8, 8, 0, 4, 5, 1), (0.3, 2, 4, 0, 7, 5)]:
        assert pc.gradual_warmup_lr(*args) == jc.gradual_warmup_lr(*args)


DP_STATS = [dict(), dict(dp_shard_update=True), dict(allreduce_dtype="bf16"),
            dict(allreduce_dtype="bf16", dp_shard_update=True),
            dict(allreduce_dtype="int8"),
            dict(allreduce_dtype="int8", dp_shard_update=True),
            dict(dp_shard_update=True, comm_buckets=4),
            dict(comm_buckets=4)]


@pytest.mark.parametrize("kw", DP_STATS)
def test_comm_stats_match_jax(kw, devices):
    base = dict(benchmark="mnist", strategy="dp", num_devices=8,
                compute_dtype="float32", batch_size=2, steps_per_epoch=2,
                momentum=0.5, weight_decay=1e-4, arch="lenet", **kw)
    jcfg = JaxRunConfig(**base)
    jcfg.validate()
    theirs = jax_comm_stats(jax_make_strategy(jcfg))
    cfg = RunConfig(**base)
    cfg.validate()
    ours = comm_stats(DPStrategy(get_model("lenet", "mnist"), cfg,
                                 Comm.describe(8)))
    assert set(ours) == set(theirs)
    for key, v in theirs.items():
        if isinstance(v, str):
            assert ours[key] == v, key
        else:
            assert ours[key] == pytest.approx(float(v), rel=1e-12), key


def test_comm_stats_single_is_zero():
    from ddlbench_tpu_torch.parallel.single import SingleStrategy

    cfg = RunConfig(benchmark="mnist", arch="lenet")
    cs = comm_stats(SingleStrategy(get_model("lenet", "mnist"), cfg))
    assert cs["total_bytes"] == 0.0 and cs["allreduce_bytes"] == 0.0
