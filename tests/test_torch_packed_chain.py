"""The branchy arches under a manual pipeline: the node-granular packed
chain (models/branchy.py ``to_packed_chain``, parallel/api.py) held to
the reference's (``ddlbench_tpu/models/branchy.py``) on the CPU.

* inception and nasnet on cifar10 at full width: the packed chain's
  span names, each cut's crossing ids (sorted, -1 for the input), each
  span's output size (the packed boundary's, or the last node's shape),
  the FLOP costs the balanced split reads (the spans' stated geometry,
  parallel/packing.py) and the balanced bounds at 2, 3 and 4 stages
  equal the reference's;
* inception_t and nasnet_t on an 8x8x3 image benchmark: one float32
  gpipe step at 2 stages (mb 2 x 2 microbatches) through make_strategy
  on both sides from the reference's weights: the loss (rtol 1e-5),
  every packed chunk row (rtol 1e-4, atol 1e-6) and BatchNorm's state
  rows (rtol 1e-4, atol 1e-6), then the eval step's sums.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu.config import DatasetSpec as JaxDatasetSpec
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models import branchy as jb
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.api import make_strategy as jax_make_strategy
from ddlbench_tpu.parallel.packing import (
    balanced_stage_bounds as jax_bounds, layer_flop_costs as jax_costs)

from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
from ddlbench_tpu_torch.models import branchy
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.parallel.common import _key_part
from ddlbench_tpu_torch.parallel.packing import (balanced_stage_bounds,
                                                 layer_flop_costs,
                                                 model_shapes)

pytestmark = pytest.mark.torchport

CIFAR = ((32, 32, 3), 10)
TINY = ("tinybranchy", (8, 8, 3), 4)


def _abstract(init, model):
    """``init(model, key)``'s (params, states, shapes) traced without
    computing: the leaves as shapes (jax.eval_shape), the per-layer
    output shapes as the trace's Python values."""
    box = {}

    def run(key):
        params, states, shapes = init(model, key)
        box["shapes"] = shapes
        return params, states

    params, states = jax.eval_shape(run, jax.random.key(0))
    return params, states, box["shapes"]


@pytest.fixture(scope="module")
def chains():
    out = {}
    for arch in ("inception", "nasnet"):
        jdag = jb.get_dag(arch, *CIFAR)
        n = len(jdag.layers)
        jchain = jb.to_packed_chain(jdag, range(1, n),
                                    _abstract(jb.init_dag, jdag)[2])
        dag = branchy.get_dag(arch, *CIFAR)
        out[arch] = (jdag, jchain, _abstract(init_model, jchain), dag,
                     branchy.to_packed_chain(dag, range(1, n)))
    return out


@pytest.mark.parametrize("arch", ["inception", "nasnet"])
def test_packed_chain_spans_equal_the_references(chains, arch):
    jdag, jchain, (_, _, jshapes), dag, chain = chains[arch]
    n = len(dag.layers)
    assert len(jdag.layers) == n and len(chain.layers) == n
    assert chain.name == jchain.name
    assert [layer.name for layer in chain.layers] == \
        [layer.name for layer in jchain.layers]
    for p in range(1, n):
        assert branchy.crossing_ids(dag, p) == jb.crossing_ids(jdag, p)
    assert any(len(branchy.crossing_ids(dag, p)) > 1 for p in range(1, n))
    shapes = model_shapes(chain)
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]


@pytest.mark.parametrize("arch", ["inception", "nasnet"])
def test_packed_chain_split_equals_the_references(chains, arch):
    _, jchain, (jparams, _, jshapes), _, chain = chains[arch]
    want = jax_costs(jparams, jshapes, jchain.layers)
    got = layer_flop_costs(chain, model_shapes(chain))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for S in (2, 3, 4):
        assert balanced_stage_bounds(got, S) == jax_bounds(want, S)
    # the articulation chain would split elsewhere
    coarse = branchy.to_chain(branchy.get_dag(arch, *CIFAR))
    assert len(coarse.layers) < len(chain.layers)


def _state_rows(strat):
    rows = []
    for c in range(strat.num_chunks):
        vals = []
        for layer in strat.chunk_layers(c):
            named = sorted(layer.named_buffers(),
                           key=lambda kv: tuple(map(_key_part,
                                                    kv[0].split("."))))
            vals += [b.detach().reshape(-1).numpy() for _, b in named]
        rows.append(np.concatenate(vals) if vals else np.zeros(0))
    L = max(r.size for r in rows)
    return np.stack([np.pad(r, (0, L - r.size)) for r in rows])


@pytest.fixture
def tiny_benchmark():
    name, shape, classes = TINY
    with mock.patch.dict(jconfig.DATASETS, {name: JaxDatasetSpec(
            name, shape, classes, 64, 16)}), \
            mock.patch.dict(tconfig.DATASETS, {name: DatasetSpec(
                name, shape, classes, 64, 16)}):
        yield


@pytest.mark.parametrize("arch", ["inception_t", "nasnet_t"])
def test_packed_chain_gpipe_step_matches_the_reference(arch, capsys,
                                                       tiny_benchmark):
    name, shape, classes = TINY
    kw = dict(benchmark=name, arch=arch, strategy="gpipe", num_devices=2,
              micro_batch_size=2, num_microbatches=2,
              compute_dtype="float32", momentum=0.5, weight_decay=1e-4)
    jstrat = jax_make_strategy(JaxRunConfig(**kw))
    strat = make_strategy(RunConfig(**kw), torch.device("cpu"))
    out = capsys.readouterr().out
    # once from each package
    assert out.count("branchy arch: node-granular packed chain") == 2
    ts = jstrat.init(jax.random.key(0))
    assert strat.bounds == list(jstrat.bounds)
    params, states, _ = init_model(jstrat.model, jax.random.key(0))
    from_jax_params(strat.model, jax.device_get(params))
    from_jax_state(strat.model, jax.device_get(states))
    strat.init()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, *shape)).astype(np.float32)
    y = rng.integers(0, classes, 4).astype(np.int32)
    ts, jm = jstrat.train_step(ts, *jstrat.shard_batch(x, y),
                               jnp.float32(0.05))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    pm = strat.train_step(xt, torch.from_numpy(y).long(), 0.05)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(strat.materialize_params().numpy(),
                               np.asarray(ts.params), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_state_rows(strat),
                               np.asarray(ts.model_state)[
                                   :, :_state_rows(strat).shape[1]],
                               rtol=1e-4, atol=1e-6)
    jm = jstrat.eval_step(ts, *jstrat.shard_batch(x, y))
    pm = strat.eval_step(xt, torch.from_numpy(y).long())
    for k in ("correct", "correct5", "count"):
        assert int(pm[k]) == int(jm[k]), k
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
