"""The port's topology-portable reshard (ddlbench_tpu_torch/train/
reshard.py) held to the reference's (ddlbench_tpu/train/reshard.py).

* ``to_logical``, ``from_logical`` and ``reshard_flat`` equal the
  reference's bit for bit over a grid of worlds (1, 2, 4), buckets (1, 3)
  and the device-major layout on and off at either end, on the tiny
  transformer's leaf-aligned dp metas and on pipeline row metas;
* ``compare`` on the reference's own table of named errors
  (tests/test_elastic.py::test_compare_raises_named_errors);
* ``logical.json``: the port's ``logical_meta`` of single, dp replicated,
  dp ZeRO-1 at one bucket, the overlapped engine at three and hybrid
  gpipe ZeRO-1's rows equals the reference's ``logical_meta`` of the same
  configuration (its strategy built on the CPU) in every field
  ``compare`` and the loop read, and the ``leaves`` for single and dp.
  The dp and hybrid strategies run on the dp tests' gloo rank pool
  (tests/torch_dp_ranks.py; cases in tests/torch_ckpt_ranks.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import itertools

import jax
import numpy as np
import pytest

import ddlbench_tpu.config as jconfig
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.parallel import common as jc
from ddlbench_tpu.parallel.api import make_strategy as jax_make_strategy
from ddlbench_tpu.train import reshard as jrs
from tiny_models import TINY_LM
from torch_dp_ranks import RankPool

import torch_ckpt_ranks
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.parallel import common as pc
from ddlbench_tpu_torch.train import reshard as trs

pytestmark = pytest.mark.torchport

GRID = [(w, b) for w in (1, 2, 4) for b in (1, 3)]


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(autouse=True)
def tinylm(monkeypatch):
    monkeypatch.setitem(jconfig.DATASETS, "tinylm", TINY_LM)


def _metas(world, buckets):
    model = build_transformer("transformer_t", (32,), 64)
    return pc.model_flat_meta(model, world, buckets)[0]


def _jax_metas(world, buckets):
    import tiny_models

    from ddlbench_tpu.models.layers import init_model

    jm = tiny_models.tiny_transformer()
    abs_params = jax.eval_shape(lambda k: init_model(jm, k)[0],
                                jax.random.key(0))
    groups = [len(jax.tree.leaves(p)) for p in abs_params]
    return jc.flat_meta(abs_params, world, buckets=buckets,
                        leaf_groups=groups)


@pytest.mark.parametrize("kind", ["dp", "row"])
@pytest.mark.parametrize("src,dst", list(itertools.product(GRID, GRID)))
@pytest.mark.parametrize("dm", [(False, False), (True, True),
                                (True, False), (False, True)])
def test_reshard_flat_matches_the_reference_bitwise(kind, src, dst, dm):
    (ws, bs), (wd, bd) = src, dst
    if kind == "dp":
        ours = (_metas(ws, bs), _metas(wd, bd))
        theirs = (_jax_metas(ws, bs), _jax_metas(wd, bd))
    else:
        ours = (pc.row_flat_meta(1001, ws, bs), pc.row_flat_meta(1001, wd, bd))
        theirs = (jc.row_flat_meta(1001, ws, bs),
                  jc.row_flat_meta(1001, wd, bd))
    rng = np.random.default_rng(ws * 10 + bs)
    logical = rng.standard_normal(ours[0].length).astype(np.float32)
    flat = trs.from_logical(logical, ours[0])
    assert np.array_equal(flat, jrs.from_logical(logical, theirs[0]))
    assert np.array_equal(trs.to_logical(flat, ours[0]),
                          jrs.to_logical(flat, theirs[0]))
    assert np.array_equal(trs.to_logical(flat, ours[0]), logical)
    rows = np.stack([flat, 2 * flat])
    got = trs.reshard_flat(rows, ours[0], ws, ours[1], wd, *dm)
    want = jrs.reshard_flat(rows, theirs[0], ws, theirs[1], wd, *dm)
    assert got.shape == want.shape and np.array_equal(got, want)
    back = trs.reshard_flat(got, ours[1], wd, ours[0], ws, dm[1], dm[0])
    assert np.array_equal(back, rows)


def test_compare_raises_the_references_named_errors(capsys):
    """The reference's table (tests/test_elastic.py), on the port's
    compare."""
    base = {"schema": trs.LOGICAL_SCHEMA, "strategy": "dp",
            "kind": "dp_shard", "world": 4, "dp": 4, "buckets": 1,
            "overlap": False, "length": 100, "padded": 100,
            "bucket_padded": [100], "global_batch": 8, "lr_world": 4}
    cur = dict(base, world=2, dp=2, padded=102, bucket_padded=[102])
    with pytest.raises(trs.CheckpointShapeError, match="elastic-resume"):
        trs.compare(base, cur, elastic=False)
    assert trs.compare(base, cur, elastic=True) == "reshard"
    assert trs.compare(base, dict(base), elastic=False) is None
    assert trs.compare(None, cur, elastic=False) is None
    with pytest.raises(trs.CheckpointShapeError, match="engine layout"):
        trs.compare(dict(base, kind="replicated"), cur, elastic=True)
    with pytest.raises(trs.CheckpointShapeError, match="strategy"):
        trs.compare(dict(base, strategy="gpipe"), cur, elastic=True)
    with pytest.raises(trs.CheckpointShapeError, match="MODEL"):
        trs.compare(dict(base, length=64), cur, elastic=True)
    pn = dict(base, kind="pipe_shard", stages=4, vstages=1, dp=2)
    pm = dict(pn, stages=2)
    with pytest.raises(trs.CheckpointShapeError, match="auto-partition"):
        trs.compare(pn, pm, elastic=True)
    with pytest.raises(trs.CheckpointShapeError, match="schema"):
        trs.compare(dict(base, schema=2), cur, elastic=True)
    # the replicated catch-all: equal leaves restore with a note, others
    # raise naming the missing reshard path
    rep = dict(base, kind="replicated", leaves=[{"shape": [2]}])
    assert trs.compare(rep, dict(rep, world=2), elastic=False) is None
    assert "world changed 4 -> 2" in capsys.readouterr().out
    with pytest.raises(trs.CheckpointShapeError, match="no reshard path"):
        trs.compare(rep, dict(rep, world=2, leaves=[{"shape": [3]}]),
                    elastic=True)
    # every message of the port is the reference's (what compare raises)
    for saved, current in ((dict(base, kind="replicated"), cur),
                           (pn, pm), (dict(base, length=64), cur)):
        with pytest.raises(trs.CheckpointShapeError) as ours:
            trs.compare(saved, current, elastic=True)
        with pytest.raises(jrs.CheckpointShapeError) as theirs:
            jrs.compare(saved, current, elastic=True)
        assert str(ours.value) == str(theirs.value)


# the configurations whose logical.json is held to the reference's, and
# whether its leaves are too
LOGICAL = {
    "single": (dict(strategy="single"), True),
    "single_adam": (dict(strategy="single", optimizer="adam"), True),
    "dp_replicated": (dict(strategy="dp", num_devices=2), True),
    "dp_zero1": (dict(strategy="dp", num_devices=2, dp_shard_update=True,
                      optimizer="adam"), True),
    "dp_overlap_k3": (dict(strategy="dp", num_devices=2,
                           dp_shard_update=True, comm_buckets=3), True),
    "hybrid_zero1": (dict(strategy="gpipe", num_devices=4, dp_replicas=2,
                          dp_shard_update=True, comm_buckets=2,
                          micro_batch_size=2, num_microbatches=2,
                          batch_size=None), False),
}


@pytest.mark.parametrize("name", sorted(LOGICAL))
def test_logical_meta_matches_the_reference(pool, name):
    kw, leaves = LOGICAL[name]
    kw = {**dict(benchmark="tinylm", arch="transformer_t",
                 compute_dtype="float32", batch_size=4), **kw}
    jcfg = JaxRunConfig(**kw)
    js = jax_make_strategy(jcfg)
    want = jrs.logical_meta(js, jcfg, js.init(jax.random.key(0)), 2)
    cfg = RunConfig(**kw)
    if cfg.spawned_ranks():
        got = pool.run("torch_ckpt_ranks:logical", cfg.spawned_ranks(),
                       cfg=kw)[0]
    else:
        got = torch_ckpt_ranks.logical(None, kw)
    assert set(got) == set(want)
    for key in want:
        if key != "leaves":
            assert got[key] == want[key], key
    if leaves:
        assert got["leaves"] == want["leaves"]
