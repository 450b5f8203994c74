"""The port's pipeline schedules and stage splits held to the reference's.

* every timetable (partition/schedule.py ``make_timetable``, the searched
  one included) equals the reference's bitwise over a grid of
  (schedule, S, M, V): its events, microbatches, chunks, deferred W
  events, and the engine arrays and bubble fraction derived from it;
* ``balanced_stage_bounds`` over ``layer_flop_costs`` equals the
  reference's split, and the cost vector equals the reference's to
  float64 round-off, on every chain arch of the zoo (the branchy ones
  are refused under a pipeline), at 2, 4 and 8 chunks;
* the analytic bubble fractions and the advisor's tables are equal.

The reference's split reads its ``init_model`` shapes and parameter
sizes (traced with ``jax.eval_shape``: no weights are drawn); the port's,
the layers' recorded shapes (or one batch-1 forward) and the modules'
parameters (parallel/packing.py).
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import numpy as np
import pytest

import ddlbench_tpu.partition.schedule as jsched
import tiny_models  # noqa: F401  (the reference's transformer_moe_t)
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.parallel.packing import (
    balanced_stage_bounds as jax_bounds, layer_flop_costs as jax_costs)

import ddlbench_tpu_torch.partition.schedule as sched
from ddlbench_tpu_torch.config import DatasetSpec
from ddlbench_tpu_torch.models import zoo
from ddlbench_tpu_torch.models.branchy import BRANCHY_ARCHS
from ddlbench_tpu_torch.parallel.packing import (balanced_stage_bounds,
                                                 layer_flop_costs,
                                                 model_shapes)

pytestmark = pytest.mark.torchport

GRID = [(name, S, M, V)
        for name in sched.PIPE_SCHEDULES
        for S, M, V in ((2, 4, 1), (4, 4, 1), (2, 4, 2), (4, 8, 2),
                        (3, 6, 1))
        if not (V > 1 and M % S)]


@pytest.mark.parametrize("name,S,M,V", GRID)
def test_timetables_equal_the_reference(name, S, M, V):
    ours = sched.make_timetable(name, S, M, V)
    theirs = jsched.make_timetable(name, S, M, V)
    for field in ("events", "mbs", "chunks"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (ours.name, ours.deferred_w, ours.costs) == (
        theirs.name, theirs.deferred_w, theirs.costs)
    assert ours.bubble_fraction() == theirs.bubble_fraction()
    ea, eb = ours.engine_arrays(), theirs.engine_arrays()
    assert ea.keys() == eb.keys()
    for k in ea:
        assert np.array_equal(np.asarray(ea[k]), np.asarray(eb[k])), k
    if name == "fill-drain":
        for a, b in zip(ours.forward_tick_arrays(),
                        theirs.forward_tick_arrays()):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("budget,seed", [(32, 0), (64, 3)])
def test_searched_table_follows_budget_and_seed(budget, seed):
    ours = sched.make_timetable("searched", 4, 8, 1, search_budget=budget,
                                search_seed=seed)
    theirs = jsched.make_timetable("searched", 4, 8, 1,
                                   search_budget=budget, search_seed=seed)
    assert np.array_equal(ours.events, theirs.events)
    assert np.array_equal(ours.mbs, theirs.mbs)
    assert np.array_equal(ours.chunks, theirs.chunks)


@pytest.mark.parametrize("stash", [0, 2])
def test_zb_h2_stash_tables_equal(stash):
    ours = sched.make_timetable("zero-bubble-h2", 4, 8, 1, stash=stash)
    theirs = jsched.make_timetable("zero-bubble-h2", 4, 8, 1, stash=stash)
    assert np.array_equal(ours.events, theirs.events)
    assert ours.deferred_w == theirs.deferred_w
    assert ours.steady_period() == theirs.steady_period()


@pytest.mark.parametrize("S,M,V", [(2, 4, 1), (4, 8, 1), (4, 8, 2),
                                   (8, 16, 1), (4, 6, 1)])
def test_bubbles_and_advisor_equal(S, M, V):
    for name in sched.PIPE_SCHEDULES:
        if V > 1 and M % S:
            continue
        assert sched.schedule_bubble_fraction(name, S, M, V) == \
            jsched.schedule_bubble_fraction(name, S, M, V)
        assert sched.bubble_is_estimate(name, S, M, V) == \
            jsched.bubble_is_estimate(name, S, M, V)
    assert sched.pipeline_bubble_fraction(S, M, V) == \
        jsched.pipeline_bubble_fraction(S, M, V)
    assert sched.recommend_schedule(S, M, V) == \
        jsched.recommend_schedule(S, M, V)
    assert sched.recommend_virtual_stages(S, M, 12) == \
        jsched.recommend_virtual_stages(S, M, 12)


# the chain arches of the zoo, each on a small dataset of its kind (the
# split reads the boundary shapes, so they are the ones both sides see)
SMALL = {"image": DatasetSpec("tinysplit", (32, 32, 3), 10, 64, 16),
         "tokens": DatasetSpec("tinysplittok", (16,), 64, 64, 16,
                               kind="tokens"),
         "seq2seq": DatasetSpec("tinysplitmt", (16,), 64, 64, 16,
                                kind="seq2seq", src_len=8)}
CHAIN_ARCHS = [a for a in zoo.MODEL_NAMES if a not in BRANCHY_ARCHS]


def _kind(arch):
    if arch.startswith("seq2seq"):
        return "seq2seq"
    return "image" if (arch in zoo.IMAGE_ARCHS
                       or arch in zoo.EXTRA_ARCHS) else "tokens"


@pytest.mark.parametrize("arch", CHAIN_ARCHS)
def test_default_split_equals_the_reference(arch):
    spec = SMALL[_kind(arch)]
    if spec.kind == "image" and arch == "lenet":
        spec = DatasetSpec("tinysplit28", (28, 28, 1), 10, 64, 16)
    ours_model = zoo.get_model(arch, spec)
    from ddlbench_tpu.config import DatasetSpec as JaxSpec

    jspec = JaxSpec(spec.name, spec.image_size, spec.num_classes,
                    spec.train_size, spec.test_size, kind=spec.kind,
                    src_len=spec.src_len)
    jm = jax_get_model(arch, jspec)
    box = {}

    def init(key):  # shapes only: no weights are drawn
        params, _, box["shapes"] = init_model(jm, key)
        return params

    params = jax.eval_shape(init, jax.random.key(0))
    shapes = box["shapes"]
    theirs = jax_costs(params, shapes, jm.layers)
    ours = layer_flop_costs(ours_model, model_shapes(ours_model))
    assert [tuple(s) for s in model_shapes(ours_model)] == \
        [tuple(s) for s in shapes]
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)
    for chunks in (2, 4, 8):
        assert balanced_stage_bounds(ours, chunks) == \
            jax_bounds(theirs, chunks), chunks
