"""The port's PipeDream (parallel/pipedream.py) held to the reference's
``PipeDreamStrategy`` and to its tests' sequential replay,
``tests/test_pipedream.py::simulate_pipedream``, on the CPU.

Three steps of async 1F1B with weight stashing from the same weights
(convert.py) and numpy batches: each step's loss and accuracy and every
updated parameter (the packed chunk rows), then the eval step (gpipe's
fill-drain), on the stateless MLPs at S 2 and 4 (M 4), with
``update_interval`` 2 (the macrobatch), at V 2 (4 chunks on 2 stages),
on the BatchNorm model (running statistics), on the tiny transformer
through the fused LM head (S 2 and S 1) and on the tiny MoE LM. The
replay runs plain
per-microbatch SGD, so its comparison takes momentum and weight decay 0
and chains its steps; at V 2 it runs the C = S*V chunk schedule, which
is what the interleaved layout executes.

Tolerance (float32): losses rtol 1e-5, parameters and statistics rtol
1e-4 and atol 1e-6, as tests/test_torch_gpipe.py.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

import torch_pipes as tp
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.pipedream import bwd_mb_at as jax_bwd_mb_at
from ddlbench_tpu.parallel.pipedream import fwd_mb_at as jax_fwd_mb_at
from test_pipedream import simulate_pipedream

from ddlbench_tpu_torch.parallel.pipedream import bwd_mb_at, fwd_mb_at

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)
STEPS = 3

CASES = {
    "dense-S2": ("dense", dict(num_devices=2)),
    "deep-S4": ("deep", dict(num_devices=4)),
    "deep-S2-K2": ("deep", dict(num_devices=2, update_interval=2)),
    "deep-S2V2": ("deep", dict(num_devices=2, virtual_stages=2)),
    "bn-S2": ("bn", dict(num_devices=2)),
    "transformer-S2": ("transformer_t", dict(num_devices=2)),
    "moe-S2": ("moe", dict(num_devices=2)),
    "transformer-S1": ("transformer_t", dict(num_devices=1)),
}


def _pair(case, **extra):
    name, kw = CASES[case]
    mb, M = (1 if name in tp.TOKEN_MODELS else 2), 4
    pair = tp.Pair(name, "pipedream", strategy="pipedream",
                   micro_batch_size=mb, num_microbatches=M,
                   batch_size=mb * M, **kw, **extra)
    return pair, name, mb * M


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipedream_matches_the_reference(case):
    pair, name, B = _pair(case)
    try:
        data = tp.batches(name, B, STEPS + 1)
        for x, y in data[:STEPS]:
            jm, pm = pair.step(x, y, 0.05)
            np.testing.assert_allclose(pm["loss"], jm["loss"], **LOSS)
            assert pm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-7)
            theirs, ours = pair.params()
            np.testing.assert_allclose(ours, theirs, **PARAM)
            theirs, ours = pair.states()
            np.testing.assert_allclose(ours, theirs, **PARAM)
        je, pe = pair.evaluate(*data[STEPS])
        assert (pe["count"], pe["correct"], pe["correct5"]) == \
            (je["count"], je["correct"], je["correct5"])
        np.testing.assert_allclose(pe["loss"], je["loss"], **LOSS)
    finally:
        pair.close()


@pytest.mark.parametrize("case", ["dense-S2", "deep-S4", "deep-S2-K2",
                                  "deep-S2V2"])
def test_pipedream_matches_the_replay(case):
    """Chained steps of the reference tests' replay (per-microbatch SGD,
    weight stashing, the macrobatch) equal the port's, chunk by chunk."""
    pair, name, B = _pair(case, momentum=0.0, weight_decay=0.0)
    try:
        strat = pair.strat
        params_list, states_list, _ = init_model(pair.jstrat.model,
                                                 jax.random.key(0))
        C = strat.num_chunks
        for x, y in tp.batches(name, B, STEPS):
            xs = jnp.asarray(x).reshape(strat.num_microbatches, strat.mb,
                                        *x.shape[1:])
            ys = jnp.asarray(y).reshape(strat.num_microbatches, strat.mb)
            cur, loss = simulate_pipedream(
                pair.jstrat.model, strat.bounds, params_list, states_list,
                xs, ys, 0.05, momentum_c=0.0,
                update_interval=strat.cfg.update_interval)
            params_list = [p for s in range(C) for p in cur[s]]
            pm = strat.train_step(tp.to_port(x), tp.to_port(y), 0.05)
            np.testing.assert_allclose(float(pm["loss"]), loss, **LOSS)
            ours = strat.materialize_params().reshape(C, -1).numpy()
            for c in range(C):
                want = np.asarray(ravel_pytree(cur[c])[0])
                np.testing.assert_allclose(ours[c, :want.size], want,
                                           **PARAM)
    finally:
        pair.close()


@pytest.mark.parametrize("S,M", [(1, 4), (2, 4), (4, 6), (8, 3)])
def test_timetable_functions_equal_the_reference(S, M):
    for s in range(S):
        for h in range(2 * M + 2 * S + 2):
            f, vf = jax_fwd_mb_at(s, S, M, jnp.asarray(h))
            b, vb = jax_bwd_mb_at(s, S, M, jnp.asarray(h))
            assert fwd_mb_at(s, S, M, h) == (int(f), bool(vf))
            assert bwd_mb_at(s, S, M, h) == (int(b), bool(vb))


def test_cli_pipedream_records_and_comm_line_match_the_reference(
        tmp_path, capsys):
    """-f pipedream -g 2 on transformer_t (T 32, vocab 64), the global
    batch 8 in microbatches of 2: the port's records have the reference's
    kinds and keys, and its comm volume line is the reference's."""
    argv = ["-f", "pipedream", "-g", "2", "-b", "tinylm", "-m",
            "transformer_t", "-e", "1", "--steps-per-epoch", "2", "-p", "1",
            "--batch-size", "8", "--micro-batch-size", "2", "--dtype",
            "float32", "--attention-backend", "xla"]
    (jl, jr), (pl, pr) = tp.cli_pair(argv, tmp_path, capsys)
    assert tp.comm_lines(pl) == tp.comm_lines(jl) and len(tp.comm_lines(pl))
    assert [r["kind"] for r in pr] == [r["kind"] for r in jr]
    for a, b in zip(pr, jr):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
