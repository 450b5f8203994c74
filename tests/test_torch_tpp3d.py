"""3-D tpp (``-f gpipe --tp-size T --dp-replicas R``: parallel/tpp.py
``TPGPipeStrategy`` with a data group) held to the reference's
``TPGPipeStrategy`` on its ``('data', 'stage', 'model')`` mesh.

The reference runs R 2 x S 2 x T 2 on conftest's 8 host devices; the
port runs one gloo rank a shard of a replica (tests/torch_dp_ranks
.RankPool's 4 ranks, cases in tests/torch_tp_ranks.py), rank d * 2 + t
walking gpipe's fill-drain over its two stages. Both start from the
reference's initial packed matrices (convert.load_tpp_rows) and take the
same numpy global batches of M 2 x mb 2 x R 2 rows of the tiny LM (T 32,
vocab 64), float32, the plain attention, the unfused head, lr 0.05:

* each rank's gradient rows (its shard's sliced row and the replicated
  row of each stage, after the replicas' sum / R) against the
  reference's gradient of its loss: every row within 1e-5 relative L2;
* each step's loss (rtol 1e-5) and accuracy; two SGD steps, the rows
  after each within rtol 1e-4, atol 1e-6 (the hybrid's), and one Adam
  update, each row's change within 1e-4 relative L2 (the hybrid's bar
  on a change); the eval step's sums; the ranks' replicated rows equal, and a
  shard's sliced rows equal on both replicas (exactly);
* the batch layout: replica d's microbatch m is rows [m R mb + d mb,
  ...+ mb), on both of its shards;
* the 3-D step against the port's 2-D tpp (mb 4: the same microbatches,
  every label valid) on the same global batch: losses rtol 1e-5, rows
  rtol 1e-5, atol 1e-7;
* comm_stats against the reference's numbers, the stage devices of the
  mesh, and ``-f gpipe --tp-size 2 --dp-replicas 2 -g 8 --device cpu``
  through the CLI.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddlbench_tpu.config as jconfig
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from tiny_models import TINY_LM
from torch_dp_ranks import RankPool
import torch_tp_ranks  # noqa: F401  (registers "tinylm" in the port)

from ddlbench_tpu_torch.config import RunConfig

pytestmark = pytest.mark.torchport

BASE = dict(benchmark="tinylm", arch="transformer_t", strategy="gpipe",
            micro_batch_size=2, num_microbatches=2,
            compute_dtype="float32", fused_head_loss=False,
            steps_per_epoch=2, attention_backend="xla")
MESH = dict(num_devices=8, num_stages=2, tp_size=2, dp_replicas=2)
LR = 0.05
LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)
ADAM_DELTA_REL = 1e-4  # the hybrid's bar on a step's change of a row
GRAD_REL = 1e-5
VS_2D = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _batches(B, steps, seed=10, masked=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        seq = rng.integers(0, TINY_LM.num_classes,
                           (B, TINY_LM.seq_len + 1)).astype(np.int32)
        y = seq[:, 1:].copy()
        if masked:
            y[3, :5] = -1  # a masked stretch on replica 1's rows
        out.append((seq[:, :-1], y))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _reference(optimizer, batches, grad_batch=None, **kw):
    """The reference's 3-D tpp: its initial packed matrices, its gradient
    of the step's loss on ``grad_batch``, then each step's loss, accuracy
    and matrices, and the eval sums on the first batch."""
    from ddlbench_tpu.parallel.api import make_strategy

    import ddlbench_tpu.models.transformer as jtr

    # kept to this block, as in test_comm_volume_is_the_references
    with mock.patch.dict(jconfig.DATASETS, {"tinylm": TINY_LM}), \
            mock.patch.object(jtr, "_ATTENTION_BACKEND", ["auto"]):
        jcfg = JaxRunConfig(optimizer=optimizer, **{**BASE, **MESH, **kw})
        jcfg.validate()
        strat = make_strategy(jcfg)
        ts = strat.init(jax.random.key(0))
        out = {"p0": {k: np.asarray(v) for k, v in ts.params.items()},
               "bounds": list(strat.bounds), "losses": [], "accuracy": [],
               "params": []}
        if grad_batch is not None:
            pipe = strat._make_pipe_fn(train=True)
            xs, ys = strat.shard_batch(*grad_batch)
            state = ts.model_state

            def loss_fn(params):
                return pipe(params, state, xs, ys)[0]

            g = jax.jit(jax.grad(loss_fn))(ts.params)
            out["grads"] = {k: np.asarray(v) for k, v in g.items()}
        for x, y in batches:
            ts, m = strat.train_step(ts, *strat.shard_batch(x, y),
                                     jnp.float32(LR))
            out["losses"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append({k: np.asarray(v)
                                  for k, v in ts.params.items()})
        if batches:
            em = strat.eval_step(ts, *strat.shard_batch(*batches[0]))
            out["eval"] = {k: float(v) for k, v in em.items()}
    return out


def _port_cfg(**kw):
    return {k: v for k, v in {**BASE, **MESH, **kw}.items()
            if k != "strategy"}


def _hold_rows(got, want, t, **tol):
    """A rank's rows against the reference's matrices (its shard t's
    sliced rows), each row's unpadded length."""
    for c in range(want["repl"].shape[0]):
        n = got["sliced"].shape[1]
        np.testing.assert_allclose(got["sliced"][c],
                                   want["sliced"][c, t, :n], **tol)
        n = got["repl"].shape[1]
        np.testing.assert_allclose(got["repl"][c], want["repl"][c, :n],
                                   **tol)


def _hold_update(mine, ref, t):
    """Adam's one update, row by row: the change of each row within
    ADAM_DELTA_REL relative L2 of the reference's (Adam divides each
    element's step by its gradient's magnitude, so an element whose
    gradient is near 0 turns a last-bit gradient difference into a step
    difference of up to 2e-5 here; the rows' gradients are held to
    GRAD_REL above)."""
    for key in ("sliced", "repl"):
        got = mine["params"][0][key] - mine["p0"][key]
        want = ref["params"][0][key] - ref["p0"][key]
        for c in range(got.shape[0]):
            w = want[c, t] if key == "sliced" else want[c]
            assert _rel(got[c], w[:got.shape[1]]) <= ADAM_DELTA_REL, (
                key, c)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_tpp3d_matches_the_reference(ranks, optimizer):
    # Adam: one update (its second step divides by a second moment that
    # one step's rounding moves wherever a gradient is near zero)
    batches = _batches(8, 2 if optimizer == "sgd" else 1)
    ref = _reference(optimizer, batches, grad_batch=batches[0])
    got = ranks.run("torch_tp_ranks:tpp3d", 4,
                    cfg=_port_cfg(optimizer=optimizer), p0=ref["p0"],
                    batches=batches, lr=LR, grad_batch=batches[0])
    assert [(r["dp_rank"], r["tp_rank"]) for r in got] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in got:
        t = r["tp_rank"]
        assert r["bounds"] == ref["bounds"]
        _hold_rows(r["p0"], ref["p0"], t, rtol=0, atol=0)
        for key in ("sliced", "repl"):
            for c in range(r["grads"][key].shape[0]):
                n = r["grads"][key].shape[1]
                want = (ref["grads"][key][c, t, :n] if key == "sliced"
                        else ref["grads"][key][c, :n])
                assert _rel(r["grads"][key][c], want) <= GRAD_REL, (
                    r["rank"], key, c)
        np.testing.assert_allclose(r["losses"], ref["losses"], **LOSS)
        np.testing.assert_allclose(r["accuracy"], ref["accuracy"],
                                   atol=1e-6)
        if optimizer == "sgd":
            for mine, want in zip(r["params"], ref["params"]):
                _hold_rows(mine, want, t, **PARAM)
        else:
            _hold_update(r, ref, t)
        for k in ("correct", "correct5", "count"):
            assert r["eval"][k] == ref["eval"][k], k
        np.testing.assert_allclose(r["eval"]["loss"], ref["eval"]["loss"],
                                   **LOSS)
    # one model: the replicated rows on every rank, a shard's sliced rows
    # on both replicas, exactly
    for a in got[1:]:
        np.testing.assert_array_equal(a["params"][-1]["repl"],
                                      got[0]["params"][-1]["repl"])
    for t in (0, 1):
        np.testing.assert_array_equal(got[t]["params"][-1]["sliced"],
                                      got[2 + t]["params"][-1]["sliced"])
    if optimizer == "sgd":
        assert ref["losses"][0] != ref["losses"][-1]  # the steps moved


def test_batch_layout_interleaves_the_replicas(ranks):
    """Replica d's microbatch m is rows [m*R*mb + d*mb, ...+ mb) of the
    global batch on both of its shards, labels alike (the reference's
    [M, R*mb] reshape with its second axis sharded over 'data')."""
    ref = _reference("sgd", [])
    got = ranks.run("torch_tp_ranks:tpp3d", 4, cfg=_port_cfg(),
                    p0=ref["p0"], batches=[], lr=LR, layout_rows=8)
    for r in got:
        d = r["dp_rank"]
        want = [[m * 4 + d * 2 + j for j in range(2)] for m in range(2)]
        assert r["layout"] == r["layout_labels"] == want, r["rank"]


def test_3d_step_equals_2d_tpp(ranks):
    """The 3-D step on a global batch with every label valid equals 2-D
    tpp's at micro-batch R x mb: the same microbatches, each replica's
    mean CE over its equal share of them averaged over the replicas."""
    batches = _batches(8, 2, seed=21, masked=False)
    ref = _reference("sgd", [])
    three = ranks.run("torch_tp_ranks:tpp3d", 4, cfg=_port_cfg(),
                      p0=ref["p0"], batches=batches, lr=LR)
    two = ranks.run("torch_tp_ranks:tpp3d", 2, cfg=_port_cfg(
        num_devices=4, dp_replicas=1, micro_batch_size=4), p0=ref["p0"],
        batches=batches, lr=LR)
    for r in three:
        w = two[r["tp_rank"]]
        np.testing.assert_allclose(r["losses"], w["losses"], **LOSS)
        for a, b in zip(r["params"], w["params"]):
            for key in ("sliced", "repl"):
                np.testing.assert_allclose(a[key], b[key], **VS_2D)
    assert three[0]["losses"][0] != three[0]["losses"][1]


class _FakeGroup:
    """A group of ``world`` ranks whose collectives run here (nothing is
    sent): comm_stats reads the strategy's layout only."""

    def __init__(self, world, rank=0):
        self.world, self.rank = world, rank

    def broadcast(self, t, src=0):
        return t


def test_comm_volume_is_the_references():
    """The loop's comm volume line: each replica's boundaries, the sliced
    rows' all-reduce over the replicas (one a shard) and the replicated
    rows' over replicas x shards, and one row-parallel sum's payload, as
    the reference counts them."""
    from ddlbench_tpu.parallel.api import make_strategy as jax_make
    from ddlbench_tpu.train.comm_stats import comm_stats as jax_comm_stats

    from ddlbench_tpu_torch.parallel.tpp import TPGPipeStrategy
    from ddlbench_tpu_torch.train.comm_stats import comm_line, comm_stats

    import ddlbench_tpu.models.transformer as jtr

    # make_strategy sets the reference's process-wide attention backend:
    # kept to this block, so the reference's own tests see their default
    with mock.patch.dict(jconfig.DATASETS, {"tinylm": TINY_LM}), \
            mock.patch.object(jtr, "_ATTENTION_BACKEND", ["auto"]):
        jstrat = jax_make(JaxRunConfig(**{**BASE, **MESH}))
        jstrat.init(jax.random.key(0))
        want = jax_comm_stats(jstrat)
    s = TPGPipeStrategy(_port_model(), RunConfig(**{**BASE, **MESH}),
                        [torch.device("cpu")] * 2, _FakeGroup(2),
                        dp_comm=_FakeGroup(2))
    got = comm_stats(s)
    for k in ("boundary_bytes", "allreduce_bytes", "reduce_scatter_bytes",
              "all_gather_bytes", "total_bytes", "tp_psum_payload_bytes",
              "tp_grad_sliced_row_bytes", "tp_grad_repl_row_bytes"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["allreduce_bytes"] > 0 and got["boundary_bytes"] > 0
    assert comm_line(got).startswith("comm volume/step: ")


def _port_model():
    from ddlbench_tpu_torch.models.transformer import build_transformer

    return build_transformer("transformer_t", (32,), 64)


def test_stage_devices_follow_the_mesh():
    """Replica d's stage s, shard t on cuda:(d*S*T + s*T + t): data outer,
    model inner; a rank's group on its first stage's card; too few cards
    raise naming the count; a shared card puts everything on cuda:0."""
    from ddlbench_tpu_torch import distributed as D

    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=8):
        for rank in range(4):
            d, t = divmod(rank, 2)
            devs = D.tpp3d_stage_devices("cuda", 2, 2, 2, rank)
            assert [x.index for x in devs] == [d * 4 + s * 2 + t
                                               for s in range(2)]
            assert D.rank_device("cuda", rank, 4, stride=2,
                                 tp=2).index == devs[0].index
        assert {x.index for x in D.tpp3d_stage_devices(
            "cuda", 2, 2, 2, 3, shared_card=True)} == {0}
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=4):
        with pytest.raises(RuntimeError, match="need 8 CUDA device"):
            D.tpp3d_stage_devices("cuda", 2, 2, 2, 0)
    assert D.tpp3d_stage_devices("cpu", 2, 2, 2, 3) == [
        torch.device("cpu")] * 2


def test_cli_3d_end_to_end(capfd, monkeypatch):
    from ddlbench_tpu_torch import cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["-f", "gpipe", "--tp-size", "2", "--dp-replicas", "2", "-g",
            "8", "-b", "synthtext", "-m", "transformer_t", "-e", "1",
            "--steps-per-epoch", "1", "--micro-batch-size", "1",
            "--num-microbatches", "2", "--dtype", "float32", "--device",
            "cpu"]
    assert cli.main(argv) == 0
    cap = capfd.readouterr()
    out, err = cap.out.splitlines(), cap.err
    assert err.count("tpp: fused projection+loss head is not supported "
                     "under tp_size > 1; using the unfused CE head") == 1
    assert sum(line.startswith("schedule advisor") for line in out) == 2
    assert sum(line.startswith("train | 1/1 epoch") for line in out) == 1
    comm = [line for line in out if line.startswith("comm volume/step")]
    assert len(comm) == 1 and "allreduce 0.00 MB" not in comm[0]
    result = json.loads(out[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])
