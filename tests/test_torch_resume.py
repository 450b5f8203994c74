"""Save, lose the process, resume: the port's train loop
(ddlbench_tpu_torch/train/loop.py) through its checkpoints, bitwise.

* For every strategy family the port runs (single; dp's replicated
  engine, with shard_opt_state, ZeRO-1, the overlapped engine and the
  int8 wire; gpipe, pipedream and the event schedules; hybrid PP x DP
  and its ZeRO-1 rows; the hetero pipelines; tpp and 3-D tpp; sp, ep,
  fsdp and tp), on the tiny LM in float32: one epoch saved, then
  resumed for the second, equals two uninterrupted epochs bit for bit:
  the second epoch's per-step losses, the validation records and the
  whole checkpointed train state. The resumed run prints "resumed from D
  epoch 1" and validates the restored state before epoch 2's first
  training line. The strategies of ranks run on the dp tests' gloo rank
  pool (tests/torch_dp_ranks.py; cases in tests/torch_ckpt_ranks.py).
* A mid-epoch resume from a step checkpoint (its epoch checkpoint
  removed) is bitwise too.
* Single's checkpoint after an epoch's steps holds the reference's
  orbax checkpoint of the same run from the same converted weights, leaf
  for leaf in the reference's order and layout, within the single parity
  tests' tolerance (rtol 1e-4, atol 1e-6; tests/test_torch_train.py).
* The CLI on the CPU: ``-e 1 --checkpoint-dir D`` then ``-e 2
  --resume`` ends on the parameters of an uninterrupted two-epoch run,
  bit for bit; ``--resume`` on an empty directory starts fresh; a
  checkpoint that does not fit the strategy is an error.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle
from ddlbench_tpu.train import checkpoint as jck
from tiny_models import TINY_LM, tiny_transformer
from torch_dp_ranks import RankPool

import torch_ckpt_ranks as ck
from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.parallel.single import SingleStrategy
from ddlbench_tpu_torch.parallel.state import tree_leaves
from ddlbench_tpu_torch.train import checkpoint as tck

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-4, atol=1e-6)
PIPE = dict(micro_batch_size=2, num_microbatches=2, batch_size=None)

# (RunConfig kwargs, the pool's world; 0 = this process)
FAMILIES = {
    "single": (dict(), 0),
    "single_adam": (dict(optimizer="adam"), 0),
    "gpipe": (dict(strategy="gpipe", num_devices=2, **PIPE), 0),
    "gpipe_interleaved": (dict(strategy="gpipe", num_devices=2,
                               virtual_stages=2, pipe_schedule="interleaved",
                               **PIPE), 0),
    "pipeline_rt_1f1b": (dict(strategy="gpipe", num_devices=2,
                              pipe_schedule="1f1b", optimizer="adam",
                              **PIPE), 0),
    "pipedream": (dict(strategy="pipedream", num_devices=2,
                       micro_batch_size=2, num_microbatches=2), 0),
    "hetero_gpipe": (dict(strategy="gpipe", num_devices=3,
                          stage_replication=(1, 2), **PIPE), 0),
    "hetero_pipedream": (dict(strategy="pipedream", num_devices=3,
                              stage_replication=(2, 1),
                              micro_batch_size=2, num_microbatches=2), 0),
    "dp_replicated": (dict(strategy="dp", num_devices=2), 2),
    "dp_shard_opt_state": (dict(strategy="dp", num_devices=2,
                                shard_opt_state=True, optimizer="adam"), 2),
    "dp_zero1": (dict(strategy="dp", num_devices=4, dp_shard_update=True,
                      optimizer="adam"), 4),
    "dp_overlapped": (dict(strategy="dp", num_devices=2,
                           dp_shard_update=True, comm_buckets=3), 2),
    "dp_int8": (dict(strategy="dp", num_devices=2, allreduce_dtype="int8"),
                2),
    "hybrid": (dict(strategy="gpipe", num_devices=4, dp_replicas=2, **PIPE),
               2),
    "hybrid_zero1": (dict(strategy="gpipe", num_devices=4, dp_replicas=2,
                          dp_shard_update=True, comm_buckets=2,
                          optimizer="adam", **PIPE), 2),
    "tpp": (dict(strategy="gpipe", num_devices=4, tp_size=2, **PIPE), 2),
    "tpp3d": (dict(strategy="gpipe", num_devices=8, tp_size=2,
                   dp_replicas=2, **PIPE), 4),
    "sp": (dict(strategy="sp", num_devices=2), 2),
    "ep": (dict(strategy="ep", num_devices=2, arch="transformer_moe_t"), 2),
    "fsdp": (dict(strategy="fsdp", num_devices=2, optimizer="adam"), 2),
    "tp": (dict(strategy="tp", num_devices=2), 2),
}
MID_EPOCH = ("single", "pipedream", "hetero_gpipe", "dp_overlapped",
             "hybrid_zero1", "fsdp", "tpp3d")


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(autouse=True)
def tinylm(monkeypatch):
    from ddlbench_tpu_torch import config

    monkeypatch.setitem(config.DATASETS, "tinylm", ck.TINY)


def _run_case(pool, case, name, tmp_path, **kw):
    cfg, world = FAMILIES[name]
    cfg = ck.base(**cfg)
    if world:
        return pool.run(f"torch_ckpt_ranks:{case}", world, cfg=cfg,
                        ckpt_dir=str(tmp_path), **kw)[0]
    return getattr(ck, case)(None, cfg, str(tmp_path), **kw)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_resume_equals_the_uninterrupted_run(pool, tmp_path, name):
    got = _run_case(pool, "resume", name, tmp_path, every=3)
    assert got["losses"] and got["valid"] and got["params"], name
    text = got["text"]
    resumed = text.index(f"resumed from {tmp_path / 'run'} epoch 1\n")
    post_val = text.index("valid | 1/2 epoch", resumed)
    assert post_val < text.index("train | 2/2 epoch")


@pytest.mark.parametrize("name", MID_EPOCH)
def test_mid_epoch_resume_is_bitwise(pool, tmp_path, name):
    got = _run_case(pool, "mid_epoch", name, tmp_path)
    assert got["losses"] and got["valid"] and got["params"], name
    assert "epoch 1 step 1 (mid-epoch)" in got["text"]
    # the epoch's own validation comes at its end, not at the resume
    assert got["text"].index("train | 1/2 epoch (75%)") < \
        got["text"].index("valid | 1/2 epoch")


STEPS = 3
LR = {"sgd": 0.01, "adam": 1e-3}


def _batch(step):
    rng = np.random.default_rng(step)
    seq = rng.integers(0, TINY_LM.num_classes, (2, TINY_LM.seq_len + 1))
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_single_checkpoint_holds_the_references_orbax_one(tmp_path,
                                                          optimizer):
    """The same steps from the same weights on both packages, each saved
    through its own protocol: the port's train_state.pt and the
    reference's orbax state, leaf by leaf in the reference's order."""
    jm = tiny_transformer()
    params, _, _ = init_model(jm, jax.random.key(0))
    jcfg = JaxRunConfig(benchmark="synthtext", arch="transformer_t",
                        compute_dtype="float32", attention_backend="xla",
                        optimizer=optimizer)
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(0))
    model = build_transformer("transformer_t", TINY_LM.image_size,
                              TINY_LM.num_classes)
    from_jax_params(model, jax.device_get(params))
    ps = SingleStrategy(model, RunConfig(arch="transformer_t",
                                         compute_dtype="float32",
                                         attention_backend="xla",
                                         optimizer=optimizer))
    ps.init()
    for step in range(STEPS):
        x, y = _batch(step)
        ts, _ = js.train_step(ts, jnp.asarray(x), jnp.asarray(y),
                              jnp.float32(LR[optimizer]))
        ps.train_step(torch.from_numpy(x).long(), torch.from_numpy(y).long(),
                      LR[optimizer])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, 1, ts, global_step=STEPS)
    tck.save_checkpoint(tdir, 1, ps.checkpoint_state(), global_step=STEPS)
    _, want = jck.restore_checkpoint(jdir, ts)
    info = tck.latest_valid(tdir)
    got = tree_leaves(tck.load_state(info.path))
    want = jax.tree.leaves(want)
    assert len(got) == len(want) == (50 if optimizer == "sgd" else 76)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).endswith(
            str(w.dtype))
        if w.dtype == np.int32:
            assert int(g) == int(w) == STEPS
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    # each package reads the other's commit as valid
    assert jck.latest_valid(tdir).path == info.path
    assert tck.latest_valid(jdir).epoch == 1


def _cli(argv, tmp):
    return cli.main(["-b", "synthtext", "-m", "transformer_t", "-f",
                     "single", "--steps-per-epoch", "2", "-p", "1",
                     "--dtype", "float32", "--batch-size", "1",
                     "--device", "cpu"] + argv)


def test_cli_resume_ends_on_the_uninterrupted_parameters(tmp_path, capsys):
    d, straight = str(tmp_path / "d"), str(tmp_path / "straight")
    assert _cli(["-e", "1", "--checkpoint-dir", d], tmp_path) == 0
    capsys.readouterr()
    assert _cli(["-e", "2", "--checkpoint-dir", d, "--resume"],
                tmp_path) == 0
    out = capsys.readouterr().out
    resumed = out.index(f"resumed from {d} epoch 1\n")
    assert resumed < out.index("valid | 1/2 epoch") < \
        out.index("train | 2/2 epoch")
    assert _cli(["-e", "2", "--checkpoint-dir", straight], tmp_path) == 0
    got = tree_leaves(tck.load_state(os.path.join(d, "epoch_2")))
    want = tree_leaves(tck.load_state(os.path.join(straight, "epoch_2")))
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def test_resume_with_no_checkpoint_starts_fresh(tmp_path, capsys):
    d = str(tmp_path / "empty")
    assert _cli(["-e", "2", "--checkpoint-dir", d, "--resume",
                 "--checkpoint-every-steps", "1", "--keep-checkpoints", "1"],
                tmp_path) == 0
    out = capsys.readouterr().out
    assert f"resume: no valid checkpoint under {d}; starting fresh" in out
    # keep 1 beside the pin (the commit before, the run's resume target),
    # as the reference's retention: each commit ages out the one before
    # its predecessor
    dropped = [ln for ln in out.splitlines()
               if ln.startswith("checkpoint: retention dropped")]
    assert dropped == ["checkpoint: retention dropped epoch_1_step_0",
                       "checkpoint: retention dropped epoch_1"]
    assert sorted(os.listdir(d)) == ["epoch_2", "epoch_2_step_0"]


def test_a_checkpoint_that_does_not_fit_is_an_error(tmp_path):
    """A payload of another model's shapes is refused, naming the leaf,
    never loaded in part or replaced by fresh weights."""
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.parallel.state import check_payload

    cfg = RunConfig(**ck.base())
    s = make_strategy(cfg, torch.device("cpu"))
    state = s.checkpoint_state()
    bad = dict(state, params=[t[..., :1] if t.dim() else t
                              for t in state["params"]])
    with pytest.raises(ValueError, match="checkpoint payload at /params"):
        check_payload(bad, state)
    with pytest.raises(ValueError, match="keys"):
        check_payload(dict(state, opt={}), state)
    with pytest.raises(ValueError, match="checkpoint tensor of shape"):
        s.load_checkpoint_state(bad)


@pytest.mark.parametrize("depth", [0, 2])
def test_a_stream_starts_at_an_interior_step(tmp_path, depth):
    """The mid-epoch resume's data (data/prefetch.py ``start_step``): a
    random-access source jumps to the step, a sequential on-disk store is
    fast-forwarded, and either serves what the uninterrupted epoch serves
    from that step on."""
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.data import ondisk
    from ddlbench_tpu_torch.data.prefetch import Prefetcher
    from ddlbench_tpu_torch.data.synthetic import make_synthetic

    cpu = torch.device("cpu")
    synth = make_synthetic(ck.TINY, 2, cpu, seed=1, steps_per_epoch=4)
    full = list(Prefetcher(synth, depth=depth).stream(2))
    tail = list(Prefetcher(synth, depth=depth).stream(2, start_step=3))
    assert len(tail) == 1 and all(torch.equal(a, b) for a, b in
                                  zip(tail[0], full[3]))
    with pytest.raises(ValueError, match="outside epoch"):
        Prefetcher(synth, depth=depth).stream(2, start_step=5)

    def store():
        return ondisk.OnDiskData(str(tmp_path), DATASETS["cifar10"], 2, cpu,
                                 train_count=8, test_count=2, augment=False)

    a, b = store(), store()
    try:
        assert a.stateful_stream and a.steps_per_epoch() == 4
        full = list(Prefetcher(a, depth=depth).stream(1))
        tail = list(Prefetcher(b, depth=depth).stream(1, start_step=2))
        assert len(tail) == 2
        for got, want in zip(tail, full[2:]):
            assert all(torch.equal(x, y) for x, y in zip(got, want))
    finally:
        a.close()
        b.close()
