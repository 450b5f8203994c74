"""The port's GPipe (parallel/gpipe.py) held to the reference's
``GPipeStrategy`` on the CPU.

From the same initial weights (convert.py) and numpy batches, two steps
of the fill-drain pipeline: the loss and accuracy of each step, every
updated parameter (the packed chunk rows, parallel/gpipe.py
``materialize_params``), BatchNorm's running statistics and the eval
step's sums, on the stateless MLPs at S 2 and 4 (M 4), the interleaved
layout (S 2, V 2), the BatchNorm model, the tiny transformer through
the fused LM head (at S 2, and at S 1: one chunk, first and last) and
the tiny MoE LM (its router's aux loss in the objective);
``remat_stages`` on and off give equal results on the
port; ``plan_bounds`` sets the split (and names its error); and the
refusals of what the port does not carry name their ROADMAP items.

Tolerance (float32): losses rtol 1e-5; parameters and running statistics
rtol 1e-4, atol 1e-6 (as tests/test_torch_train.py: the same math in
another summation order; the reference sums the microbatches' gradients
in its scan's transposed order, the port in autograd's); eval sums: the
counts exactly, the loss rtol 1e-5.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
from unittest import mock

import numpy as np
import pytest
import torch

import torch_pipes as tp
from ddlbench_tpu.config import RunConfig as JaxRunConfig

import ddlbench_tpu_torch.config as tconfig
from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.distributed import stage_devices
from ddlbench_tpu_torch.parallel.api import make_strategy

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-6)

CASES = {
    "dense-S2": ("dense", dict(num_devices=2, micro_batch_size=2,
                               num_microbatches=4)),
    "deep-S4": ("deep", dict(num_devices=4, micro_batch_size=2,
                             num_microbatches=4)),
    "deep-S2V2": ("deep", dict(num_devices=2, virtual_stages=2,
                               micro_batch_size=2, num_microbatches=4)),
    "bn-S2": ("bn", dict(num_devices=2, micro_batch_size=4,
                         num_microbatches=4)),
    "transformer-S2": ("transformer_t", dict(num_devices=2,
                                             micro_batch_size=2,
                                             num_microbatches=4)),
    "transformer-S2V2-noremat": ("transformer_t", dict(
        num_devices=2, virtual_stages=2, micro_batch_size=1,
        num_microbatches=4, remat_stages=False)),
    "moe-S2": ("moe", dict(num_devices=2, micro_batch_size=2,
                           num_microbatches=4)),
    "transformer-S1": ("transformer_t", dict(num_devices=1,
                                             micro_batch_size=2,
                                             num_microbatches=4)),
}


def run_pair(case, steps=2, lr=0.05):
    name, kw = CASES[case]
    pair = tp.Pair(name, "gpipe", strategy="gpipe", **kw)
    try:
        B = kw["micro_batch_size"] * kw["num_microbatches"]
        data = tp.batches(name, B, steps + 1)
        for x, y in data[:steps]:
            jm, pm = pair.step(x, y, lr)
            np.testing.assert_allclose(pm["loss"], jm["loss"], **LOSS)
            assert pm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-7)
            theirs, ours = pair.params()
            np.testing.assert_allclose(ours, theirs, **PARAM)
            theirs, ours = pair.states()
            np.testing.assert_allclose(ours, theirs, **PARAM)
        je, pe = pair.evaluate(*data[steps])
        assert pe["count"] == je["count"] and pe["correct"] == je["correct"]
        assert pe["correct5"] == je["correct5"]
        np.testing.assert_allclose(pe["loss"], je["loss"], **LOSS)
        return pair
    finally:
        pair.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_matches_the_reference(case):
    pair = run_pair(case)
    if case.startswith("bn"):
        # the running statistics moved: one update per (chunk, microbatch)
        assert not torch.equal(pair.model.layers[0].bn.mean,
                               torch.zeros(4))


def _port_run(name, remat, steps=2):
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy

    _, tsets = tp.datasets()
    with mock.patch.dict(tconfig.DATASETS, tsets):
        cfg = RunConfig(**tp.config_kw(name, strategy="gpipe", num_devices=2,
                                       micro_batch_size=2,
                                       num_microbatches=4,
                                       remat_stages=remat))
        cfg.validate()
        torch.manual_seed(0)
        model = tp.port_model(name)
        strat = GPipeStrategy(model, cfg, [tp.CPU] * 2)
        strat.init()
        losses = []
        for x, y in tp.batches(name, 8, steps):
            losses.append(float(strat.train_step(tp.to_port(x),
                                                 tp.to_port(y), 0.05)
                                ["loss"]))
        return losses, strat.materialize_params(), [
            b.clone() for b in model.buffers()]


@pytest.mark.parametrize("name", ["bn", "transformer_t"])
def test_remat_on_and_off_agree(name):
    """remat_stages recomputes each (chunk, microbatch) from its stash
    with the running statistics frozen: the same losses, parameters and
    statistics as keeping the graphs (rtol 1e-6: only the order of the
    gradient sums differs)."""
    a = _port_run(name, True)
    b = _port_run(name, False)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-6,
                               atol=1e-7)
    for s, t in zip(a[2], b[2]):
        np.testing.assert_allclose(s.numpy(), t.numpy(), rtol=1e-6,
                                   atol=1e-7)


TINY_IMG = DatasetSpec("tinypipe32", (8, 8, 1), 10, 64, 16)


def _make(**kw):
    with mock.patch.dict(tconfig.DATASETS, {"tinypipe32": TINY_IMG}):
        cfg = RunConfig(benchmark="tinypipe32", arch="lenet",
                        strategy="gpipe", compute_dtype="float32",
                        micro_batch_size=2, num_microbatches=2, **kw)
        return make_strategy(cfg, torch.device("cpu"))


def test_plan_bounds_set_the_split_and_name_their_error(capsys):
    default = _make(num_devices=2)
    assert "schedule advisor (S=2, M=2)" in capsys.readouterr().out
    n = len(default.model.layers)
    planned = _make(num_devices=2, plan_bounds=(0, 1, n))
    assert planned.bounds == [0, 1, n] != default.bounds
    with pytest.raises(ValueError, match="must end at the model's layer "
                                         "count"):
        _make(num_devices=2, plan_bounds=(0, 1, n + 3))


# each knob the port keeps with the reference's default and refuses away
# from it, and the ROADMAP item the refusal names (dp_replicas,
# stage_replication and gpipe's dp_shard_update run since the hybrid
# pipelines: tests/test_torch_hybrid.py, test_torch_hetero.py). The
# A.7b rows were refused until 3-D tpp and remat_layers under fsdp and
# tp were ported (tests/test_torch_tpp3d.py,
# test_torch_remat_sharded.py): they now validate
LIFTED = ("A.7b",)
REFUSED = [
    (dict(tp_size=2, dp_replicas=2, num_devices=8, num_stages=2,
          benchmark="synthtext", arch="transformer_t"), "A.7b"),
    (dict(strategy="fsdp", remat_layers=True, benchmark="synthtext",
          arch="transformer_t"), "A.7b"),
    (dict(tp_size=2, dp_replicas=2, num_devices=8, benchmark="synthtext",
          arch="transformer_t"), "A.7b"),
    (dict(strategy="tp", remat_layers=True, benchmark="synthtext",
          arch="transformer_t"), "A.7b"),
    (dict(pipe_costs="profile"), "A.8"),
    (dict(pipe_cost_vectors=((1, 1), (1, 1), (1, 1)),
          pipe_schedule="1f1b"), "A.8"),
    (dict(schedule_trace="t.json"), "A.8"),
]


@pytest.mark.parametrize("kw,item", REFUSED)
def test_unported_pipeline_knobs_name_their_item(kw, item):
    base = dict(benchmark="mnist", strategy="gpipe", num_devices=2)
    base.update(kw)
    if item in LIFTED:
        RunConfig(**base).validate()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        RunConfig(**base).validate()


@pytest.mark.parametrize("arch", ["inception", "nasnet"])
def test_branchy_arches_are_refused_under_a_pipeline(arch):
    """Refused until the packed chain was ported; a manual pipeline now
    splits the arch's node-granular packed chain, every node a layer
    (tests/test_torch_packed_chain.py holds it to the reference)."""
    cfg = RunConfig(benchmark="cifar10", arch=arch, strategy="pipedream",
                    num_devices=2)
    s = make_strategy(cfg, torch.device("cpu"))
    assert s.model.name == f"{arch}_packed" and len(s.bounds) == 3
    assert all(len(list(layer.children())) == 1 for layer in s.model.layers)


@pytest.mark.parametrize("argv,item", [
    (["--dp-replicas", "2", "--tp-size", "2", "-g", "8", "--stages", "2"],
     "A.7b"),
    (["--tp-size", "2", "--dp-replicas", "4", "-g", "8"], "A.7b"),
    (["--tp-size", "2", "--dp-replicas", "2", "-g", "8"], "A.7b"),
    (["--pipe-costs", "profile"], "A.8"),
    (["--schedule-trace", "t.json"], "A.8")])
def test_cli_refuses_unported_pipeline_flags(argv, item):
    argv = ["-f", "gpipe", "-g", "2", "--device", "cpu"] + argv
    if item in LIFTED:  # 3-D tpp on a token benchmark: a rank a shard
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + ["-b", "synthtext", "-m", "transformer_t"]))
        cfg.validate()
        assert cfg.spawned_ranks() == cfg.dp_replicas * cfg.tp_size
        assert cfg.resolved_stages() * cfg.spawned_ranks() == 8
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(argv)


# the reference's gates, worded as the reference words them
GATES = [
    (dict(strategy="gpipe", num_devices=2, num_stages=4), "must equal"),
    (dict(strategy="gpipe", num_devices=2, update_interval=2),
     "PipeDream macrobatch"),
    (dict(strategy="pipedream", num_devices=2, pipe_schedule="1f1b"),
     "ASYNC"),
    (dict(strategy="gpipe", num_devices=2, virtual_stages=2,
          micro_batch_size=2, num_microbatches=3), "divisible by stages"),
    (dict(strategy="gpipe", num_devices=2, plan_bounds=(0, 3)),
     "entries"),
    (dict(strategy="gpipe", num_devices=2, plan_bounds=(0, 3, 3)),
     "strictly increase"),
    (dict(strategy="gpipe", num_devices=2, grad_accum_steps=2),
     "already micro-batch"),
    (dict(strategy="pipedream", num_devices=2, update_interval=3,
          batch_size=64, micro_batch_size=8), "divisible by"),
    (dict(strategy="gpipe", num_devices=2, pipe_schedule="bogus"),
     "unknown pipe_schedule"),
    (dict(strategy="gpipe", num_devices=2, benchmark="synthtext",
          arch="transformer_t", remat_layers=True), "one-apply"),
]


@pytest.mark.parametrize("kw,match", GATES)
def test_pipeline_gates_as_the_reference(kw, match):
    base = dict(benchmark="mnist")
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        JaxRunConfig(**base).validate()
    with pytest.raises(ValueError, match=match):
        RunConfig(**base).validate()


@pytest.mark.parametrize("kw", [
    dict(strategy="gpipe", num_devices=4),
    dict(strategy="gpipe", num_devices=2, batch_size=96),
    dict(strategy="gpipe", num_devices=2, micro_batch_size=8),
    dict(strategy="pipedream", num_devices=4),
    dict(strategy="pipedream", num_devices=2, batch_size=40),
    dict(strategy="pipedream", num_devices=4, benchmark="imagenet"),
    dict(strategy="gpipe", num_devices=4, benchmark="imagenet"),
    dict(strategy="gpipe", num_devices=4, benchmark="synthtext"),
])
def test_batches_and_stages_resolve_as_the_reference(kw):
    base = dict(benchmark="mnist")
    base.update(kw)
    theirs, ours = JaxRunConfig(**base), RunConfig(**base)
    assert ours.resolved_stages() == theirs.resolved_stages()
    assert ours.resolved_batches() == theirs.resolved_batches()
    assert ours.global_batch() == theirs.global_batch()


def test_stage_devices():
    cpu = torch.device("cpu")
    assert stage_devices("cpu", 3) == [cpu] * 3
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=2):
        assert stage_devices("cuda", 2) == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
        assert stage_devices("cuda", 4, shared_card=True) == \
            [torch.device("cuda", 0)] * 4
        with pytest.raises(RuntimeError, match="this machine has 2"):
            stage_devices("cuda", 4)
    with pytest.raises(ValueError, match="mode of the card"):
        stage_devices("cpu", 2, shared_card=True)


@pytest.mark.parametrize("schedule", ["fill-drain", "zero-bubble"])
def test_cli_gpipe_records_and_comm_line_match_the_reference(
        schedule, tmp_path, capsys):
    """-f gpipe -g 2 on transformer_t (T 32, vocab 64): the port's records
    have the reference's kinds and keys, its comm volume line is the
    reference's, and its summary's loss is finite."""
    argv = ["-f", "gpipe", "-g", "2", "-b", "tinylm", "-m", "transformer_t",
            "-e", "1", "--steps-per-epoch", "2", "-p", "1",
            "--micro-batch-size", "2", "--num-microbatches", "2",
            "--pipe-schedule", schedule, "--dtype", "float32",
            "--attention-backend", "xla"]
    (jl, jr), (pl, pr) = tp.cli_pair(argv, tmp_path, capsys)
    assert tp.comm_lines(pl) == tp.comm_lines(jl) and len(tp.comm_lines(pl))
    assert [r["kind"] for r in pr] == [r["kind"] for r in jr]
    for a, b in zip(pr, jr):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
    assert any(line.startswith("schedule advisor: best schedule at V=1")
               for line in pl)
    result = json.loads(pl[-1][len("result: "):])
    assert np.isfinite(result["valid_history"][0]["loss"])
