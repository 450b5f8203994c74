"""The port's image models, loop and tools against the JAX reference.

* Structure: every real model (resnet18/50/152, vgg11/16, mobilenetv2) on
  every image benchmark (mnist, cifar10, imagenet, highres) has the
  reference's layer names, per-layer output shapes, parameter and state
  names and shapes (in the port's layout) and parameter count. The
  reference's shapes come from ``jax.eval_shape`` over ``init_model`` and
  the port's model is built on the meta device, so nothing of full width
  is initialised or computed. VGG on mnist, whose map the reference takes
  to 0x0, is refused at build.
* The learning-rate schedules equal the reference's; the synthetic image
  batch has its shape, dtype, moments and per-(epoch, step) streams.
* The loop and the tools on the CPU at a tiny size: the CLI prints the
  reference's line schema and a ``result:`` line, the loop drives the
  step-decay schedule, tools/bench prints one JSON line with bench.py's
  record keys, both refuse the reference's flags they lack by name and
  raise without a card unless ``--device cpu`` is given, and every
  unported knob raises.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import json
import math
import re
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from ddlbench_tpu.cli import build_parser as jax_cli_parser
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.parallel.common import step_decay_lr as jax_step_decay

import ddlbench_tpu_torch.config as config
from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.data.synthetic import make_synthetic
from ddlbench_tpu_torch.models.zoo import IMAGE_ARCHS, get_model
from ddlbench_tpu_torch.parallel.api import make_strategy
from ddlbench_tpu_torch.parallel.common import step_decay_lr
from ddlbench_tpu_torch.tools import bench
from ddlbench_tpu_torch.train.loop import run_benchmark
from ddlbench_tpu_torch.train.metrics import AverageMeter

pytestmark = pytest.mark.torchport

IMAGE_BENCHMARKS = ("mnist", "cifar10", "imagenet", "highres")
CPU = torch.device("cpu")


def _port_shape(shape):
    """A reference leaf's shape in the port's layout (HWIO -> OIHW)."""
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 \
        else tuple(shape)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("benchmark", IMAGE_BENCHMARKS)
@pytest.mark.parametrize("arch", IMAGE_ARCHS)
def test_model_structure_matches_jax(arch, benchmark):
    jm = jax_get_model(arch, benchmark)
    traced = {}

    def init(key):
        params, states, shapes = init_model(jm, key)
        traced["shapes"] = shapes
        return params, states

    params, states = jax.eval_shape(init, jax.random.key(0))
    shapes = traced["shapes"]
    if arch.startswith("vgg") and benchmark == "mnist":
        assert tuple(shapes[-3]) == (0, 0, 512)  # pool5: the 0x0 map
        with pytest.raises(ValueError, match="0x0"):
            with torch.device("meta"):
                get_model(arch, benchmark)
        return
    with torch.device("meta"):
        tm = get_model(arch, benchmark)
    assert tm.in_shape == tuple(config.DATASETS[benchmark].image_size)
    assert len(tm.layers) == len(jm.layers)
    n_ref = 0
    for i, (layer, jlayer) in enumerate(zip(tm.layers, jm.layers)):
        assert layer.name == jlayer.name
        assert layer.out_shape == tuple(shapes[i + 1]), layer.name
        for own, tree in ((dict(layer.named_parameters()), params[i]),
                          (dict(layer.named_buffers()), states[i])):
            ref = {n: _port_shape(a.shape) for n, a in _flat(tree)}
            assert {n: tuple(t.shape) for n, t in own.items()} == ref, \
                layer.name
        n_ref += sum(math.prod(a.shape) for _, a in _flat(params[i]))
    assert sum(p.numel() for p in tm.parameters()) == n_ref


def test_resnet50_imagenet_is_torchvision_size():
    with torch.device("meta"):
        tm = get_model("resnet50", "imagenet")
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032


def test_unported_archs_raise():
    """Every arch of the reference's zoo is built now (the MoE and LSTM
    arches since their slice); an arch outside it raises."""
    for arch in ("transformer_moe_x", "seq2seq_lstm_x", "resnet99"):
        bench_name = ("synthtext" if arch.startswith("transformer")
                      else "synthmt" if arch.startswith("seq2seq")
                      else "cifar10")
        with pytest.raises(ValueError, match="unknown arch"):
            get_model(arch, bench_name)
    with pytest.raises(ValueError, match="image dataset"):
        get_model("resnet18", "synthtext")


def test_lr_schedules_match_jax():
    for epoch in range(0, 95):
        assert step_decay_lr(0.1, epoch, 30, 0.1) == pytest.approx(
            float(jax_step_decay(0.1, epoch, 30, 0.1)), rel=1e-12)
    assert step_decay_lr(0.1, 29, 30, 0.1) == 0.1
    assert step_decay_lr(0.1, 30, 30, 0.1) == pytest.approx(0.01)


def test_synthetic_images():
    spec = config.DATASETS["cifar10"]
    data = make_synthetic(spec, 64, CPU, steps_per_epoch=3)
    x, y = data.batch(0, 0)
    assert x.shape == (64, 3, 32, 32) and x.dtype == torch.float32
    assert y.shape == (64,) and y.dtype == torch.int64
    assert 0 <= int(y.min()) and int(y.max()) < spec.num_classes
    # uniform [0, 1) normalised by its mean and std: mean 0, std 1, and
    # the bounds (0 - 0.5) / 0.2887 and (1 - 0.5) / 0.2887
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    assert float(x.min()) >= -0.5 / 0.2887 and float(x.max()) < 0.5 / 0.2887
    x2, y2 = data.batch(0, 0)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(x, data.batch(0, 1)[0])
    assert not torch.equal(x, data.batch(1, 0)[0])
    assert not torch.equal(x, data.batch(0, 0, train=False)[0])
    assert data.steps_per_epoch() == 3


@pytest.fixture
def tinyimg():
    """A 16x16 image benchmark (the CLI and the tools read DATASETS)."""
    spec = DatasetSpec("tinyimg", (16, 16, 3), 10, 1000, 100)
    with mock.patch.dict(config.DATASETS, {"tinyimg": spec}), \
            mock.patch.dict(config.DEFAULT_BATCH["single"], {"tinyimg": 4}):
        yield spec


# the reference's line formats (ddlbench_tpu/train/metrics.py)
NUM = r"-?\d+\.\d+"
LINES = {
    "train": re.compile(rf"^train \| 1/1 epoch \(\d+%\) \| {NUM} samples/sec"
                        rf" \| loss {NUM} \| mem {NUM} GB in use, {NUM} GB "
                        r"peak$"),
    "epoch": re.compile(rf"^epoch 1/1 done \| {NUM} samples/sec \| {NUM} sec"
                        rf" \| input stall {NUM} ms \| step p50 {NUM} ms, "
                        rf"p95 {NUM} ms$"),
    "valid": re.compile(rf"^valid \| 1/1 epoch \| loss {NUM} \| accuracy "
                        rf"{NUM} \| top5 {NUM}$"),
    "summary": re.compile(rf"^valid accuracy: {NUM} \| {NUM} samples/sec, "
                          rf"{NUM} sec/epoch \(average\)$"),
}


def test_cli_prints_the_reference_schema(capsys, tinyimg, tmp_path):
    jsonl = tmp_path / "m.jsonl"
    assert cli.main(["-b", "tinyimg", "-m", "resnet18", "-e", "1",
                     "--steps-per-epoch", "3", "-p", "2", "--dtype",
                     "float32", "--jsonl", str(jsonl), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("run manifest: {")
    kinds = [k for line in out for k, rx in LINES.items() if rx.match(line)]
    assert kinds == ["train", "train", "epoch", "valid", "summary"], out
    assert out[-1].startswith("result: ")
    result = json.loads(out[-1][len("result: "):])
    assert {"valid_accuracy", "samples_per_sec", "sec_per_epoch",
            "valid_history", "step_time_p50_ms", "step_time_p95_ms",
            "warmup_compile_s", "input_stall_ms_per_epoch"} <= set(result)
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["train_interval",
                                            "train_interval", "epoch",
                                            "valid", "summary"]


def test_cli_covers_every_reference_flag():
    """Each of the reference CLI's flags is either the port's or refused
    by name."""
    theirs = {s for a in jax_cli_parser()._actions for s in a.option_strings}
    ours = {s for a in cli.build_parser()._actions for s in a.option_strings}
    assert theirs - {"--platform"} <= ours and "--platform" in ours
    assert "--device" in ours


# --auto-partition, --hbm-gb and --plan were refused here until the
# profile -> partition -> plan loop was ported (tests/test_torch_planner.py
# runs them), and --elastic-slices, --checkpoint-dir, --elastic-resume and
# --resume until checkpoints were (tests/test_torch_resume.py,
# test_torch_elastic.py); their rows now name flags the port still lacks
@pytest.mark.parametrize("argv", [["--hang-timeout-s", "60"],
                                  ["--audit", "a.json"],
                                  ["--inject", "kill@1:1"],
                                  ["--anomaly-policy", "skip"],
                                  ["--platform", "cpu"],
                                  ["--trace", "t.json"],
                                  ["--trace-dir", "d"],
                                  ["--loss-scale", "dynamic"]])
def test_cli_refuses_unported_flags_by_name(capsys, argv):
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device", "cpu"])
    assert f"{argv[0]} is not ported" in capsys.readouterr().err


# MoE under dp and fsdp and 3-D tpp were refused here until they were
# ported (tests/test_torch_moe_dp.py, test_torch_tpp3d.py); the same runs
# now meet a knob of ROADMAP A.8, which the port still refuses
# (--schedule-trace: --pipe-costs is ported since the planner was)
@pytest.mark.parametrize("argv", [["-f", "dp", "-g", "2", "-m",
                                   "transformer_moe_s", "-b", "synthtext",
                                   "--schedule-trace", "t.json"],
                                  ["-f", "fsdp", "-g", "2", "-m",
                                   "transformer_moe_s", "-b", "synthtext",
                                   "--schedule-trace", "t.json"],
                                  ["-f", "gpipe", "-g", "8", "--tp-size",
                                   "2", "--dp-replicas", "2", "-m",
                                   "transformer_t", "-b", "synthtext",
                                   "--schedule-trace", "t.json"]])
def test_cli_refuses_unported_runs(argv):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8"):
        cli.main(argv + ["--device", "cpu"])


def test_entry_points_need_the_card_unless_cpu_is_asked(tinyimg):
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["-b", "tinyimg", "-e", "1", "--steps-per-epoch", "1"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench.main(["--quick", "--benchmark", "tinyimg"])


def test_loop_steps_the_lr_down_and_restores_after_warmup(tinyimg):
    """Two epochs at lr_step_epochs 1: epoch 1 at the base lr, epoch 2 at
    a tenth of it; the warm-up steps run at the base lr on a copy of the
    state, so the first timed step starts from the initial weights."""
    cfg = RunConfig(benchmark="tinyimg", arch="resnet18", epochs=2,
                    steps_per_epoch=2, log_interval=1, lr=0.05,
                    lr_step_epochs=1, compute_dtype="float32")
    strategy = make_strategy(cfg, CPU)
    initial = {k: v.clone() for k, v in strategy.model.state_dict().items()}
    lrs, first = [], []
    step = strategy.train_step

    def recording_step(x, y, lr):
        if len(lrs) == 2:  # the first timed step, after 2 warm-up steps
            first.append(all(torch.equal(v, initial[k]) for k, v in
                             strategy.model.state_dict().items()))
        lrs.append(lr)
        return step(x, y, lr)

    strategy.train_step = recording_step
    result = run_benchmark(cfg, strategy, warmup_steps=2)
    assert lrs == pytest.approx([0.05, 0.05, 0.05, 0.05, 0.005, 0.005])
    assert first == [True]
    assert [h["epoch"] for h in result["valid_history"]] == [1, 2]
    assert all(math.isfinite(h["loss"]) for h in result["valid_history"])


# bench.py's record fields (bench.py:253-291), less the JAX backend
# provenance, which device.provenance() replaces
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "input_stall_ms_per_epoch", "step_time_p50_ms",
              "step_time_p95_ms", "stall_frac", "prefetch_depth", "strategy",
              "devices", "platform", "schema_version", "measured_at"}


def test_bench_quick_prints_the_reference_record(capsys, tinyimg):
    assert bench.main(["--quick", "--arch", "resnet18", "--benchmark",
                       "tinyimg", "--repeats", "1", "--dtype", "float32",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert BENCH_KEYS <= set(rec)
    assert rec["metric"] == "resnet18_tinyimg_images_per_sec_per_chip"
    assert rec["unit"] == "images/sec" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 200)
    assert rec["batch"] == 32 and rec["steps"] == 5 and rec["warmup"] == 2
    assert rec["step_time_p50_ms"] > 0 and 0 <= rec["stall_frac"] < 1
    assert rec["platform"] == "cpu" and rec["devices"] == 1


@pytest.mark.parametrize("argv", [["-g", "4"], ["--probe-timeout-s", "5"],
                                  ["--audit", "x"]])
def test_bench_refuses_unported_flags_by_name(capsys, argv):
    with pytest.raises(SystemExit):
        bench.main(argv + ["--device", "cpu"])
    assert f"{argv[0]} is not ported" in capsys.readouterr().err


# a value away from its default for each loop knob the port refuses;
# synthetic=False, refused on a token benchmark until on-disk token and
# text data were ported, now validates there
LOOP_KNOBS = {"synthetic": False, "plan": "auto", "auto_partition": True,
              "trace": "t.json", "trace_dir": "d", "audit": "a.json",
              "checkpoint_dir": "d", "resume": True,
              "checkpoint_every_steps": 5, "hang_timeout_s": 60.0,
              "inject": ("kill@1:1",), "activation_log_dir": "d",
              "warmup_epochs": 2, "elastic_slices": 2}
# knobs once refused here that now validate: synthetic=False on a token
# benchmark (on-disk token and text data), warmup_epochs (the dp
# strategy's gradual warmup), plan, auto_partition and
# activation_log_dir (the profile -> partition -> plan loop and the
# activation logger), and checkpoint_dir, resume, checkpoint_every_steps
# and elastic_slices (checkpoints and the elastic dp engine)
NOW_PORTED = {"synthetic": dict(benchmark="synthtext", arch="transformer_t"),
              "checkpoint_dir": dict(benchmark="cifar10", arch="resnet18"),
              "resume": dict(benchmark="cifar10", arch="resnet18",
                             checkpoint_dir="d"),
              "checkpoint_every_steps": dict(benchmark="cifar10",
                                             arch="resnet18",
                                             checkpoint_dir="d"),
              "elastic_slices": dict(benchmark="synthtext",
                                     arch="transformer_t", strategy="dp",
                                     num_devices=2, dp_shard_update=True),
              "warmup_epochs": dict(benchmark="cifar10", arch="resnet18",
                                    strategy="dp", num_devices=2),
              "plan": dict(benchmark="cifar10", arch="resnet18",
                           strategy="gpipe", num_devices=2),
              "auto_partition": dict(benchmark="cifar10", arch="resnet18",
                                     strategy="gpipe", num_devices=2),
              "activation_log_dir": dict(benchmark="cifar10",
                                         arch="resnet18")}


@pytest.mark.parametrize("name", sorted(LOOP_KNOBS))
def test_unported_loop_knobs_raise(name):
    assert set(LOOP_KNOBS) - set(NOW_PORTED) == {
        n for n, _, _ in config._TRAIN_NOT_PORTED}
    if name in NOW_PORTED:
        RunConfig(**NOW_PORTED[name],
                  **{name: LOOP_KNOBS[name]}).validate()
        return
    with pytest.raises(NotImplementedError, match=name):
        RunConfig(benchmark="cifar10", arch="resnet18",
                  **{name: LOOP_KNOBS[name]}).validate()


def test_real_data_knobs_validate_with_the_reference_defaults():
    """-s on an image benchmark, accumulation, the prefetch depth and
    augmentation validate, with the reference's defaults and global
    batch."""
    from ddlbench_tpu.config import RunConfig as JaxRunConfig

    cfg, jcfg = RunConfig(), JaxRunConfig()
    assert (cfg.synthetic, cfg.data_dir, cfg.augment, cfg.prefetch_depth,
            cfg.grad_accum_steps) == (
        jcfg.synthetic, jcfg.data_dir, jcfg.augment, jcfg.prefetch_depth,
        jcfg.grad_accum_steps)
    kw = dict(benchmark="cifar10", arch="resnet18", synthetic=False,
              data_dir="d", augment=False, prefetch_depth=0,
              grad_accum_steps=4, batch_size=8)
    RunConfig(**kw).validate()
    assert RunConfig(**kw).global_batch() == JaxRunConfig(
        **kw).global_batch() == 32
    with pytest.raises(ValueError, match="prefetch_depth"):
        RunConfig(prefetch_depth=-1).validate()
    args = cli.build_parser().parse_args(
        ["-b", "cifar10", "-s", "--data-dir", "d", "--no-augment",
         "--no-prefetch", "--grad-accum-steps", "2"])
    got = cli.config_from_args(args)
    assert (got.synthetic, got.data_dir, got.augment, got.prefetch_depth,
            got.grad_accum_steps) == (False, "d", False, 0, 2)
    args = cli.build_parser().parse_args(["--prefetch-depth", "3"])
    assert cli.config_from_args(args).prefetch_depth == 3


@pytest.mark.parametrize("depth", [0, 2])
def test_bench_records_its_prefetch_depth(capsys, tinyimg, depth):
    assert bench.main(["--quick", "--arch", "resnet18", "--benchmark",
                       "tinyimg", "--repeats", "1", "--dtype", "float32",
                       "--device", "cpu", "--prefetch-depth",
                       str(depth)]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["prefetch_depth"] == depth and rec["steps"] == 5
    assert rec["input_stall_ms_per_epoch"] >= 0 and rec["value"] > 0


def test_average_meter():
    m = AverageMeter("loss")
    m.update(2.0, n=3)
    m.update(4.0)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 10.0, 4, 2.5)
    m.reset()
    assert (m.val, m.sum, m.count, m.avg) == (0.0, 0.0, 0, 0.0)


def test_image_configs_validate_with_the_reference_resolvers():
    for benchmark in IMAGE_BENCHMARKS:
        cfg = RunConfig(benchmark=benchmark, arch="resnet50")
        cfg.validate()
        from ddlbench_tpu.config import RunConfig as JaxRunConfig

        jcfg = JaxRunConfig(benchmark=benchmark, arch="resnet50")
        assert (cfg.resolved_lr(), cfg.resolved_momentum(),
                cfg.resolved_weight_decay(), cfg.resolved_optimizer(),
                cfg.global_batch()) == (
            jcfg.resolved_lr(), jcfg.resolved_momentum(),
            jcfg.resolved_weight_decay(), jcfg.resolved_optimizer(),
            jcfg.global_batch())
    # per-layer remat of the BatchNorm models, refused until its
    # recompute kept the running statistics (tests/
    # test_torch_remat_sharded.py), validates as the reference's does
    for cls in (RunConfig, JaxRunConfig):
        cls(benchmark="imagenet", arch="resnet50",
            remat_layers=True).validate()
