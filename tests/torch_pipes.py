"""Shared pieces of the port's pipeline tests (tests/test_torch_gpipe.py,
test_torch_pipeline_rt.py, test_torch_pipedream.py): the tiny models in
both packages, a strategy pair started from the same weights, numpy
batches, and the comparisons of a step.

Models: "dense" (tests/tiny_models.py's tiny MLP, stateless: 4 layers on
(4, 4, 1)), "deep" (a 6-layer MLP on (4, 4, 1), for 4 stages and for 2
stages of 2 chunks), "bn" (a convolution with BatchNorm, a pool, a
flatten and a dense head: running statistics), "transformer_t"
(tests/tiny_models.py's, T 32, vocab 64, through the fused LM head) and
"moe" (its transformer_moe_t: a dense and a Switch MoE block, capacity
factor 8, so no token is dropped; the router's aux loss in the
objective).
The port's twin of each takes the reference's initial weights through
convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tiny_models
from ddlbench_tpu.config import DatasetSpec as JaxDatasetSpec
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.models import layers as JL
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.parallel.gpipe import GPipeStrategy as JaxGPipe
from ddlbench_tpu.parallel.pipedream import PipeDreamStrategy as JaxPD
from ddlbench_tpu.parallel.pipeline_rt import (
    ScheduledPipelineStrategy as JaxRT)

from ddlbench_tpu_torch.config import DatasetSpec, RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
from ddlbench_tpu_torch.models import layers as L
from ddlbench_tpu_torch.models.moe import build_transformer_moe
from ddlbench_tpu_torch.models.transformer import build_transformer
from ddlbench_tpu_torch.parallel.common import _key_part
from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy
from ddlbench_tpu_torch.parallel.pipeline_rt import ScheduledPipelineStrategy

CPU = torch.device("cpu")
TINY_LM = tiny_models.TINY_LM
# the 4x4x1 image benchmark of the dense and BatchNorm models
TINY_IMG = DatasetSpec("tinypipeimg", (4, 4, 1), 4, 64, 16)
TINY_IMG_JAX = JaxDatasetSpec("tinypipeimg", (4, 4, 1), 4, 64, 16)


def jax_model(name):
    if name == "dense":
        return tiny_models.tiny_dense_model()
    if name == "deep":
        return JL.LayerModel("tinydeep", [
            JL.flatten(), JL.dense("fc1", 12, relu=True),
            JL.dense("fc2", 12, relu=True), JL.dense("fc3", 12, relu=True),
            JL.dense("fc4", 12, relu=True), JL.dense("fc5", 4)],
            (4, 4, 1), 4)
    if name == "bn":
        return JL.LayerModel("tinybn", [
            JL.conv_bn("c1", 4), JL.conv_bn("c2", 4), JL.global_avg_pool(),
            JL.flatten(), JL.dense("fc", 4)], (4, 4, 1), 4)
    if name == "transformer_t":
        return tiny_models.tiny_transformer()
    if name == "moe":
        return tiny_models.tiny_moe()
    raise ValueError(name)


def port_model(name):
    gen = torch.Generator().manual_seed(0)
    if name == "dense":
        return L.LayerModel("tinydense", [
            L.Flatten("flatten", (4, 4, 1)),
            L.Dense("fc1", (16,), 9, relu=True, gen=gen),
            L.Dense("fc2", (9,), 8, relu=True, gen=gen),
            L.Dense("fc3", (8,), 4, gen=gen)], (4, 4, 1), 4)
    if name == "deep":
        layers = [L.Flatten("flatten", (4, 4, 1))]
        fan = 16
        for i in range(1, 5):
            layers.append(L.Dense(f"fc{i}", (fan,), 12, relu=True, gen=gen))
            fan = 12
        layers.append(L.Dense("fc5", (12,), 4, gen=gen))
        return L.LayerModel("tinydeep", layers, (4, 4, 1), 4)
    if name == "bn":
        return L.LayerModel("tinybn", [
            L.ConvBN("c1", (4, 4, 1), 4, gen=gen),
            L.ConvBN("c2", (4, 4, 4), 4, gen=gen),
            L.GlobalAvgPool("gap", (4, 4, 4)),
            L.Flatten("flatten", (4,)),
            L.Dense("fc", (4,), 4, gen=gen)], (4, 4, 1), 4)
    if name == "transformer_t":
        return build_transformer("transformer_t", TINY_LM.image_size,
                                 TINY_LM.num_classes)
    if name == "moe":
        return build_transformer_moe(
            "transformer_moe_t", TINY_LM.image_size, TINY_LM.num_classes,
            capacity_factor=float(tiny_models.N_EXPERTS))
    raise ValueError(name)


TOKEN_MODELS = ("transformer_t", "moe")


def benchmark(name):
    return "tinylm" if name in TOKEN_MODELS else "tinypipeimg"


def config_kw(name, **kw):
    base = dict(benchmark=benchmark(name), compute_dtype="float32",
                attention_backend="xla", momentum=0.5, weight_decay=1e-4,
                label_smoothing=0.0)
    if name in TOKEN_MODELS:
        base.update(momentum=None, weight_decay=None)
    base.update(kw)
    return base


def datasets():
    """The {name: spec} entries both packages' configs must see."""
    return ({"tinylm": TINY_LM, "tinypipeimg": TINY_IMG_JAX},
            {"tinylm": DatasetSpec("tinylm", TINY_LM.image_size,
                                   TINY_LM.num_classes, 1000, 100,
                                   kind="tokens"),
             "tinypipeimg": TINY_IMG})


def batches(name, B, steps, seed=7):
    """``steps`` numpy (x, y) batches of B rows: NHWC images and labels,
    or token ids and next-token labels (some masked as -1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        if name in TOKEN_MODELS:
            seq = rng.integers(0, TINY_LM.num_classes,
                               (B, TINY_LM.seq_len + 1)).astype(np.int32)
            y = seq[:, 1:].copy()
            y[0, :3] = -1
            out.append((seq[:, :-1], y))
        else:
            x = rng.standard_normal((B, 4, 4, 1)).astype(np.float32)
            out.append((x, rng.integers(0, 4, B).astype(np.int32)))
    return out


def to_port(x):
    t = torch.from_numpy(np.array(x))
    if t.dim() == 4:
        t = t.permute(0, 3, 1, 2).contiguous()
    return t.long() if not t.is_floating_point() else t


JAX_CLS = {"gpipe": JaxGPipe, "rt": JaxRT, "pipedream": JaxPD}
PORT_CLS = {"gpipe": GPipeStrategy, "rt": ScheduledPipelineStrategy,
            "pipedream": PipeDreamStrategy}


class Pair:
    """The reference's strategy and the port's, same config and initial
    weights; ``step`` runs both on one numpy batch."""

    def __init__(self, name, engine, **kw):
        from unittest import mock

        import ddlbench_tpu.config as jconfig
        import ddlbench_tpu_torch.config as tconfig

        jsets, tsets = datasets()
        self._patches = [mock.patch.dict(jconfig.DATASETS, jsets),
                         mock.patch.dict(tconfig.DATASETS, tsets)]
        for p in self._patches:
            p.start()
        kw = config_kw(name, **kw)
        self.name = name
        jcfg = JaxRunConfig(**kw)
        jcfg.validate()
        cfg = RunConfig(**kw)
        cfg.validate()
        self.jstrat = JAX_CLS[engine](jax_model(name), jcfg)
        self.ts = self.jstrat.init(jax.random.key(0))
        params, states, _ = init_model(self.jstrat.model, jax.random.key(0))
        self.model = port_model(name)
        from_jax_params(self.model, jax.device_get(params))
        from_jax_state(self.model, jax.device_get(states))
        self.strat = PORT_CLS[engine](self.model, cfg,
                                      [CPU] * cfg.resolved_stages())
        self.strat.init()
        assert self.strat.bounds == list(self.jstrat.bounds)

    def close(self):
        for p in self._patches:
            p.stop()

    def step(self, x, y, lr):
        xs, ys = self.jstrat.shard_batch(jnp.asarray(x), jnp.asarray(y))
        self.ts, jm = self.jstrat.train_step(self.ts, xs, ys,
                                             jnp.float32(lr))
        pm = self.strat.train_step(to_port(x), to_port(y), lr)
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in pm.items()})

    def evaluate(self, x, y):
        xs, ys = self.jstrat.shard_batch(jnp.asarray(x), jnp.asarray(y))
        jm = self.jstrat.eval_step(self.ts, xs, ys)
        pm = self.strat.eval_step(to_port(x), to_port(y))
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in pm.items()})

    def params(self):
        """(reference's packed chunk rows, the port's), numpy."""
        return (np.asarray(self.ts.params),
                self.strat.materialize_params().numpy())

    def states(self):
        """(reference's packed state rows, the port's buffers packed the
        same way: per chunk, per layer, sorted by name), numpy."""
        theirs = np.asarray(self.ts.model_state)
        rows = []
        for c in range(self.strat.num_chunks):
            vals = []
            for layer in self.strat.chunk_layers(c):
                named = sorted(layer.named_buffers(),
                               key=lambda kv: tuple(map(_key_part,
                                                        kv[0].split("."))))
                vals += [b.detach().reshape(-1).numpy() for _, b in named]
            rows.append(np.concatenate(vals) if vals else np.zeros(0))
        ours = np.zeros(theirs.reshape(len(rows), -1).shape, np.float32)
        for c, r in enumerate(rows):
            ours[c, :r.size] = r
        return theirs.reshape(len(rows), -1), ours


def cli_pair(argv, tmp_path, capsys):
    """The reference's CLI (``--platform cpu``) and the port's
    (``--device cpu``) on ``argv`` over the tiny datasets, each writing
    its records to a JSONL file: ((their stdout lines, their records),
    (ours, ours))."""
    import json
    from unittest import mock

    import ddlbench_tpu.cli as jcli
    import ddlbench_tpu.config as jconfig
    import ddlbench_tpu.models.transformer as jtr
    import ddlbench_tpu_torch.config as tconfig
    from ddlbench_tpu_torch import cli

    jsets, tsets = datasets()
    out = []
    # the reference's CLI sets its process-wide attention backend
    # (--attention-backend): kept to this call, so the reference's own
    # tests that run later in the process see their default
    with mock.patch.dict(jconfig.DATASETS, jsets), \
            mock.patch.dict(tconfig.DATASETS, tsets), \
            mock.patch.object(jtr, "_ATTENTION_BACKEND", ["auto"]):
        for tag, main, extra in (("ref", jcli.main, ["--platform", "cpu"]),
                                 ("port", cli.main, ["--device", "cpu"])):
            path = tmp_path / f"{tag}.jsonl"
            capsys.readouterr()
            assert main(argv + extra + ["--jsonl", str(path)]) == 0
            lines = capsys.readouterr().out.splitlines()
            out.append((lines, [json.loads(r) for r in
                                path.read_text().splitlines()]))
    return tuple(out)


def comm_lines(lines):
    return [line for line in lines if line.startswith("comm volume/step")]
