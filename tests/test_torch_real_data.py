"""Real data end to end on the CPU: scikit-learn's handwritten digits as
MNIST IDX (data/digits.py), imported into the native store and trained.

* lenet from the reference's weights, both packages reading the same
  digits store through their own OnDiskData (mnist: no augmentation):
  each of 30 float32 SGD steps' losses within 1e-4 relative of the
  reference's, and the eval accuracy over the test split afterwards
  equal.
* The port's CLI, ``-b mnist -m lenet -s --data-dir <digits> -e 3
  --device cpu`` with the reference accuracy test's float32, lr 0.1 and
  batch 32 (tests/test_accuracy_parity.py), reaches a validation accuracy
  of at least 0.8 and prints the reference's lines, at prefetch depth 2
  and with ``--no-prefetch``.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlbench_tpu.config import DATASETS as JAX_DATASETS
from ddlbench_tpu.config import RunConfig as JaxRunConfig
from ddlbench_tpu.data.ondisk import OnDiskData as JaxOnDisk
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.parallel.single import SingleStrategy as JaxSingle

from ddlbench_tpu_torch import cli
from ddlbench_tpu_torch.config import DATASETS, RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
from ddlbench_tpu_torch.data.digits import export_digits_idx
from ddlbench_tpu_torch.data.ondisk import OnDiskData
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.parallel.single import SingleStrategy

pytestmark = pytest.mark.torchport

B, STEPS, LR = 32, 30, 0.1
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    return export_digits_idx(str(tmp_path_factory.mktemp("digits")))


def test_lenet_on_digits_matches_jax_step_for_step(digits, tmp_path):
    import shutil

    # each package imports the IDX files into a store of its own
    roots = [str(tmp_path / n) for n in ("j", "t")]
    for r in roots:
        shutil.copytree(digits, r)
    jcfg = JaxRunConfig(benchmark="mnist", arch="lenet", batch_size=B,
                        lr=LR, compute_dtype="float32")
    cfg = RunConfig(benchmark="mnist", arch="lenet", batch_size=B, lr=LR,
                    compute_dtype="float32")
    jm = jax_get_model("lenet", "mnist")
    js = JaxSingle(jm, jcfg)
    ts = js.init(jax.random.key(0))
    tm = get_model("lenet", "mnist")
    from_jax_params(tm, jax.device_get(ts.params))
    from_jax_state(tm, jax.device_get(ts.model_state))
    ps = SingleStrategy(tm, cfg)
    ps.init()
    jd = JaxOnDisk(roots[0], JAX_DATASETS["mnist"], B, seed=1)
    td = OnDiskData(roots[1], DATASETS["mnist"], B, torch.device("cpu"),
                    seed=1)
    try:
        steps = td.steps_per_epoch()
        assert steps == jd.steps_per_epoch() == 1497 // B
        losses = []
        for i in range(STEPS):
            epoch, step = 1 + i // steps, i % steps
            ts, jmet = js.train_step(ts, *jd.batch(epoch, step),
                                     jnp.float32(LR))
            m = ps.train_step(*td.batch(epoch, step), LR)
            losses.append((m["loss"].item(), float(jmet["loss"])))
        for i, (got, want) in enumerate(losses):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (i, losses)
        assert losses[-1][1] < 0.5 * losses[0][1]  # it learns
        correct = {"j": 0, "t": 0}
        for step in range(td.steps_per_epoch(train=False)):
            jx, jy = jd.batch(1, step, train=False)
            tx, ty = td.batch(1, step, train=False)
            assert np.array_equal(np.asarray(jy), ty.numpy())
            correct["j"] += int(js.eval_step(ts, jx, jy)["correct"])
            correct["t"] += int(ps.eval_step(tx, ty)["correct"])
        assert correct["t"] == correct["j"] > 0
    finally:
        jd.close()
        td.close()


@pytest.mark.parametrize("prefetch", [[], ["--no-prefetch"]])
def test_cli_learns_the_digits(digits, prefetch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-b", "mnist", "-m", "lenet", "-s", "--data-dir",
                       digits, "-e", "3", "-p", "1000", "--dtype", "float32",
                       "--lr", "0.1", "--batch-size", "32", "--device",
                       "cpu", *prefetch])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert sum(line.startswith("train | ") for line in lines) == 3
    assert sum(line.startswith("valid | ") for line in lines) == 3
    assert any(line.startswith("valid accuracy: ") for line in lines)
    result = json.loads(lines[-1][len("result: "):])
    assert result["valid_accuracy"] >= 0.8, result
    assert len(result["valid_history"]) == 3
