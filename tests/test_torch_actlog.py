"""The port's activation/gradient logger (profiler/actlog.py) held to the
reference's on the same weights and batch.

* lenet (mnist), a convolution + BatchNorm model and transformer_t
  (T 32, vocab 64) from the reference's initial weights (convert.py), one
  float32 capture each: the ``.npz`` keys equal the reference's, the loss
  within 1e-5 relative, every activation and gradient within ACT_TOL
  (rtol, atol scaled by the array's largest magnitude); image maps are
  written NHWC, as the reference writes them;
* the capture changes nothing: parameters and BatchNorm's running
  statistics bitwise as before, no ``.grad`` written;
* the loop logs the first steps under ``single`` ("activations logged:
  <path>", freq and steps honoured) and skips a pipeline strategy,
  saying so, as the reference does.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipes
from ddlbench_tpu.models.layers import init_model
from ddlbench_tpu.models.zoo import get_model as jax_get_model
from ddlbench_tpu.profiler.actlog import ActivationLogger as JaxLogger

from ddlbench_tpu_torch import config as tconfig
from ddlbench_tpu_torch.config import RunConfig
from ddlbench_tpu_torch.convert import from_jax_params, from_jax_state
from ddlbench_tpu_torch.models.zoo import get_model
from ddlbench_tpu_torch.profiler.actlog import ActivationLogger

pytestmark = pytest.mark.torchport

# activations and gradients: relative, and absolute at this share of the
# array's largest magnitude (float32 sums in another order)
ACT_TOL = 1e-4


@pytest.fixture(autouse=True)
def tiny_datasets(monkeypatch):
    """The tiny benchmarks in the port's registry for each test (another
    test file's fixture removes its own "tinylm" when it ends)."""
    for name, spec in torch_pipes.datasets()[1].items():
        monkeypatch.setitem(tconfig.DATASETS, name, spec)


def models(name):
    """(reference model, port model with its weights, x, y) for one
    float32 capture."""
    rng = np.random.default_rng(3)
    if name == "lenet":
        jm = jax_get_model("lenet", "mnist")
        tm = get_model("lenet", "mnist")
        x = rng.standard_normal((4, 28, 28, 1)).astype(np.float32)
        y = np.array([0, 1, 2, 3], np.int32)
    else:
        key = "bn" if name == "bn" else "transformer_t"
        jm, tm = torch_pipes.jax_model(key), torch_pipes.port_model(key)
        x, y = torch_pipes.batches(key, 4, 1)[0]
    params, state, _ = init_model(jm, jax.random.key(0))
    from_jax_params(tm, jax.device_get(params))
    from_jax_state(tm, jax.device_get(state))
    return jm, tm, params, state, x, y


def port_input(x):
    t = torch.from_numpy(np.array(x))
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t.long()


@pytest.mark.parametrize("name", ["lenet", "bn", "transformer_t"])
def test_capture_matches_the_reference(tmp_path, name):
    jm, tm, params, state, x, y = models(name)
    want = np.load(JaxLogger(str(tmp_path / "jax"), jm, jnp.float32).log(
        1, 0, params, state, jnp.asarray(x), jnp.asarray(y)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = np.load(ActivationLogger(str(tmp_path / "port"), tm,
                                   torch.float32).log(
        1, 0, port_input(x), torch.from_numpy(np.array(y)).long()))
    assert sorted(got.files) == sorted(want.files)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    for k in want.files:
        w, g = want[k], got[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        np.testing.assert_allclose(
            g, w, rtol=ACT_TOL, atol=ACT_TOL * float(np.abs(w).max()),
            err_msg=k)
    after = tm.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in tm.parameters())


def test_the_loop_logs_the_first_steps(tmp_path, capsys):
    from ddlbench_tpu_torch.train.loop import run_benchmark

    cfg = RunConfig(benchmark="tinylm", arch="transformer_t", epochs=2,
                    steps_per_epoch=3, batch_size=2, compute_dtype="float32",
                    activation_log_dir=str(tmp_path), activation_log_freq=2,
                    activation_log_steps=2)
    run_benchmark(cfg, warmup_steps=0, device="cpu")
    out = capsys.readouterr().out
    assert out.count("activations logged:") == 2
    assert sorted(p.name for p in (tmp_path / "epoch1").iterdir()) == [
        "step0.npz", "step1.npz"]
    assert not (tmp_path / "epoch2").exists()  # freq 2: epochs 1, 3, ...
    keys = np.load(tmp_path / "epoch1" / "step0.npz").files
    assert "act_01_block1" in keys and "grad_03_lm_head" in keys


def test_a_pipeline_strategy_is_skipped(tmp_path, capsys):
    from ddlbench_tpu_torch.train.loop import run_benchmark

    cfg = RunConfig(benchmark="tinylm", arch="transformer_t",
                    strategy="gpipe", num_devices=2, micro_batch_size=2,
                    num_microbatches=2, epochs=1, steps_per_epoch=1,
                    compute_dtype="float32", activation_log_dir=str(tmp_path))
    run_benchmark(cfg, warmup_steps=0, device="cpu")
    assert ("activation logging unsupported for this strategy (packed or "
            "absent per-layer params); skipped") in capsys.readouterr().out
    assert not list(tmp_path.iterdir())
