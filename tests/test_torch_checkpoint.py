"""The port's checkpoint commit protocol (ddlbench_tpu_torch/train/
checkpoint.py) held to the reference's (ddlbench_tpu/train/checkpoint.py).

A directory of checkpoints is built (committed ones, a stale ``.tmp``, a
marker-less one of the protocol's layout, one of the legacy shape) and
damaged one way per case (truncated, a flipped byte, a file missing, an
unreadable marker). The port's and the reference's ``verify_checkpoint``,
``latest_valid`` (its choice and its log lines) and ``gc_checkpoints``
(what it deletes, at every ``keep`` and with a pin) must decide alike:
on a directory the port wrote, and on one the reference wrote (orbax on
the CPU), each package's functions on the other's checkpoints.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import io
import contextlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ddlbench_tpu.train import checkpoint as jck

from ddlbench_tpu_torch.train import checkpoint as tck

pytestmark = pytest.mark.torchport


def _state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params": [torch.randn(3, 4, generator=g), torch.randn(4)],
            "model_state": [],
            "opt": {"m": [torch.zeros(3, 4), torch.zeros(4)],
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _jax_state(seed: int = 0):
    import jax.numpy as jnp

    s = _state(seed)
    return {"params": [jnp.asarray(t.numpy()) for t in s["params"]],
            "opt": {"m": [jnp.asarray(t.numpy()) for t in s["opt"]["m"]],
                    "step": jnp.asarray(7, jnp.int32)}}


def _write(root: str, writer: str) -> None:
    """Three committed checkpoints (epoch 1, epoch 2 step 1, epoch 2), a
    stale tmp and a marker-less directory of the protocol's layout."""
    save = (tck.save_checkpoint if writer == "port"
            else jck.save_checkpoint)
    state = _state if writer == "port" else _jax_state
    for epoch, step in ((1, None), (2, 1), (2, None)):
        save(root, epoch, state(epoch), step=step, global_step=4 * epoch,
             logger_state={"valid_history": []}, seed=1,
             logical={"schema": 1, "world": 1})
    os.makedirs(os.path.join(root, "epoch_3.tmp", "state"))
    os.makedirs(os.path.join(root, "epoch_3_step_0", "state"))


def _damage(root: str, how: str) -> None:
    """Damage the newest committed checkpoint (epoch_2) ``how``."""
    path = os.path.join(root, "epoch_2")
    with open(os.path.join(path, "COMMIT.json")) as f:
        files = sorted(json.load(f)["files"])
    victim = os.path.join(path, [f for f in files if f.startswith("state")][0])
    if how == "truncated":
        with open(victim, "rb+") as f:
            f.truncate(os.path.getsize(victim) // 2)
    elif how == "bitflip":
        with open(victim, "rb+") as f:
            f.seek(os.path.getsize(victim) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x01]))
    elif how == "missing":
        os.remove(victim)
    elif how == "bad_marker":
        with open(os.path.join(path, "COMMIT.json"), "w") as f:
            f.write("{\"files\": ")
    elif how == "no_marker":
        os.remove(os.path.join(path, "COMMIT.json"))
    elif how == "legacy":
        # the reference's pre-protocol shape: files, no marker, no state/
        os.remove(os.path.join(path, "COMMIT.json"))
        shutil.rmtree(os.path.join(path, "state"))


def _said(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*args, **kw)
    return got, out.getvalue()


def _info(info):
    return None if info is None else (info.epoch, info.step,
                                      os.path.basename(info.path),
                                      info.meta)


DAMAGE = ("clean", "truncated", "bitflip", "missing", "bad_marker",
          "no_marker", "legacy")


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("how", DAMAGE)
def test_verify_and_latest_valid_decide_alike(tmp_path, writer, how):
    root = str(tmp_path / "ck")
    _write(root, writer)
    _damage(root, how)
    names = sorted(os.listdir(root))
    for name in names:
        p = os.path.join(root, name)
        assert tck.verify_checkpoint(p) == jck.verify_checkpoint(p), name
        assert tck.is_legacy_checkpoint(p) == jck.is_legacy_checkpoint(p)
    assert [(e, s, os.path.basename(p)) for e, s, p in
            tck.list_checkpoints(root)] == [
        (e, s, os.path.basename(p)) for e, s, p in jck.list_checkpoints(root)]
    got, said = _said(tck.latest_valid, root)
    want, want_said = _said(jck.latest_valid, root)
    assert _info(got) == _info(want) and said == want_said
    assert tck.latest_epoch(root) == jck.latest_epoch(root)
    # the marker-less epoch_3_step_0 is newest: skipped first, by name
    assert said.startswith("checkpoint: skipping epoch_3_step_0: no COMMIT "
                           "marker")
    if how == "clean":
        assert _info(got)[:3] == (2, None, "epoch_2")
    elif how != "legacy":
        # the damaged epoch-end checkpoint is skipped, naming why, and
        # the mid-epoch one before it wins
        assert _info(got)[:3] == (2, 1, "epoch_2_step_1")
        assert "checkpoint: skipping epoch_2:" in said
    if how == "bitflip":
        assert "checksum mismatch" in said


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("how", ["clean", "bitflip", "no_marker", "legacy"])
@pytest.mark.parametrize("keep", [1, 2, 3])
def test_gc_checkpoints_deletes_alike(tmp_path, writer, how, keep):
    built = str(tmp_path / "built")
    _write(built, writer)
    _damage(built, how)
    results = []
    for name, mod in (("port", tck), ("reference", jck)):
        root = str(tmp_path / name)
        shutil.copytree(built, root)
        pin = os.path.join(root, "epoch_1")
        deleted, said = _said(mod.gc_checkpoints, root, keep, pin=pin)
        results.append((sorted(os.path.basename(p) for p in deleted),
                        sorted(os.listdir(root)), said))
    assert results[0] == results[1]
    assert "epoch_1" in results[0][1]  # the pin survives any keep
    assert not any(n.endswith(".tmp") for n in results[0][1])


def test_gc_refuses_keep_below_one(tmp_path):
    with pytest.raises(ValueError, match=">= 1"):
        tck.gc_checkpoints(str(tmp_path), 0)


def test_commit_layout_and_state_round_trip(tmp_path):
    """A port commit: the state file, resume.json and logical.json, all
    in the marker's manifest; the state reads back bit for bit
    (weights_only); the retention policy runs after the commit."""
    root = str(tmp_path)
    state = _state(3)
    path = tck.save_checkpoint(root, 1, state, step=2, global_step=3,
                               logger_state={"epoch_times": [1.5]}, seed=9,
                               keep=1, logical={"schema": 1})
    assert os.path.basename(path) == "epoch_1_step_2"
    with open(os.path.join(path, "COMMIT.json")) as f:
        marker = json.load(f)
    assert sorted(marker["files"]) == [
        "logical.json", "resume.json", os.path.join("state",
                                                    "train_state.pt")]
    assert (marker["epoch"], marker["step"]) == (1, 2)
    with open(os.path.join(path, "resume.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 2, "global_step": 3,
                                "seed": 9,
                                "logger": {"epoch_times": [1.5]}}
    back = tck.load_state(path)
    assert torch.equal(back["params"][0], state["params"][0])
    assert back["opt"]["step"].dtype == torch.int32
    assert tck.load_logical(path) == {"schema": 1}
    tck.save_checkpoint(root, 1, state, keep=1)
    assert sorted(os.listdir(root)) == ["epoch_1"]
    info = tck.latest_valid(root)
    assert (info.epoch, info.step, info.mid_epoch) == (1, None, False)
    epoch, got = tck.restore_checkpoint(root)
    assert epoch == 1 and np.array_equal(got["params"][1].numpy(),
                                         state["params"][1].numpy())


def test_a_resave_replaces_the_old_copy_only_when_durable(tmp_path):
    """A stale tmp of a crashed save is never trusted: the next save of
    the same name rebuilds it, and the committed copy is replaced."""
    root = str(tmp_path)
    tck.save_checkpoint(root, 1, _state(0))
    os.makedirs(os.path.join(root, "epoch_1.tmp", "state"))
    with open(os.path.join(root, "epoch_1.tmp", "junk"), "w") as f:
        f.write("x")
    tck.save_checkpoint(root, 1, _state(1))
    assert sorted(os.listdir(root)) == ["epoch_1"]
    assert tck.verify_checkpoint(os.path.join(root, "epoch_1")) is None
    assert torch.equal(tck.load_state(os.path.join(root, "epoch_1"))
                       ["params"][0], _state(1)["params"][0])
