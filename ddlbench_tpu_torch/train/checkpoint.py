"""Crash-consistent checkpoints of a train state
(``ddlbench_tpu/train/checkpoint.py``).

A checkpoint is a directory ``<ckpt_dir>/epoch_N`` (the per-epoch one;
a resume starts at epoch N+1) or ``epoch_N_step_S`` (written every
``checkpoint_every_steps`` steps; S is the 0-based index of the last
completed step, and a resume starts at step S+1 of epoch N). It is
committed through the reference's protocol:

1. the state is written under ``<name>.tmp/state/train_state.pt``: one
   ``torch.save`` of the train state gathered to its global layout (the
   strategies' ``checkpoint_state``; where the reference writes an orbax
   tree of sharded arrays, the port writes the same tree whole);
2. ``resume.json`` (epoch, interior step, global step, seed, the metric
   logger's counters) and, when given, ``logical.json`` (the
   topology-portable metadata of train/reshard.py) are written beside it;
3. ``COMMIT.json``, carrying every other file's size and SHA-256, is
   written and fsynced last;
4. the ``.tmp`` directory is renamed to its final name atomically and the
   parent directory fsynced.

A crash at any point leaves a ``.tmp`` directory without a marker
(ignored and collected) or a whole checkpoint. :func:`latest_valid` walks
the checkpoints newest first, verifies each against its manifest (a
truncated or bit-flipped file fails), prints what it skips and falls back
to the previous good one; :func:`gc_checkpoints` keeps the newest ``keep``.
Only one process writes (rank 0, train/loop.py); :func:`load_state` reads
the file back with ``weights_only=True``.

The reference's fault hook (``faults.checkpoint_saved``, the
``ckpt-corrupt`` fault) is not ported (ROADMAP A.8, the guard-and-faults
group).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

COMMIT_MARKER = "COMMIT.json"
RESUME_META = "resume.json"
# topology-portable metadata (train/reshard.py): leaf shapes, the flat
# bucket layout and the world/dp/stage shape the state was saved under
LOGICAL_META = "logical.json"
_STATE_SUBDIR = "state"
STATE_FILE = os.path.join(_STATE_SUBDIR, "train_state.pt")
_NAME_RE = re.compile(r"^epoch_(\d+)(?:_step_(\d+))?$")


def checkpoint_name(epoch: int, step: Optional[int] = None) -> str:
    return f"epoch_{epoch}" if step is None else f"epoch_{epoch}_step_{step}"


def _parse_name(name: str) -> Optional[Tuple[int, Optional[int]]]:
    m = _NAME_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), (int(m.group(2)) if m.group(2) else None)


def _order_key(epoch: int, step: Optional[int]) -> Tuple[int, float]:
    # within an epoch, the epoch-end checkpoint outranks any interior step
    return (epoch, float("inf") if step is None else float(step))


def _fsync_path(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest(root: str, skip: Tuple[str, ...] = (COMMIT_MARKER,)
              ) -> Dict[str, Dict[str, Any]]:
    """{relative path: {size, sha256}} of every file under ``root``, each
    fsynced on the way (the marker asserts every byte is durable, and a
    directory fsync does not flush file contents)."""
    out: Dict[str, Dict[str, Any]] = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if rel in skip:
                continue
            _fsync_path(p)
            out[rel] = {"size": os.path.getsize(p), "sha256": _sha256(p)}
    return out


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    """One committed checkpoint: its coordinates, path and resume meta."""

    epoch: int
    step: Optional[int]  # interior step index of the LAST COMPLETED step
    path: str
    meta: Dict[str, Any]

    @property
    def mid_epoch(self) -> bool:
        return self.step is not None


def save_checkpoint(ckpt_dir: str, epoch: int, state: Any,
                    step: Optional[int] = None,
                    global_step: Optional[int] = None,
                    logger_state: Optional[Dict[str, Any]] = None,
                    seed: Optional[int] = None,
                    keep: Optional[int] = None,
                    pin: Optional[str] = None,
                    logical: Optional[Dict[str, Any]] = None) -> str:
    """Atomically commit ``state`` (a tree of dicts, lists, CPU tensors
    and numbers) under ``<ckpt_dir>/<name>`` and return the committed
    path. ``step`` selects the step-granular name; ``keep`` applies the
    retention policy after the commit (:func:`gc_checkpoints`), never
    dropping ``pin`` (the loop's current resume target)."""
    import torch

    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    name = checkpoint_name(epoch, step)
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.isdir(tmp):  # stale tmp from a crashed save: never trusted
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, _STATE_SUBDIR))
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    _write_json(os.path.join(tmp, RESUME_META), {
        "epoch": epoch, "step": step, "global_step": global_step,
        "seed": seed, "logger": logger_state})
    if logical is not None:
        # inside the tmp dir before the marker: the manifest covers it
        _write_json(os.path.join(tmp, LOGICAL_META), logical)
    # the marker last: its presence asserts every other byte is durable
    _write_json(os.path.join(tmp, COMMIT_MARKER),
                {"epoch": epoch, "step": step, "files": _manifest(tmp)})
    _fsync_path(tmp)
    # a same-name re-save replaces the old copy only now, when the new
    # one is durable
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)
    if keep is not None:
        gc_checkpoints(ckpt_dir, keep, pin=pin)
    return final


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, Optional[int], str]]:
    """All checkpoint-named entries (committed or not), oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        parsed = _parse_name(name)
        if parsed is not None:
            found.append((*parsed, os.path.join(ckpt_dir, name)))
    found.sort(key=lambda t: _order_key(t[0], t[1]))
    return found


def is_legacy_checkpoint(path: str) -> bool:
    """The reference's test for a pre-protocol checkpoint: no COMMIT
    marker and no ``state`` subdirectory, but files. The port has no
    pre-protocol checkpoints (it never wrote any), so this is True only
    for a hand-made directory of that shape; the function stays so that
    :func:`latest_valid` and :func:`gc_checkpoints` decide as the
    reference's do on any directory (a ``load_state`` of such a
    directory fails, loudly)."""
    return (os.path.isdir(path)
            and not os.path.exists(os.path.join(path, COMMIT_MARKER))
            and not os.path.isdir(os.path.join(path, _STATE_SUBDIR))
            and bool(os.listdir(path)))


def verify_checkpoint(path: str) -> Optional[str]:
    """None if ``path`` is a committed, manifest-clean checkpoint; else the
    reason it is invalid."""
    marker_path = os.path.join(path, COMMIT_MARKER)
    if not os.path.exists(marker_path):
        return "no COMMIT marker (crashed mid-save?)"
    try:
        with open(marker_path) as f:
            marker = json.load(f)
        files = marker["files"]
    except (OSError, ValueError, KeyError) as e:
        return f"unreadable COMMIT marker ({e})"
    for rel, want in files.items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return f"missing file {rel}"
        size = os.path.getsize(p)
        if size != want["size"]:
            return f"size mismatch on {rel} ({size} != {want['size']})"
        if _sha256(p) != want["sha256"]:
            return f"checksum mismatch on {rel} (corrupt?)"
    return None


def latest_valid(ckpt_dir: str) -> Optional[CheckpointInfo]:
    """The newest committed and verified checkpoint, falling back past
    invalid ones (each skipped with a line naming why); None when none is
    valid."""
    for epoch, step, path in reversed(list_checkpoints(ckpt_dir)):
        if is_legacy_checkpoint(path):
            print(f"checkpoint: {os.path.basename(path)} predates the "
                  f"commit protocol (no manifest); restoring unverified",
                  flush=True)
            return CheckpointInfo(epoch, step, path,
                                  {"epoch": epoch, "step": step})
        reason = verify_checkpoint(path)
        if reason is not None:
            print(f"checkpoint: skipping {os.path.basename(path)}: {reason}",
                  flush=True)
            continue
        try:
            with open(os.path.join(path, RESUME_META)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {"epoch": epoch, "step": step}
        return CheckpointInfo(epoch, step, path, meta)
    return None


def load_logical(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint's logical metadata, or None where it has none."""
    p = os.path.join(path, LOGICAL_META)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def gc_checkpoints(ckpt_dir: str, keep: int,
                   pin: Optional[str] = None) -> List[str]:
    """Keep the newest ``keep`` restorable checkpoints (committed, or of
    the legacy shape), delete the older ones, stale ``.tmp`` directories
    and marker-less directories of the protocol's layout; ``pin`` is never
    aged out. Restorable here means a marker, not a verified manifest (the
    collection runs after every save). Returns the deleted paths."""
    if keep < 1:
        raise ValueError("keep-checkpoints must be >= 1")
    deleted: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return deleted
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp") and _parse_name(name[:-4]) is not None:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            deleted.append(os.path.join(ckpt_dir, name))

    def _restorable(p: str) -> bool:
        return (os.path.exists(os.path.join(p, COMMIT_MARKER))
                or is_legacy_checkpoint(p))

    pin_real = os.path.realpath(pin) if pin else None
    entries = list_checkpoints(ckpt_dir)
    keepers = [t for t in entries if _restorable(t[2])]
    drop = keepers[:-keep] if len(keepers) > keep else []
    drop = [t for t in drop if os.path.realpath(t[2]) != pin_real]
    remnants = [t for t in entries if not _restorable(t[2])]
    for _, _, path in drop + remnants:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
        print(f"checkpoint: retention dropped {os.path.basename(path)}",
              flush=True)
    return deleted


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The newest epoch present by name (committed or not); a resume uses
    :func:`latest_valid`."""
    epochs = [e for e, s, _ in list_checkpoints(ckpt_dir) if s is None]
    return max(epochs) if epochs else None


def load_state(path: str) -> Any:
    """The state tree of the checkpoint at ``path``, on the CPU."""
    import torch

    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str,
                       epoch: Optional[int] = None) -> Tuple[int, Any]:
    """(epoch, state) of the given or the latest valid epoch checkpoint."""
    if epoch is None:
        info = latest_valid(ckpt_dir)
        if info is None:
            raise FileNotFoundError(
                f"no valid checkpoints under {ckpt_dir!r}")
        return info.epoch, load_state(info.path)
    path = os.path.join(os.path.abspath(ckpt_dir), checkpoint_name(epoch))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint {path!r}")
    return epoch, load_state(path)
