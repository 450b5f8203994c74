"""ctypes binding of the native data pipeline (``native/dataloader.cpp``):
the raw-store factory and the mmap-backed prefetching batch loader
(``ddlbench_tpu/data/native_loader.py``).

A store is ``images.bin`` (N*H*W*C uint8, NHWC) + ``labels.bin`` (N int32)
+ ``meta.json``. The C++ source is compiled at first use with ``g++ -O2
-shared -fPIC -pthread`` into ``build/torch_kernels/`` at the repository
root (gitignored), keyed by a hash of the source and the flags, like the
CUDA kernels (ops/_build.py). A failed build raises with the compiler's
output: there is no fallback to synthetic data.

:meth:`NativeDataLoader.next` copies each batch straight into the
caller's buffers (a pinned host tensor on the card's path,
data/ondisk.py), which nothing recycles: the reference's rotating ring of
returned buffers is not ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

from ddlbench_tpu_torch.config import DatasetSpec
from ddlbench_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")
RING_DEPTH = 4  # batches the C++ worker fills ahead (the reference's default)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _target(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"dataloader-{key.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless built already; returns the library's path.
    Raises with g++'s output when the build fails."""
    out = _target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: {cmd[0]}: {e}") \
            from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native loader build failed ({' '.join(cmd)}):\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I, I64, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_uint64)
        lib.dataset_generate.argtypes = [ctypes.c_char_p, I, I, I, I, I64,
                                         U64, I]
        lib.dataset_generate.restype = I
        lib.loader_open.argtypes = [ctypes.c_char_p, I, I, I, I, I64, I,
                                    U64, I, I]
        lib.loader_open.restype = P
        lib.loader_next.argtypes = [P, P, P]
        lib.loader_next.restype = I
        lib.loader_destroy.argtypes = [P]
        lib.loader_destroy.restype = None
        _lib = lib
        return lib


def store_hwc(spec: DatasetSpec) -> Tuple[int, int, int]:
    """The per-sample (H, W, C) of ``spec``'s raw store: the image size, or
    for a token stream T+1 int32 tokens as (T+1, 4, 1) bytes."""
    if spec.kind in ("tokens", "seq2seq"):
        return spec.seq_len + 1, 4, 1
    return tuple(spec.image_size)


def generate_dataset(data_dir: str, spec: DatasetSpec, split: str = "train",
                     count: Optional[int] = None, seed: int = 1,
                     threads: int = 4) -> str:
    """Write a raw synthetic store of ``count`` samples (default: the
    spec's split size) for one split under ``data_dir/<name>/<split>``;
    returns its directory. Uniform random bytes and labels, deterministic
    in ``seed``: the bytes of the reference's generator."""
    lib = _load()
    count = count or (spec.train_size if split == "train"
                      else spec.test_size)
    h, w, c = store_hwc(spec)
    out = os.path.join(data_dir, spec.name, split)
    os.makedirs(out, exist_ok=True)
    rc = lib.dataset_generate(out.encode(), h, w, c, spec.num_classes,
                              count, seed, threads)
    if rc != 0:
        raise RuntimeError(f"dataset_generate failed rc={rc} in {out}")
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump({"h": h, "w": w, "c": c, "classes": spec.num_classes,
                   "count": count, "seed": seed, "kind": spec.kind}, f)
    return out


class NativeDataLoader:
    """Prefetching batch iterator over a store directory: the C++ worker
    fills a ring of RING_DEPTH batches ahead; each epoch is a fresh
    shuffle (``shuffle``) seeded by (seed, epoch), and a batch that would
    run past the store's end starts the next epoch."""

    def __init__(self, dataset_dir: str, batch_size: int, seed: int = 1,
                 shuffle: bool = True):
        self._lib = _load()
        with open(os.path.join(dataset_dir, "meta.json")) as f:
            self.meta = json.load(f)
        m = self.meta
        self.batch_size = batch_size
        self.shape = (batch_size, m["h"], m["w"], m["c"])
        self._handle = self._lib.loader_open(
            dataset_dir.encode(), m["h"], m["w"], m["c"], m["classes"],
            m["count"], batch_size, seed, int(shuffle), RING_DEPTH)
        if not self._handle:
            raise RuntimeError(f"loader_open failed for {dataset_dir}")

    @property
    def steps_per_epoch(self) -> int:
        return self.meta["count"] // self.batch_size

    def next(self, into):
        """The next (images [B, H, W, C] uint8, labels [B] int32) batch,
        copied into ``into`` (a pair of C-contiguous numpy arrays or CPU
        tensors of those shapes and types), which is returned."""
        imgs, lbls = into
        contiguous = all(a.is_contiguous() if hasattr(a, "is_contiguous")
                         else a.flags.c_contiguous for a in into)
        if (tuple(imgs.shape) != self.shape
                or tuple(lbls.shape) != (self.batch_size,)
                or str(imgs.dtype).split(".")[-1] != "uint8"
                or str(lbls.dtype).split(".")[-1] != "int32"
                or not contiguous):
            raise ValueError(f"buffers {tuple(imgs.shape)} {imgs.dtype}, "
                             f"{tuple(lbls.shape)} {lbls.dtype} for "
                             f"batches of {self.shape} uint8, int32, "
                             "C-contiguous")
        ptr = [a.data_ptr() if hasattr(a, "data_ptr") else a.ctypes.data
               for a in into]
        rc = self._lib.loader_next(self._handle, *ptr)
        if rc != 0:
            raise RuntimeError(f"loader_next rc={rc}")
        return into

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
