"""ctypes binding of the C++ core of the partitioning DP
(``native/partitioner.cpp``; the reference's ``partition/native.py``).

The source is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/torch_kernels/partitioner-<hash>.so`` at the repository root
(gitignored), keyed by a hash of the source and the flags, as the data
loader's C++ (data/native_loader.py) and the CUDA kernels (ops/_build.py)
are; ``make -C native`` is never run. :func:`load` raises with g++'s
output when the build fails; partition/optimizer.py then says so and
solves with its Python DP, which implements the same recurrence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ddlbench_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "partitioner.cpp"
# the reference's Makefile flags (no -ffast-math: IEEE sums, so both
# builds give the same tables)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def _target(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"partitioner-{key.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless built already; returns the library's
    path. Raises with g++'s output when the build fails."""
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
        raise RuntimeError(f"partitioner build failed: {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"partitioner build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with ``solve_level`` declared as the reference
    declares it; raises when it cannot be built or loaded (and again on
    every later call, with the first error)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.solve_level.argtypes = [
            ctypes.c_int, ctypes.c_int, f64, f64, f64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,  # sync_grads (0 = forward-only partitioning)
            ctypes.c_void_p,  # base_time or NULL
            f64, i32, i32,
        ]
        lib.solve_level.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the C++ core builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def build_error() -> Optional[str]:
    """The first failed build's or load's message, None if none failed."""
    return _error


def solve_level_native(
    times: np.ndarray,
    params: np.ndarray,
    acts: np.ndarray,
    max_units: int,
    bandwidth: float,
    hbm_bytes: float,
    versions_bound: int,
    memory_check: bool,
    sync_grads: bool = True,
    base_time: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run one DP level in C++. Returns (A, choice_k, choice_m), each of
    shape [(n+1), (n+1), (max_units+1)]."""
    lib = load()
    n = len(times)
    shape = (n + 1, n + 1, max_units + 1)
    A = np.full(shape, np.inf, np.float64)
    ck = np.full(shape, -1, np.int32)
    cm = np.full(shape, -1, np.int32)
    bt_ptr = None
    if base_time is not None:
        base_time = np.ascontiguousarray(base_time, np.float64)
        bt_ptr = base_time.ctypes.data_as(ctypes.c_void_p)
    lib.solve_level(
        n, max_units,
        np.ascontiguousarray(times, np.float64),
        np.ascontiguousarray(params, np.float64),
        np.ascontiguousarray(acts, np.float64),
        float(bandwidth), float(hbm_bytes), int(versions_bound),
        int(bool(memory_check)), int(bool(sync_grads)), bt_ptr, A, ck, cm,
    )
    return A, ck, cm


def backtrack(A: np.ndarray, ck: np.ndarray, cm: np.ndarray,
              i: int, j: int, m: int):
    """[(start, end, units)] from the C++ core's choice tables."""
    k, ml = int(ck[i, j, m]), int(cm[i, j, m])
    if k < 0:
        return [(i, j, m)]
    return backtrack(A, ck, cm, i, k, m - ml) + [(k, j, ml)]
