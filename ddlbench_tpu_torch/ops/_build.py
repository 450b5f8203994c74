"""Build and bind the port's hand-written CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded with
``ctypes``. The build happens at first use, into ``build/torch_kernels/`` at
the repository root (listed in ``.gitignore``), keyed by a hash of the
source and the compiler flags, so a fresh checkout builds what it runs and
an edited source is rebuilt. Nothing is built or loaded at import time: the
CPU tests import every module on a machine with no ``nvcc``.

Every launcher in a library returns ``cudaGetLastError()``; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library name -> {C function: argtypes}; every function returns a
# cudaError_t as int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "paged_attention": {
        # q, pool_k, pool_v, table, pos, out, rows, H, dh, page, npl,
        # tstride, scale, ktype, stream
        "ddl_paged_decode": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        # q, pool_k, pool_v, table, start, out, rows, H, C, dh, page, npl,
        # tstride, scale, ktype, stream
        "ddl_paged_chunk": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    },
    "flash_attention": {
        # q, k, v, o, lse, BH, Tq, Tk, dh, q_offset, k_offset, prefix_len,
        # scale, dtype, stream
        "ddl_flash_fwd": [_P] * 5 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, dq, then as above
        "ddl_flash_dq": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, dk, dv, then as above
        "ddl_flash_dkv": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels build on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0.0
    for a library already built). Raises with the compiler's output on a
    failed build; ``-Xptxas -v`` register/shared-memory reports go to the
    log file beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = _target(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes
    and restype declared for each of its functions."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.ddl_error_string.argtypes = [ctypes.c_int]
        lib.ddl_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher of ``lib`` returned a CUDA error code."""
    if code != 0:
        msg = lib.ddl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
