"""The build key of the port's CUDA libraries (ops/_build.py).

A library is rebuilt when its name changes, so the name must cover every
file that goes into the build: the ``.cu`` source and the headers under
``ops/csrc/`` it includes, directly or through another header. Also: the
training step's bf16 kernels are all Hopper kernels (wgmma and TMA, no
mma.sync), read from chip_smoke.py's constants and the sources. Runs on the
CPU: nothing is compiled.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import importlib.util
import re
from pathlib import Path

import pytest

from ddlbench_tpu_torch.ops import _build

pytestmark = pytest.mark.torchport


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of two libraries: lib.cu includes a.cuh, which
    includes b.cuh; other.cu includes nothing; c.cuh is included by
    neither."""
    files = {
        "lib.cu": ('#include <cuda.h>\n#include "a.cuh"\n'
                   "int f() { return 1; }\n"),
        "a.cuh": '#pragma once\n  #  include "b.cuh"\n',
        "b.cuh": "#pragma once\nint g();\n",
        "c.cuh": "#pragma once\n",
        "other.cu": "int h() { return 2; }\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_sources_follow_quoted_includes_through_headers(csrc):
    assert [p.name for p in _build._sources("lib")] == ["lib.cu", "a.cuh",
                                                       "b.cuh"]
    assert [p.name for p in _build._sources("other")] == ["other.cu"]


@pytest.mark.parametrize("edited", ["lib.cu", "a.cuh", "b.cuh"])
def test_target_changes_when_a_file_of_the_build_changes(csrc, edited):
    before = _build._target("lib")
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    after = _build._target("lib")
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith("lib-") and after.suffix == ".so"


@pytest.mark.parametrize("edited", ["other.cu", "c.cuh"])
def test_target_stays_when_an_unrelated_file_changes(csrc, edited):
    before = _build._target("lib")
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    assert _build._target("lib") == before


def test_target_covers_the_compiler_flags(csrc, monkeypatch):
    before = _build._target("lib")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("lib") != before


def test_flash_library_names_its_hopper_header():
    assert "hopper.cuh" in [p.name for p in _build._sources(
        "flash_attention")]


def test_fused_xent_library_names_its_hopper_header():
    assert "hopper.cuh" in [p.name for p in _build._sources("fused_xent")]


def _chip_smoke():
    """chip_smoke.py (top level of the repository) as a module; importing
    it runs nothing and needs no torch."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reached(source: str, name: str, depth: int = 3) -> str:
    """The body of function ``name`` in ``source`` (defined from the first
    column), with the bodies of the file's functions it calls, followed
    ``depth`` calls deep."""
    m = re.search(r"^\w[^\n;(]*\b" + name + r"\s*\([^;{]*\)\s*\{",
                  source, re.M)
    if m is None:
        return ""
    end = source.index("\n}\n", m.end())
    body = source[m.start():end]
    if depth:
        for callee in set(re.findall(r"\b(\w+)\s*(?:<[^>]*>)?\s*\(", body)):
            if callee != name:
                body += _reached(source, callee, depth - 1)
    return body


def test_training_step_kernels_are_all_hopper_kernels():
    """Every bf16 kernel of a training step is one the build phase holds
    to wgmma and TMA with no mma.sync."""
    cs = _chip_smoke()
    assert set(cs.TRAIN_KERNELS) <= set(cs.FLASH_HOPPER) | set(cs.FX_HOPPER)
    assert set(cs.FLASH_HOPPER) | set(cs.FX_HOPPER) <= (
        set(cs.FLASH_BUILT) | set(cs.FX_BUILT))


@pytest.mark.parametrize("lib,launcher,kernel", [
    ("flash_attention", "ddl_flash_fwd", "flash_fwd_wgmma"),
    ("flash_attention", "ddl_flash_dq", "flash_dq_wgmma"),
    ("flash_attention", "ddl_flash_dkv", "flash_dkv_wgmma"),
    ("fused_xent", "ddl_fxent_fwd", "fx_fwd_wgmma"),
    ("fused_xent", "ddl_fxent_dh", "fx_dh_wgmma"),
    ("fused_xent", "ddl_fxent_dw", "fx_dw_wgmma"),
    ("paged_attention", "ddl_paged_chunk", "paged_chunk_tiled"),
    ("paged_attention", "ddl_paged_decode", "paged_decode_ring"),
])
def test_launchers_reach_the_hopper_kernels(lib, launcher, kernel):
    source = (_build._CSRC / f"{lib}.cu").read_text()
    body = _reached(source, launcher)
    assert body, launcher
    assert kernel in body
    assert not re.search(r"\w+_mma\b", body), launcher


@pytest.mark.parametrize("lib", ["flash_attention", "fused_xent"])
def test_no_mma_sync_is_left_in_the_training_libraries(lib):
    code = re.sub(r"//[^\n]*", "", (_build._CSRC / f"{lib}.cu").read_text())
    assert "mma.sync" not in code and "ldmatrix" not in code


def _kernel(source: str, name: str) -> str:
    """The body of __global__ kernel ``name`` in ``source``, with the bodies
    of the file's functions it calls (``_reached``)."""
    m = re.search(r"__global__[^;{]*?\b" + name + r"\s*\(", source)
    assert m, name
    body = source[m.start():source.index("\n}\n", m.end())]
    for callee in set(re.findall(r"\b(\w+)\s*(?:<[^>]*>)?\s*\(", body)):
        if callee != name:
            body += _reached(source, callee)
    return body


def test_paged_chunk_kernel_copies_its_pages_by_cp_async():
    """The chunk kernel's ring is filled by cp.async (16-byte copies, waited
    by group); the kernel it replaced, one block per query, is gone."""
    source = (_build._CSRC / "paged_attention.cu").read_text()
    body = _kernel(source, "paged_chunk_tiled")
    assert "cp_async16(" in body and "cp_async_wait<" in body
    assert "cp.async.cg.shared.global" in _reached(source, "cp_async16")
    assert "paged_chunk_kernel" not in source


def test_paged_decode_kernel_copies_its_pages_by_cp_async():
    """The decode kernel stages pos and its table row by cp.async in one
    trip, and fills its warps' rings by 16-byte cp.async copies, waited by
    group; the kernel it replaced, a chain of loads per page, is gone."""
    source = (_build._CSRC / "paged_attention.cu").read_text()
    body = _kernel(source, "paged_decode_ring")
    assert "cp_async4(spos" in body and "cp_async4(stab" in body
    assert "cp_async16(" in body and "cp_async_wait<" in body
    assert "paged_decode_kernel" not in source
