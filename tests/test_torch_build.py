"""The build key of the port's CUDA libraries (ops/_build.py).

A library is rebuilt when its name changes, so the name must cover every
file that goes into the build: the ``.cu`` source and the headers under
``ops/csrc/`` it includes, directly or through another header. Runs on the
CPU: nothing is compiled.
"""

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
