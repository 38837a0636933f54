"""The kernel build's cache key (utils/cuda_build.py) on the CPU: a build
is reused only while its source, every package file it includes and every
flag are unchanged. Nothing here needs nvcc."""

import os

import pytest

from spark_rapids_ml_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A kernel source tree: k.cu → "inc/a.cuh" → "b.cuh", plus <cuda.h>,
    a quoted include that is not a package file and an unrelated header."""
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text(
        '#include <cuda.h>\n#include "inc/a.cuh"\n#include "cuda_bf16.h"\n'
        'extern "C" int f() { return A; }\n')
    (tmp_path / "inc" / "a.cuh").write_text(
        '#pragma once\n  #  include "b.cuh"\n#define A B\n')
    (tmp_path / "inc" / "b.cuh").write_text(
        '#pragma once\n#include "a.cuh"\n#define B 1\n')
    (tmp_path / "unrelated.cuh").write_text("#define C 2\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    return tmp_path


def test_build_inputs_follow_quoted_includes(csrc):
    names = [os.path.relpath(p, csrc) for p in cuda_build.build_inputs("k")]
    assert sorted(names) == ["inc/a.cuh", "inc/b.cuh", "k.cu"]


@pytest.mark.parametrize("edited", ["k.cu", "inc/a.cuh", "inc/b.cuh"])
def test_editing_the_source_or_an_included_header_rebuilds(csrc, edited):
    before = cuda_build.library_path("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert cuda_build.library_path("k") != before


def test_editing_a_header_the_source_does_not_include_reuses(csrc):
    before = cuda_build.library_path("k")
    (csrc / "unrelated.cuh").write_text("#define C 3\n")
    assert cuda_build.library_path("k") == before


@pytest.mark.parametrize("attr,value", [
    ("NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",)),
    ("LINK_FLAGS", cuda_build.LINK_FLAGS + ("-lm",)),
    ("LINK_FLAGS", ()),
])
def test_changing_a_compiler_or_link_flag_rebuilds(csrc, monkeypatch, attr,
                                                   value):
    before = cuda_build.library_path("k")
    monkeypatch.setattr(cuda_build, attr, value)
    assert cuda_build.library_path("k") != before


def test_moving_a_flag_between_compile_and_link_rebuilds(csrc, monkeypatch):
    before = cuda_build.library_path("k")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + cuda_build.LINK_FLAGS)
    monkeypatch.setattr(cuda_build, "LINK_FLAGS", ())
    assert cuda_build.library_path("k") != before


def test_the_gram_kernel_build_covers_its_ptx_header():
    names = {os.path.basename(p)
             for p in cuda_build.build_inputs("fused_gram")}
    assert names == {"fused_gram.cu", "hopper_ptx.cuh"}
    assert "-lcuda" in cuda_build.LINK_FLAGS
