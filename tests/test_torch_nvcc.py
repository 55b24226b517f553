"""The port's kernel builder names each library by a hash of its source,
of every header the source includes by a quoted relative path (followed
recursively) and of the flags, so that an edited header rebuilds every
library that includes it.  These tests check the hash alone: no nvcc."""
from pathlib import Path

import pytest

from repro_torch.kernels import nvcc

REPO_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture
def tree(tmp_path):
    """k/csrc/k.cu includes "../../csrc/shared.cuh", which includes
    "nested/inner.cuh"; other.cuh and a system header are not included
    by path."""
    (tmp_path / "k" / "csrc").mkdir(parents=True)
    (tmp_path / "csrc" / "nested").mkdir(parents=True)
    src = tmp_path / "k" / "csrc" / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n'
                   '#include "../../csrc/shared.cuh"\n'
                   '__global__ void k() {}\n')
    (tmp_path / "csrc" / "shared.cuh").write_text(
        '#pragma once\n  #  include "nested/inner.cuh"\nint shared;\n')
    (tmp_path / "csrc" / "nested" / "inner.cuh").write_text("int inner;\n")
    (tmp_path / "csrc" / "other.cuh").write_text("int other;\n")
    return tmp_path, src


def _name(src: Path, tmp_path: Path) -> str:
    return nvcc.lib_path(src, tmp_path / "_build").name


def test_sources_follow_quoted_includes_recursively(tree):
    tmp_path, src = tree
    assert nvcc.sources(src) == [
        src.resolve(), (tmp_path / "csrc" / "shared.cuh").resolve(),
        (tmp_path / "csrc" / "nested" / "inner.cuh").resolve()]


@pytest.mark.parametrize("edited", ["k/csrc/k.cu", "csrc/shared.cuh",
                                    "csrc/nested/inner.cuh"])
def test_editing_an_included_file_changes_the_library(tree, edited):
    tmp_path, src = tree
    before = _name(src, tmp_path)
    path = tmp_path / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _name(src, tmp_path)
    assert after != before
    assert after.startswith("libk-") and after.endswith(".so")


def test_editing_an_unrelated_file_keeps_the_library(tree):
    tmp_path, src = tree
    before = _name(src, tmp_path)
    (tmp_path / "csrc" / "other.cuh").write_text("int other = 1;\n")
    assert _name(src, tmp_path) == before


def test_include_cycle_and_missing_header_are_harmless(tree):
    tmp_path, src = tree
    inner = tmp_path / "csrc" / "nested" / "inner.cuh"
    inner.write_text('#include "../shared.cuh"\n#include "absent.cuh"\n')
    assert len(nvcc.sources(src)) == 3
    before = _name(src, tmp_path)
    inner.write_text('#include "../shared.cuh"\n#include "absent.cuh"\n'
                     "int inner;\n")
    assert _name(src, tmp_path) != before


@pytest.mark.parametrize("kernel,source,header", [
    pytest.param("flash_attention", "flash_prefill.cu", "sm90.cuh",
                 id="flash_attention-flash_prefill.cu"),
    pytest.param("moe_gmm", "gmm.cu", "sm90.cuh", id="moe_gmm-gmm.cu"),
    pytest.param("flash_attention", "flash_decode.cu", "mma.cuh",
                 id="flash_attention-flash_decode.cu-mma.cuh"),
    pytest.param("mamba2_ssd", "ssd.cu", "mma.cuh",
                 id="mamba2_ssd-ssd.cu-mma.cuh"),
    pytest.param("rwkv6", "wkv.cu", "mma.cuh",
                 id="rwkv6-wkv.cu-mma.cuh")])
def test_wgmma_kernels_depend_on_the_shared_hopper_header(kernel, source,
                                                          header):
    """K2 and K3 include the wgmma/TMA header, K1, K4 and K5 the
    mma.sync / cp.async one: an edit of the header must rebuild them."""
    found = nvcc.sources(REPO_SRC / "kernels" / kernel / "csrc" / source)
    assert (REPO_SRC / "kernels" / "csrc" / header).resolve() in found
