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


# a ptxas -v report and a cuobjdump -sass listing of two kernels, one of
# them a head_dim-256 template instantiation
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelILi256EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelILi256EEEvPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelILi64EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelILi64EEEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, 360 bytes cmem[0]
"""
SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_16kernelILi256EEEvPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0010*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R0, gdesc[UR4], RZ ;
\t\tFunction : _ZN12_GLOBAL__N_16kernelILi64EEEvPf
        /*0000*/                   FFMA R1, R2, R3, R4 ;
"""


def test_registers_and_spills_are_read_per_function():
    assert nvcc.ptxas_usage(PTXAS) == {
        "_ZN12_GLOBAL__N_16kernelILi256EEEvPf": dict(
            registers=255, spill_stores=8, spill_loads=4),
        "_ZN12_GLOBAL__N_16kernelILi64EEEvPf": dict(
            registers=80, spill_stores=0, spill_loads=0)}


def test_sass_counts_are_split_per_function(monkeypatch, tmp_path):
    monkeypatch.setattr(nvcc, "_sass", lambda lib: SASS)
    lib = tmp_path / "lib.so"
    assert nvcc.sass_counts_by_function(lib, ("HGMMA", "UTMALDG")) == {
        "_ZN12_GLOBAL__N_16kernelILi256EEEvPf": {"HGMMA": 2, "UTMALDG": 1},
        "_ZN12_GLOBAL__N_16kernelILi64EEEvPf": {"HGMMA": 0, "UTMALDG": 0}}
    assert nvcc.sass_counts(lib, ("HGMMA", "FFMA")) == {"HGMMA": 2,
                                                        "FFMA": 1}


def test_compile_all_keeps_the_build_log_beside_the_library(monkeypatch,
                                                           tree):
    """The compiler's report is kept as ``<library>.log``, so a check of
    it (spills) works for a library built by an earlier process, and a
    failed build leaves neither file."""
    tmp_path, src = tree
    report = tmp_path / "report.txt"
    report.write_text(PTXAS)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "case \"$3\" in *bad*) echo 'error: bad'; exit 2;; esac\n"
                    f"touch \"$2\"\ncat '{report}'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "_tool", lambda name: str(fake))
    todo = nvcc.jobs(src.parent, tmp_path / "_build", {"k": src.name})
    nvcc.compile_all(todo)
    lib = todo["k"][1]
    assert lib.exists()
    assert nvcc.build_log(lib) == PTXAS
    assert nvcc.ptxas_usage(nvcc.build_log(lib))[
        "_ZN12_GLOBAL__N_16kernelILi256EEEvPf"]["spill_stores"] == 8
    bad = src.with_name("bad.cu")
    bad.write_text("__global__ void k() {}\n")
    todo = nvcc.jobs(src.parent, tmp_path / "_build", {"bad": bad.name})
    with pytest.raises(RuntimeError, match="bad"):
        nvcc.compile_all(todo)
    lib = todo["bad"][1]
    assert not lib.exists() and not lib.with_suffix(".log").exists()
