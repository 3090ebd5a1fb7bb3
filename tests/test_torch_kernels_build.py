"""The kernel build's bookkeeping (ray_tpu_torch/_kernels.py), on the CPU:
no nvcc is run. The library's path must change whenever what nvcc would
compile changes (the source, any shared header, the flags), and the
ptxas / SASS reports that chip_smoke.py prints must parse."""

import re

import pytest

from ray_tpu_torch import _kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return 0; }\n')
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", list(_kernels.NVCC_FLAGS))
    return src


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "flag"])
def test_target_changes_with_what_nvcc_compiles(csrc, edit):
    before = _kernels._target("k")
    assert before == _kernels._target("k")  # stable while nothing changes
    if edit == "source":
        (csrc / "k.cu").write_text((csrc / "k.cu").read_text() + "// edited\n")
    elif edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n#define X 1\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        _kernels.NVCC_FLAGS.append("-lineinfo")
    after = _kernels._target("k")
    assert after != before
    assert after.parent == before.parent and re.fullmatch(r"libk-[0-9a-f]{12}\.so", after.name)


def test_target_ignores_files_nvcc_does_not_read(csrc):
    before = _kernels._target("k")
    (csrc / "notes.txt").write_text("not compiled\n")
    (csrc / "other.cu").write_text("// another library's source\n")
    assert _kernels._target("k") == before


def test_local_includes_are_shared_headers_in_csrc():
    """The hash covers csrc/*.cuh, so every quoted include of a kernel
    source must be one of them."""
    sources = sorted(_kernels.CSRC_DIR.glob("*.cu")) + sorted(_kernels.CSRC_DIR.glob("*.cuh"))
    assert {p.stem for p in sources if p.suffix == ".cu"} == set(_kernels.SOURCES)
    for path in sources:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            assert inc.endswith(".cuh") and (_kernels.CSRC_DIR / inc).is_file(), (path.name, inc)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size
"""


def test_ptxas_report_per_kernel():
    assert _kernels.ptxas_report(PTXAS_LOG) == {
        "_Z6kernelILi128EEvv": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "_Z6kernelILi64EEvv": {"registers": 64, "spill_stores": 12, "spill_loads": 20},
    }
    assert _kernels.ptxas_report("") == {}


SASS = """\
\tcode for sm_90a
\t\tFunction : _Z1av
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a80*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0a90*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0aa0*/              @P0  HGMMA.64x64x16.F32.BF16 R88, R20, gdesc[UR4], R88 ;
        /*0ab0*/                   WARPGROUP.ARRIVE ;
\t\tFunction : _Z1bv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   EXIT ;
"""


def test_count_sass_per_kernel():
    assert _kernels.count_sass(SASS, "HGMMA") == {"_Z1av": 3, "_Z1bv": 0}
    assert _kernels.count_sass(SASS, "FFMA") == {"_Z1av": 0, "_Z1bv": 1}
    assert _kernels.count_sass(SASS, "WARPGROUP") == {"_Z1av": 1, "_Z1bv": 0}
