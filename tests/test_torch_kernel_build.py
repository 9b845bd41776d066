"""PyTorch port: the kernel build's cache key (``kernel_build.CudaKernel``).

A library's file name hashes its source, every header the source pulls
in with ``#include "..."``, and the flags: an edited header must give a
new name (else a stale library would be loaded), an unrelated file must
not.  Runs on the CPU: nothing is compiled.
"""
import os

import pytest

from paddle_tpu_torch import kernel_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A throwaway csrc directory: k.cu includes a.cuh, which includes
    b.cuh; other.cuh is included by nothing."""
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(tmp_path))
    files = {
        "k.cu": '#include <cuda_runtime.h>\n#include "a.cuh"\n'
                'extern "C" int f() { return A + B; }\n',
        "a.cuh": '#pragma once\n#include "b.cuh"\nconstexpr int A = 1;\n',
        "b.cuh": "#pragma once\nconstexpr int B = 2;\n",
        "other.cuh": "constexpr int C = 3;\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def _key():
    return kernel_build.CudaKernel("k.cu", {}).lib_path()


def test_lib_path_names_the_source_and_lives_in_the_build_dir(csrc):
    path = _key()
    assert os.path.dirname(path) == kernel_build.BUILD_DIR
    assert os.path.basename(path).startswith("libk-")
    assert path == _key()   # stable


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_lib_path_changes_with_the_source_and_its_headers(csrc, edited):
    before = _key()
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert _key() != before


@pytest.mark.parametrize("edited", ["other.cuh", "unrelated.txt"])
def test_lib_path_ignores_files_the_source_does_not_include(csrc, edited):
    before = _key()
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert _key() == before


def test_sources_with_headers_scans_include_lines_once(csrc):
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')  # a cycle
    got = kernel_build._sources_with_headers(str(csrc / "k.cu"))
    assert [os.path.basename(p) for p in got] == ["k.cu", "a.cuh", "b.cuh"]


def test_flash_source_key_covers_hopper_header():
    from paddle_tpu_torch.ops.flash_attention import FLASH

    got = kernel_build._sources_with_headers(FLASH.source_path)
    assert [os.path.basename(p) for p in got] == ["flash_attention.cu",
                                                  "hopper.cuh"]
