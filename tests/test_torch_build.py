"""The port's kernel build key (``repro_torch.kernels._build.build_key``):
a change to a kernel source, or to a local header it includes, must give a
new key, so that a library built from other bytes is never loaded.  Pure
Python: runs without nvcc or a card."""

from pathlib import Path

import pytest

from repro_torch.kernels import _build

CSRC = Path(_build.__file__).resolve().parent / "csrc"


@pytest.fixture
def tree(tmp_path):
    (tmp_path / "kernel.cu").write_text(
        '#include <cuda_runtime.h>\n#include "tile.cuh"\nint k;\n')
    (tmp_path / "tile.cuh").write_text('  #  include "inner.cuh"\nint t;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "unrelated.cuh").write_text("int u;\n")
    return tmp_path


def test_build_key_is_stable(tree):
    assert _build.build_key(tree / "kernel.cu") == _build.build_key(
        tree / "kernel.cu")


@pytest.mark.parametrize("edited", ["kernel.cu", "tile.cuh", "inner.cuh"])
def test_build_key_follows_the_source_and_its_local_headers(tree, edited):
    before = _build.build_key(tree / "kernel.cu")
    path = tree / edited
    path.write_text(path.read_text() + "int more;\n")
    assert _build.build_key(tree / "kernel.cu") != before


def test_build_key_ignores_headers_it_does_not_include(tree):
    before = _build.build_key(tree / "kernel.cu")
    (tree / "unrelated.cuh").write_text("int changed;\n")
    assert _build.build_key(tree / "kernel.cu") == before


def test_build_key_survives_an_include_cycle_and_a_missing_header(tree):
    (tree / "inner.cuh").write_text('#include "tile.cuh"\n'
                                    '#include "missing.cuh"\n')
    assert len(_build.build_key(tree / "kernel.cu")) == 64


def test_every_kernel_source_has_its_own_key():
    sources = sorted(CSRC.glob("*.cu"))
    assert len(sources) >= 5
    assert len({_build.build_key(s) for s in sources}) == len(sources)
