"""The port's kernel build cache (kernels/_build.py) on the CPU, no nvcc.

A library's file name carries the hash of its source and of every csrc/
header the source includes, so an edit to a shared header rebuilds each
kernel that includes it and no other.
"""

import shutil

import pytest

from dynamic_multiview_3d_torch.kernels import _build

# each kernel source and the csrc/ headers it includes besides the taps
KERNELS = {"warp_composite": (), "warp_composite_bwd": (),
           "multiflow_composite": ("multiflow.cuh",),
           "multiflow_composite_bwd": ("multiflow.cuh",),
           "sample": (), "reproject": ("reproject.cuh",),
           "reproject_bwd": ("reproject.cuh",)}


@pytest.mark.parametrize("name", KERNELS)
def test_every_kernel_includes_the_shared_taps(name):
    assert [p.name for p in _build.sources(name)] == [
        f"{name}.cu", "bilinear.cuh", *KERNELS[name]]


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ with one more kernel whose header nests another."""
    root = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, root)
    (root / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (root / "inner.cuh").write_text("#pragma once\n// inner\n")
    (root / "nested.cu").write_text('#include <cuda_runtime.h>\n'
                                    '#include "outer.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", root)
    return root


def test_nested_headers_are_found_once(csrc):
    (csrc / "inner.cuh").write_text('#pragma once\n#include "outer.cuh"\n')
    assert [p.name for p in _build.sources("nested")] == [
        "nested.cu", "outer.cuh", "inner.cuh"]


@pytest.mark.parametrize("header,rebuilds", [
    ("bilinear.cuh", tuple(KERNELS)),
    ("inner.cuh", ("nested",)),
    ("reproject.cuh", ("reproject", "reproject_bwd")),
    ("multiflow.cuh", ("multiflow_composite", "multiflow_composite_bwd")),
])
def test_a_header_edit_rebuilds_exactly_its_includers(csrc, header, rebuilds):
    names = tuple(KERNELS) + ("nested",)
    before = {n: _build.library_path(n) for n in names}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert {n for n in names if after[n] != before[n]} == set(rebuilds)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


@pytest.mark.parametrize("name", ["multiflow_composite",
                                  "multiflow_composite_bwd"])
def test_each_instantiation_is_a_library_of_its_own(name):
    """The multi-source kernels are built per (T, padding): every pair has
    its own cached library, the same one each time it is asked for."""
    from dynamic_multiview_3d_torch.kernels import multiflow
    pairs = [(t, pad) for t in (1, 3, 16, 17, 24)
             for pad in ("border", "zeros")]
    paths = {pair: _build.library_path(name, multiflow._defines(*pair))
             for pair in pairs}
    assert len(set(paths.values())) == len(pairs)
    assert _build.library_path(name, multiflow._defines(17, "zeros")) == \
        paths[17, "zeros"]
    assert _build.library_path(name) not in paths.values()
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())


def test_build_passes_the_defines_to_nvcc(tmp_path, monkeypatch):
    """``build`` hands each define to nvcc as -D, writes the library under
    its hashed name and keeps it: a second build of the pair runs nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        (tmp_path / cmd[cmd.index("-o") + 1]).write_bytes(b"")

        class Done:
            returncode, stdout = 0, "ptxas info"
        return Done()
    monkeypatch.setattr(_build.subprocess, "run", run)
    defines = ("DMV3D_MF_T=17", "DMV3D_MF_BORDER=0")
    assert _build.build("multiflow_composite", defines) == "ptxas info"
    assert _build.library_path("multiflow_composite", defines).exists()
    assert _build.build("multiflow_composite", defines) == ""
    (cmd,) = calls
    assert cmd[0] == "nvcc" and cmd[-1].endswith("multiflow_composite.cu")
    assert [a for a in cmd if a.startswith("-D")] == [
        "-DDMV3D_MF_T=17", "-DDMV3D_MF_BORDER=0"]
    assert set(_build.NVCC_FLAGS) <= set(cmd)
