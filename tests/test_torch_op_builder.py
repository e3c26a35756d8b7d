"""The port's kernel builder on the CPU: which libraries it counts as stale
(a source or any header it includes, directly or through another header,
newer than the library) and the target it compiles for. Nothing here runs
nvcc: a temporary source tree stands in for ``csrc`` and ``build``."""

import os

import pytest

from deepspeed_tpu_torch.ops import op_builder


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """csrc/k.cu includes outer.cuh, which includes inner.cuh; build/libk.so
    is newer than all three."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <cstdint>\n#include "outer.cuh"\n')
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "other.cuh").write_text("#pragma once\n")
    (build / "libk.so").write_bytes(b"")
    for i, name in enumerate(("k.cu", "outer.cuh", "inner.cuh", "other.cuh")):
        os.utime(csrc / name, (1000 + i, 1000 + i))
    os.utime(build / "libk.so", (2000, 2000))
    monkeypatch.setattr(op_builder, "CSRC", csrc)
    monkeypatch.setattr(op_builder, "BUILD_DIR", build)
    return csrc, build


def test_untouched_tree_is_not_stale(tree):
    assert op_builder.kernel_names() == ["k"]
    assert not op_builder._stale("k")


@pytest.mark.parametrize("name", ["k.cu", "outer.cuh", "inner.cuh"])
def test_newer_source_or_header_marks_library_stale(tree, name):
    csrc, _ = tree
    os.utime(csrc / name, (3000, 3000))
    assert op_builder._stale("k")


def test_header_not_included_does_not_mark_stale(tree):
    csrc, _ = tree
    os.utime(csrc / "other.cuh", (3000, 3000))
    assert not op_builder._stale("k")


def test_missing_library_is_stale(tree):
    _, build = tree
    (build / "libk.so").unlink()
    assert op_builder._stale("k")


def test_include_cycle_terminates(tree):
    csrc, _ = tree
    (csrc / "inner.cuh").write_text('#pragma once\n#include "outer.cuh"\n')
    os.utime(csrc / "inner.cuh", (1002, 1002))
    assert op_builder._headers(csrc / "k.cu", set()) == {csrc / "outer.cuh",
                                                          csrc / "inner.cuh"}
    assert not op_builder._stale("k")


def test_every_source_header_is_found_in_the_real_tree():
    """ring_flash.cu and flash_attention.cu reach the same three shared
    headers: the forward mainloop includes the wgmma primitives, so editing
    either rebuilds both libraries."""
    want = {"attention_tiles.cuh", "flash_fwd_wgmma.cuh", "hopper_tiles.cuh"}
    for src in ("ring_flash.cu", "flash_attention.cu"):
        found = {p.name for p in op_builder._headers(op_builder.CSRC / src, set())}
        assert found == want, src


def test_nvcc_flags_target_hopper_with_wgmma():
    flags = " ".join(op_builder.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-lcuda" not in flags        # the tensor-map encoder comes through the runtime
