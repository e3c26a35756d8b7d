"""The Hopper attention backward's contracts that hold off the card.

The backward (``ops/csrc/flash_bwd_wgmma.cuh``: K4 / K5 through
``ops.flash_attention.flash_attention_dq`` / ``flash_attention_dkv`` in mode
FLASH, K14 / K15 through ``sequence.ring_flash.ring_dq_step`` /
``ring_dkv_step`` in mode RING) runs only on an H100, where
``chip_smoke.py`` holds it to the plain versions. Here: CPU tensors take
the plain backward without building or loading any library and count no
launch; the kind codes of both ``kernel_info`` functions match the C
``Kind`` enums, which the two libraries share; the build sees the shared
header as a source of both libraries, so an edit to it rebuilds both.
``tests/test_torch_flash_fwd.py`` checks that ``chip_phase_count.py`` still
finds every line it instruments in the forward and the backward.
"""

import os
import re
import shutil
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as FA
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.sequence import ring_flash as RF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "deepspeed_tpu_torch" / "ops" / "csrc"
HEADER = "flash_bwd_wgmma.cuh"


@pytest.fixture
def no_library(monkeypatch):
    """Any build or load of a kernel library fails the test."""
    def refuse(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(op_builder, "load", refuse)
    monkeypatch.setattr(op_builder, "build", refuse)


def _bwd_inputs(seed, s=130, h=4, kvh=2, d=64):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(2, s, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(2, s, kvh, d, generator=g) for _ in range(2))
    lse = torch.randn(2, h, s, generator=g).abs() + 3.0
    delta = torch.randn(2, h, s, generator=g) * 0.1
    return q, k, v, do, lse, delta


SEGMENTS = (torch.arange(130) // 50).to(torch.int32).repeat(2, 1)   # three packed documents
MASKS = {"window": dict(causal=True, window=70), "noncausal": dict(causal=False),
         "alibi_segments": dict(causal=True, segment_ids=SEGMENTS,
                                alibi_slopes=torch.tensor([0.5, 0.25, 0.1, 0.05]))}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_flash_bwd_on_cpu_is_the_plain_version_without_a_library(no_library, mask):
    kw = MASKS[mask]
    q, k, v, do, lse, delta = _bwd_inputs(3)
    before = (FA.flash_attention_dq.launches, FA.flash_attention_dkv.launches)
    dq = FA.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    assert (FA.flash_attention_dq.launches, FA.flash_attention_dkv.launches) == before


def test_ring_bwd_step_on_cpu_is_the_plain_version_without_a_library(no_library):
    q, k, v, do, lse, delta = _bwd_inputs(4, s=64)
    kw = dict(q_off=128, k_off=64, window=100)
    acc = [torch.full_like(q, 0.5), torch.full_like(k, -0.25), torch.full_like(v, 0.125)]
    want = [t.clone() for t in acc]
    before = (RF.ring_dq_step.launches, RF.ring_dkv_step.launches)
    RF.ring_dq_step(q, k, v, do, lse, delta, acc[0], **kw)
    RF.ring_dkv_step(q, k, v, do, lse, delta, acc[1], acc[2], **kw)
    RF.ring_bwd_step_plain(q, k, v, do, lse, delta, *want, **kw)
    assert all(torch.equal(a, b) for a, b in zip(acc, want))
    assert (RF.ring_dq_step.launches, RF.ring_dkv_step.launches) == before


def _kind_enum(source):
    text = (CSRC / source).read_text()
    names = re.search(r"enum Kind \{ ([A-Z, ]+) \};", text).group(1)
    return {name.strip().lower(): i for i, name in enumerate(names.split(","))}


def test_kind_enums_of_both_libraries_match_kernel_info():
    """Both libraries number fwd, dq and dkv alike, as both wrappers'
    kernel_info pass them; the shared forward header's modes are RING and
    FLASH, then the block-sparse and Evoformer forwards' SPARSE and EVO, then
    paged attention's PAGED."""
    assert _kind_enum("flash_attention.cu") == _kind_enum("ring_flash.cu") == FA._KINDS \
        == RF._KINDS == {"fwd": 0, "dq": 1, "dkv": 2}
    fwd = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    assert "enum Mode { RING, FLASH, SPARSE, EVO, PAGED };" in fwd
    bwd = (CSRC / HEADER).read_text()
    for source, mode in (("flash_attention.cu", "FLASH"), ("ring_flash.cu", "RING")):
        text = (CSRC / source).read_text()
        assert f'#include "{HEADER}"' in text
        assert re.search(rf"backward_dq<D, (flash_bwd::)?{mode}, ", text), source
        assert re.search(rf"backward_dkv<D, (flash_bwd::)?{mode}, ", text), source
    assert "void backward_dq(" in bwd and "void backward_dkv(" in bwd


@pytest.mark.parametrize("lib", ["flash_attention", "ring_flash"])
def test_header_edit_marks_both_libraries_stale(tmp_path, monkeypatch, lib):
    """op_builder counts the shared backward header among the sources of
    both libraries: a library built after every source is reused, and one
    built before an edit of the header is rebuilt. A library that does not
    include it (fused_adam) is not."""
    src = tmp_path / "csrc"
    shutil.copytree(CSRC, src)
    monkeypatch.setattr(op_builder, "CSRC", src)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    assert src / HEADER in op_builder._headers(src / f"{lib}.cu", set())
    assert src / HEADER not in op_builder._headers(src / "fused_adam.cu", set())
    (tmp_path / "build").mkdir()
    now = max(p.stat().st_mtime for p in src.iterdir())
    for name in (lib, "fused_adam"):
        built = tmp_path / "build" / f"lib{name}.so"
        built.write_bytes(b"")
        os.utime(built, (now + 10, now + 10))
    assert not op_builder._stale(lib) and not op_builder._stale("fused_adam")
    os.utime(src / HEADER, (now + 20, now + 20))     # the header is edited
    assert op_builder._stale(lib) and not op_builder._stale("fused_adam")
