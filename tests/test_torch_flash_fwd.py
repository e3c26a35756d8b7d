"""The Hopper attention forward's contracts that hold off the card.

The forward (``ops/csrc/flash_fwd_wgmma.cuh``, K3 through
``ops.flash_attention.flash_attention_fwd`` and K13 through
``sequence.ring_flash.ring_fwd_step``) runs only on an H100, where
``chip_smoke.py`` holds it to the plain versions. Here: CPU tensors take
the plain version without building or loading any library; the kind codes
of both ``kernel_info`` functions match the C ``Kind`` enums their
libraries index by; ``chip_phase_count.py`` still finds every line it
instruments in the forward; ``chip_compare.py`` reads both training
slices' rows from a child's output.
"""

import importlib.util
import inspect
import json
import re
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as FA
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.sequence import ring_flash as RF

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "deepspeed_tpu_torch" / "ops" / "csrc"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PHASE_COUNT = _script("chip_phase_count")
CHIP_COMPARE = _script("chip_compare")


@pytest.fixture
def no_library(monkeypatch):
    """Any build or load of a kernel library fails the test."""
    def refuse(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(op_builder, "load", refuse)
    monkeypatch.setattr(op_builder, "build", refuse)


def test_flash_fwd_on_cpu_is_the_plain_version_without_a_library(no_library):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 130, 2, 64, generator=g) for _ in range(3))
    before = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True, window=70)
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v, causal=True, window=70)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert FA.flash_attention_fwd.launches == before


def test_ring_fwd_step_on_cpu_is_the_plain_version_without_a_library(no_library):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 64, 4, 64, generator=g)
    k, v = (torch.randn(1, 64, 2, 64, generator=g) for _ in range(2))
    carry = [torch.full((1, 4, 64), RF.NEG_INF), torch.zeros(1, 4, 64), torch.zeros(1, 64, 4, 64)]
    want = [t.clone() for t in carry]
    before = RF.ring_fwd_step.launches
    RF.ring_fwd_step(q, k, v, *carry, q_off=64, k_off=32)
    RF.ring_fwd_step_plain(q, k, v, *want, q_off=64, k_off=32)
    assert all(torch.equal(a, b) for a, b in zip(carry, want))
    assert RF.ring_fwd_step.launches == before


@pytest.mark.parametrize("module, source", [(FA, "flash_attention.cu"), (RF, "ring_flash.cu")],
                         ids=["flash_attention", "ring_flash"])
def test_kernel_info_kinds_match_the_c_enum(module, source):
    """kernel_info passes kind codes that the library's Kind enum gives the
    same meaning."""
    enum = re.search(r"enum Kind \{ ([A-Z, ]+) \};", (CSRC / source).read_text()).group(1)
    assert module._KINDS == {name.strip().lower(): i for i, name in enumerate(enum.split(","))}


@pytest.mark.parametrize("module, source, entry", [
    (FA, "flash_attention.cu", "ds_flash_kernel_info"),
    (RF, "ring_flash.cu", "ds_ring_kernel_info")], ids=["flash_attention", "ring_flash"])
def test_kernel_info_calls_its_library_entry_point(module, source, entry):
    assert f'extern "C" int {entry}(int kind, int D, int* info)' in (CSRC / source).read_text()
    assert f".{entry}" in inspect.getsource(module.kernel_info)


@pytest.mark.parametrize("i", range(len(PHASE_COUNT.PATCHES)))
def test_phase_count_finds_what_it_instruments(i):
    """chip_phase_count.py patches the committed forward in order: patch i
    finds its text once the patches before it are applied."""
    text = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    for old, new in PHASE_COUNT.PATCHES[:i]:
        text = text.replace(old, new, 1)
    assert PHASE_COUNT.PATCHES[i][0] in text


def test_compare_summary_reads_both_training_slices():
    def line(**row):
        return json.dumps(row)
    step = dict(ms_per_step=1240.0, tokens_per_s=26400.0, mfu=0.47, peak_memory_gb=45.0)
    stdout = "\n".join([
        line(phase="ring_kernel_time", kernel="ring_fwd_step", case="below", ms=1.8),
        line(phase="ring_kernel_time", kernel="ring_fwd_step", case="diagonal", ms=0.9),
        "a line that is not JSON",
        line(phase="ring_train_path", launches={"ring_fwd_step": 512}, **step),
        line(phase="ring_step_profile", idle_share=0.002, device_ms_by_class={"ring_fwd": 114.0}),
        line(phase="train_kernel_time", kernel="flash_attention_fwd", case="gpt2xl_causal",
             ms=0.12, library_ms=0.09),
        line(phase="train_path", **{**step, "ms_per_step": 796.0}),
        line(phase="train_step_profile", idle_share=0.01, device_ms_by_class={"flash_fwd": 11.6}),
    ])
    assert CHIP_COMPARE.summarize(stdout) == {
        "kernels": {"ring_fwd_step": {"below": 1.8, "diagonal": 0.9},
                    "flash_attention_fwd": {"gpt2xl_causal": 0.12}},
        "ring": {**step, "idle_share": 0.002, "device_ms_by_class": {"ring_fwd": 114.0}},
        "gpt2_xl": {**step, "ms_per_step": 796.0, "idle_share": 0.01,
                    "device_ms_by_class": {"flash_fwd": 11.6}}}
