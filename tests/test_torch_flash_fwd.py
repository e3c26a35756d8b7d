"""The Hopper attention forward's contracts that hold off the card.

The forward (``ops/csrc/flash_fwd_wgmma.cuh``, K3 through
``ops.flash_attention.flash_attention_fwd``, K13 through
``sequence.ring_flash.ring_fwd_step``, K11 through
``ops.sparse_flash.sparse_flash_fwd`` and K12 through
``ops.evoformer_flash.evoformer_flash_fwd``) runs only on an H100, where
``chip_smoke.py`` holds it to the plain versions. Here: CPU tensors take
the plain version without building or loading any library; the kind codes
of the four ``kernel_info`` functions match the C ``Kind`` enums their
libraries index by; ``chip_phase_count.py`` still finds every line it
instruments in the forward and the backward; ``chip_compare.py`` reads both training
slices' rows from a child's output.
"""

import importlib.util
import inspect
import json
import re
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch.ops import evoformer_flash as EF
from deepspeed_tpu_torch.ops import flash_attention as FA
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import sparse_flash as SF
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


@pytest.mark.parametrize("module, source", [(FA, "flash_attention.cu"), (RF, "ring_flash.cu"),
                                            (SF, "sparse_flash.cu"), (EF, "evoformer_flash.cu")],
                         ids=["flash_attention", "ring_flash", "sparse_flash", "evoformer_flash"])
def test_kernel_info_kinds_match_the_c_enum(module, source):
    """kernel_info passes kind codes that the library's Kind enum gives the
    same meaning."""
    enum = re.search(r"enum Kind \{ ([A-Z, ]+) \};", (CSRC / source).read_text()).group(1)
    assert module._KINDS == {name.strip().lower(): i for i, name in enumerate(enum.split(","))}


@pytest.mark.parametrize("module, source, entry", [
    (FA, "flash_attention.cu", "ds_flash_kernel_info"),
    (RF, "ring_flash.cu", "ds_ring_kernel_info"),
    (SF, "sparse_flash.cu", "ds_sparse_kernel_info"),
    (EF, "evoformer_flash.cu", "ds_evoformer_kernel_info")],
    ids=["flash_attention", "ring_flash", "sparse_flash", "evoformer_flash"])
def test_kernel_info_calls_its_library_entry_point(module, source, entry):
    assert f'extern "C" int {entry}(int kind, int D, int* info)' in (CSRC / source).read_text()
    assert f".{entry}" in inspect.getsource(module.kernel_info)


@pytest.mark.parametrize("i", [*range(len(PHASE_COUNT.PATCHES)),
                               *(f"bwd-{j}" for j in range(len(PHASE_COUNT.BWD_PATCHES)))])
def test_phase_count_finds_what_it_instruments(i):
    """chip_phase_count.py patches the committed forward (cases 0, 1, ...)
    and backward ("bwd-0", ...) in order: patch i finds its text once the
    patches before it are applied, the backward's in the mainloop it names,
    and the whole list applies."""
    if isinstance(i, int):
        text = (CSRC / "flash_fwd_wgmma.cuh").read_text()
        for old, new in PHASE_COUNT.PATCHES[:i]:
            text = text.replace(old, new, 1)
        assert PHASE_COUNT.PATCHES[i][0] in text
        return
    j = int(i.split("-")[1])
    text = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    cut = text.index(PHASE_COUNT.BWD_SPLIT)
    parts = {"dq": text[:cut], "dkv": text[cut:]}
    for loop, old, new in PHASE_COUNT.BWD_PATCHES[:j]:
        parts[loop] = parts[loop].replace(old, new, 1)
    loop, old, _ = PHASE_COUNT.BWD_PATCHES[j]
    assert old in parts[loop]
    assert PHASE_COUNT.patch_backward(text) is not None


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
        line(phase="train_kernel_time", kernel="flash_attention_dq", case="gpt2xl_causal",
             ms=0.2, library_ms=0.34),
        line(phase="train_path", **{**step, "ms_per_step": 796.0}),
        line(phase="train_step_profile", idle_share=0.01, device_ms_by_class={"flash_fwd": 11.6}),
    ])
    assert CHIP_COMPARE.summarize(stdout) == {
        "kernels": {"ring_fwd_step": {"below": 1.8, "diagonal": 0.9},
                    "flash_attention_fwd": {"gpt2xl_causal": 0.12},
                    "flash_attention_dq": {"gpt2xl_causal": 0.2}},
        "library": {"flash_attention_fwd": {"gpt2xl_causal": 0.09},
                    "flash_attention_dq": {"gpt2xl_causal": 0.34}},
        "serving": {},
        "ring": {**step, "idle_share": 0.002, "device_ms_by_class": {"ring_fwd": 114.0}},
        "gpt2_xl": {**step, "ms_per_step": 796.0, "idle_share": 0.01,
                    "device_ms_by_class": {"flash_fwd": 11.6}}}


def test_compare_summary_reads_the_ops_kernel_rows():
    """K11 per layout and K12 come through as kernels with their SDPA times."""
    stdout = "\n".join(json.dumps(row) for row in (
        dict(phase="ops_kernel_time", kernel="sparse_flash_fwd", case="fixed", ms=0.25,
             library_ms=1.05),
        dict(phase="ops_kernel_time", kernel="evoformer_flash_fwd", case="main_path", ms=0.18,
             library_ms=0.24)))
    got = CHIP_COMPARE.summarize(stdout)
    assert got["kernels"] == {"sparse_flash_fwd": {"fixed": 0.25},
                              "evoformer_flash_fwd": {"main_path": 0.18}}
    assert got["library"] == {"sparse_flash_fwd": {"fixed": 1.05},
                              "evoformer_flash_fwd": {"main_path": 0.24}}


def test_compare_summary_reads_the_serving_and_v1_rows():
    """K1 and the serving run, K6 by projection / bits / M and K2 by case
    come through, each kernel with its library call beside it."""
    stdout = "\n".join(json.dumps(row) for row in (
        dict(phase="kernel_time", kernel="paged_attention", case="decode", ms=0.27,
             library_ms=1.54),
        dict(phase="main_path", tokens_per_s=93.6, serve_s=2.7, peak_memory_gb=21.3, steps=56),
        dict(phase="step_profile", step="decode", wall_ms=20.7, device_busy_ms=17.0,
             idle_share=0.18, device_ms_by_class={"paged_attention": 8.5}),
        dict(phase="woq_kernel_time", kernel="woq_matmul", case="gate/int8/M4", ms=0.036,
             event_ms=0.04, library_ms=0.045),
        dict(phase="v1_kernel_time", kernel="fused_decode_attention", case="main", ms=0.052,
             library_ms=0.058)))
    got = CHIP_COMPARE.summarize(stdout)
    assert got["kernels"] == {"paged_attention": {"decode": 0.27},
                              "woq_matmul": {"gate/int8/M4": 0.036},
                              "fused_decode_attention": {"main": 0.052}}
    assert got["library"] == {"paged_attention": {"decode": 1.54},
                              "woq_matmul": {"gate/int8/M4": 0.045},
                              "fused_decode_attention": {"main": 0.058}}
    assert got["serving"] == {"tokens_per_s": 93.6, "serve_s": 2.7, "peak_memory_gb": 21.3,
                              "decode_step": {"wall_ms": 20.7, "device_busy_ms": 17.0,
                                              "idle_share": 0.18}}
