"""The port's async I/O engine and tensor swapper.

``ops/aio.py`` drives the port's own copy of the host C++ engine
(``ops/csrc/aio/deepspeed_aio.cpp``, built by g++ at first use), whose
workers bump the completion count and notify under the waiters' mutex: the
JAX copy does both outside it, so a notify can fall between a waiter's
predicate check and its sleep and the waiter sleeps forever. The stress
test runs hundreds of submit/``wait()`` cycles from more threads than
cores, each joined with a timeout, so a lost wakeup fails the test instead
of hanging the suite. Also: round trips of numpy arrays and CPU tensors
(bf16 as raw 16-bit words), per-wait error counts, the swapper's atomic
commit and rollback, and files crossing between the JAX swapper and the
port's, byte for byte.
"""

import os
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.swap_tensor.swapper import \
    AsyncTensorSwapper as JaxSwapper
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor.swapper import (AsyncTensorSwapper,
                                                             dtype_name)


def test_host_library_is_built_by_gxx_outside_the_kernel_loop():
    assert "deepspeed_aio" not in op_builder.kernel_names()
    lib = op_builder.load_host("deepspeed_aio")
    assert op_builder._lib_path("deepspeed_aio").exists()
    assert lib is op_builder.load_host("deepspeed_aio")


def test_stress_submit_wait_no_lost_wakeup(tmp_path):
    """Threads (more than cores) each run 300 cycles of four small writes
    and a ``wait()`` on their own handle, with a short switch interval to
    shake the interleavings; every thread must finish well inside the
    joins' shared 90 s budget, and every file must hold its last payload.
    (The unfixed engine left a thread waiting in 5 of 6 such runs.)"""
    n_threads = (os.cpu_count() or 1) + 2
    cycles = 300
    errors, done = [], []

    def worker(t):
        try:
            h = AsyncIOHandle(queue_depth=3, block_size=4096)
            for c in range(cycles):
                bufs = [np.full(64 + k, c * 4 + k, np.int32) for k in range(4)]
                for k, b in enumerate(bufs):
                    h.async_pwrite(b, str(tmp_path / f"t{t}_{k}.bin"))
                assert h.wait() == 0
            done.append(t)
        except Exception as e:   # noqa: BLE001 — reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 90      # one budget for every join
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(th.is_alive() for th in threads), "a wait() never returned"
    finally:
        sys.setswitchinterval(interval)
    assert not errors and sorted(done) == list(range(n_threads))
    for t in range(n_threads):
        for k in range(4):
            got = np.fromfile(tmp_path / f"t{t}_{k}.bin", np.int32)
            assert (got == (cycles - 1) * 4 + k).all()


def test_roundtrip_and_per_wait_errors(tmp_path):
    h = AsyncIOHandle()
    a = np.arange(1000, dtype=np.float32)
    t = torch.randn(7, 33).bfloat16()
    assert h.sync_pwrite(a, str(tmp_path / "a")) == 0
    assert h.sync_pwrite(t, str(tmp_path / "t")) == 0
    back = np.empty_like(a)
    tb = torch.empty_like(t)
    h.async_pread(back, str(tmp_path / "a"))
    h.async_pread(tb, str(tmp_path / "t"))
    assert h.wait() == 0 and h.inflight == 0
    np.testing.assert_array_equal(back, a)
    assert torch.equal(tb.view(torch.int16), t.view(torch.int16))
    # a failed request counts in its own wait only
    assert h.sync_pwrite(a, str(tmp_path / "missing_dir" / "x")) == 1
    assert h.sync_pwrite(a, str(tmp_path / "a")) == 0
    with pytest.raises(ValueError):
        h.async_pwrite(torch.zeros(4, 4).t(), str(tmp_path / "nc"))


def test_swapper_atomic_commit_and_rollback(tmp_path):
    s = AsyncTensorSwapper(str(tmp_path))
    first = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    s.swap_out("k", first)
    # a failing write (its staging directory is gone) rolls back: the
    # committed file and metadata stay the first tensor's
    os.rename(tmp_path, str(tmp_path) + "_gone")
    try:
        with pytest.raises(IOError, match="swap_out\\(k\\)"):
            s.swap_out("k", torch.zeros(5, dtype=torch.float32))
    finally:
        os.rename(str(tmp_path) + "_gone", tmp_path)
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    got = s.swap_in("k")
    assert got.dtype == torch.int8 and torch.equal(got, first)
    s.release("k")
    assert not (tmp_path / "k.swp").exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_files_cross_between_jax_and_port_swappers(tmp_path, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32) * 20   # in int8 range
    jx = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x.astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert dtype_name(tx.dtype) == dtype == str(jx.dtype)
    # the JAX swapper runs on the port's handle: its own engine's wait() can
    # sleep forever (the lost wakeup), and the file bytes are the swapper's
    js = JaxSwapper(str(tmp_path / "j"), AsyncIOHandle())
    ts = AsyncTensorSwapper(str(tmp_path / "t"))
    js.swap_out("a", jx)
    ts.swap_out("a", tx)
    raw = [(tmp_path / side / "a.swp").read_bytes() for side in ("j", "t")]
    assert raw[0] == raw[1]
    # each side adopts and reads the other's file
    jr = JaxSwapper(str(tmp_path / "t"), AsyncIOHandle())
    tr = AsyncTensorSwapper(str(tmp_path / "j"))
    jr.adopt("a", jx.shape, jx.dtype)
    tr.adopt("a", tuple(tx.shape), dtype)
    assert jr.swap_in("a").tobytes() == raw[0]
    got = tr.swap_in("a")
    assert got.dtype == tx.dtype
    assert bytes(got.contiguous().view(torch.uint8).numpy()) == raw[0]
