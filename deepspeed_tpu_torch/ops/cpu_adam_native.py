"""ctypes surface of the host Adam / Adagrad / Lion kernels.

Mirrors ``deepspeed_tpu/ops/cpu_adam_native.py`` over the port's own copy
of the host C++ (``csrc/adam/cpu_adam.cpp``), built by ``g++`` at first use
with the JAX package's flags (``op_builder.load_host``). Where the JAX
functions take numpy arrays, these take contiguous f32 CPU tensors and
update them in place.

The C loops are element-wise and single-threaded (``#pragma omp simd``
only), so a call splits its buffers into runs of whole 1024-element blocks
and updates them on ``threads`` threads at once (ctypes releases the GIL
around each C call; default ``torch.get_num_threads()``). Every element
takes the same arithmetic whatever the split, so any thread count gives
the bits of one call over the whole buffer.
"""

import ctypes
import math
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import op_builder

BLOCK = 1024              # runs start on whole blocks: the same vector path as one call
MIN_RUN = 1 << 20         # elements a thread takes at least

_lib = None
_pool = {"threads": 0, "executor": None}    # the threads the runs share, grown on demand
_pool_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        lib = op_builder.load_host("cpu_adam")
        p, i64, f, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
        lib.ds_cpu_adam_step.argtypes = [p, p, p, p, i64, i64, f, f, f, f, f, i, i]
        lib.ds_cpu_adagrad_step.argtypes = [p, p, p, i64, f, f, f]
        lib.ds_cpu_lion_step.argtypes = [p, p, p, i64, f, f, f, f]
        for fn in (lib.ds_cpu_adam_step, lib.ds_cpu_adagrad_step, lib.ds_cpu_lion_step):
            fn.restype = None
        _lib = lib
    return _lib


def _check(name, t, n):
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        raise ValueError(f"host optimizer: {name} must be a CPU tensor")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"host optimizer: {name} must be contiguous float32, got {t.dtype}")
    if t.numel() != n:
        raise ValueError(f"host optimizer: {name} has {t.numel()} elements, expected {n}")


def _runs(n, threads):
    """(start, length) runs covering ``n`` elements, one a thread, each but
    the last a whole number of blocks."""
    k = max(1, min(threads, math.ceil(n / MIN_RUN)))
    size = math.ceil(math.ceil(n / k) / BLOCK) * BLOCK
    return [(s, min(size, n - s)) for s in range(0, n, size)] or [(0, 0)]


def _executor(n):
    """A thread pool of at least ``n`` threads."""
    with _pool_lock:
        if _pool["threads"] < n:
            if _pool["executor"] is not None:
                _pool["executor"].shutdown(wait=False)
            _pool.update(threads=n, executor=ThreadPoolExecutor(n, thread_name_prefix="host_adam"))
        return _pool["executor"]


def _launch(fn, buffers, scalars, threads):
    """``fn(*pointers, count, *scalars)`` over runs of the buffers on
    ``threads`` threads."""
    n = buffers[0].numel()
    threads = torch.get_num_threads() if threads is None else int(threads)
    runs = _runs(n, threads)
    ptrs = [b.data_ptr() for b in buffers]

    def one(run):
        start, count = run
        fn(*[p + 4 * start for p in ptrs], count, *scalars)

    if len(runs) == 1:
        one(runs[0])
        return
    list(_executor(len(runs)).map(one, runs))


def cpu_adam_step(params, grads, exp_avg, exp_avg_sq, step: int, lr: float,
                  betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                  adamw_mode: bool = True, bias_correction: bool = True, threads=None):
    """In-place AdamW update of host f32 buffers (``ds_cpu_adam_step``)."""
    n = params.numel()
    for name, t in (("params", params), ("grads", grads), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        _check(name, t, n)
    _launch(_get_lib().ds_cpu_adam_step, (params, grads, exp_avg, exp_avg_sq),
            (int(step), lr, betas[0], betas[1], eps, weight_decay, int(adamw_mode),
             int(bias_correction)), threads)


def cpu_adagrad_step(params, grads, exp_avg_sq, lr, eps=1e-10, weight_decay=0.0, threads=None):
    n = params.numel()
    for name, t in (("params", params), ("grads", grads), ("exp_avg_sq", exp_avg_sq)):
        _check(name, t, n)
    _launch(_get_lib().ds_cpu_adagrad_step, (params, grads, exp_avg_sq),
            (lr, eps, weight_decay), threads)


def cpu_lion_step(params, grads, exp_avg, lr, betas=(0.9, 0.99), weight_decay=0.0,
                  threads=None):
    n = params.numel()
    for name, t in (("params", params), ("grads", grads), ("exp_avg", exp_avg)):
        _check(name, t, n)
    _launch(_get_lib().ds_cpu_lion_step, (params, grads, exp_avg),
            (lr, betas[0], betas[1], weight_decay), threads)
