"""Python surface of the async I/O engine.

Mirrors ``deepspeed_tpu/ops/aio.py``: submit async reads and writes of host
buffers against files, then wait for completion. The engine is the port's
own copy of the host C++ (``csrc/aio/deepspeed_aio.cpp``, with its
lost-wakeup fix), built by ``g++`` at first use (``op_builder.load_host``).
Buffers are C-contiguous numpy arrays or CPU torch tensors (a tensor is
moved as its raw bytes, so a bf16 tensor needs no float conversion). The
handle keeps every submitted buffer alive until ``wait()``.

``wait()`` returns the errors of the requests it waited for; the JAX
handle returns the handle's running total, so there one failed write makes
every later ``wait()`` report an error.
"""

import ctypes
from typing import List

import numpy as np
import torch

from . import op_builder

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = op_builder.load_host("deepspeed_aio")   # serialized across threads
        lib.ds_aio_handle_new.restype = ctypes.c_void_p
        lib.ds_aio_handle_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ds_aio_handle_free.argtypes = [ctypes.c_void_p]
        for fn in ("ds_aio_pread", "ds_aio_pwrite"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p]
        lib.ds_aio_error_count.restype = ctypes.c_int64
        lib.ds_aio_error_count.argtypes = [ctypes.c_void_p]
        lib.ds_aio_inflight.restype = ctypes.c_int64
        lib.ds_aio_inflight.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def host_bytes(buf) -> np.ndarray:
    """A C-contiguous numpy view of a host buffer's bytes (no copy): numpy
    arrays as they are, CPU torch tensors through ``numpy()`` of an integer
    view of the same width (numpy has no bfloat16)."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError("aio buffers must be host tensors")
        if not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous")
        if buf.dtype in (torch.bfloat16, torch.float16):
            buf = buf.view(torch.int16)
        buf = buf.numpy()
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return buf


class AsyncIOHandle:
    """Thread-pooled positional I/O handle (reference aio_handle)."""

    def __init__(self, queue_depth: int = 8, block_size: int = 1 << 20):
        self._lib = _get_lib()
        self._h = self._lib.ds_aio_handle_new(queue_depth, block_size)
        self._pinned: List = []   # buffers in flight, released by wait()
        self._errors_seen = 0

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ds_aio_wait(self._h)
                self._lib.ds_aio_handle_free(self._h)
                self._h = None
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass

    def _submit(self, fn, buf, path: str, offset: int) -> int:
        arr = host_bytes(buf)
        self._pinned.append((buf, arr))
        return fn(self._h, path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
                  arr.nbytes, offset)

    def async_pwrite(self, buf, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pwrite, buf, path, offset)

    def async_pread(self, buf, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pread, buf, path, offset)

    def wait(self) -> int:
        """Block until every submitted request has finished; returns how
        many of them failed."""
        self._lib.ds_aio_wait(self._h)
        total = int(self._lib.ds_aio_error_count(self._h))
        errs, self._errors_seen = total - self._errors_seen, total
        self._pinned.clear()
        return errs

    def sync_pwrite(self, buf, path: str, offset: int = 0) -> int:
        self.async_pwrite(buf, path, offset)
        return self.wait()

    def sync_pread(self, buf, path: str, offset: int = 0) -> int:
        self.async_pread(buf, path, offset)
        return self.wait()

    @property
    def inflight(self) -> int:
        return int(self._lib.ds_aio_inflight(self._h))
