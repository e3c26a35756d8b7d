"""Tensor swapping to files through the async I/O engine.

Mirrors ``AsyncTensorSwapper`` and ``OptimizerSwapper`` of
``deepspeed_tpu/runtime/swap_tensor/swapper.py``: host tensors swap out to
files through the port's aio engine (``ops/aio.py``) and swap back in; an
optimizer state tree swaps out leaf by leaf (``opt_<i>``, in the tree's
sorted-key order) and back in as the same tree.

A file holds a tensor's raw bytes, as the JAX swapper writes them: a bf16
tensor goes to disk as its 16-bit words and comes back through a view, so
neither side needs ``ml_dtypes`` and files cross between the two packages
byte for byte. Dtypes are named as the JAX package names them
(``dtype_name``: "bfloat16", "float32", "int8").
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

from ...ops.aio import AsyncIOHandle
from ...utils.tree import tree_from_paths, tree_paths


def dtype_name(dtype) -> str:
    """A torch or numpy dtype by its JAX/numpy name (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``dtype_name``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


class AsyncTensorSwapper:
    """Swap individual tensors to files, asynchronously.

    Writes are ATOMIC per key: ``swap_out`` streams into ``<key>.swp.tmp``
    and only an error-free ``wait`` renames it over ``<key>.swp``, so an aio
    error never leaves a truncated ``.swp`` behind. On failure the temp file
    is removed, the key's previous metadata (and previous ``.swp``, if one
    existed) is kept, and the raised error names the keys whose writes were
    in flight."""

    def __init__(self, swap_dir: str, aio_handle: Optional[AsyncIOHandle] = None):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.aio = aio_handle or AsyncIOHandle()
        self._meta: Dict[str, tuple] = {}          # key -> (shape, dtype name)
        # key -> (tmp_path, previous meta or None): writes pending rename
        self._pending: Dict[str, tuple] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key}.swp")

    def swap_out(self, key: str, arr, async_op: bool = False):
        """Write a host tensor (or numpy array) to ``key``'s file; the aio
        handle holds the buffer until the write is waited for."""
        host = arr.contiguous() if isinstance(arr, torch.Tensor) \
            else np.ascontiguousarray(arr)
        tmp = self._path(key) + ".tmp"
        if key in self._pending:
            # re-swap of a key whose previous write hasn't committed yet:
            # the rollback target stays the last COMMITTED state
            _tmp, prev = self._pending[key]
        else:
            prev = self._meta.get(key)
        self._pending[key] = (tmp, prev)
        self._meta[key] = (tuple(host.shape), dtype_name(host.dtype))
        self.aio.async_pwrite(host, tmp)
        if not async_op:
            self.wait()

    def swap_in(self, key: str, async_op: bool = False) -> torch.Tensor:
        """Read ``key`` back as a host tensor of the shape and dtype it was
        written with."""
        if self._pending:
            # the shared aio queue may hold un-finalized swap-out writes:
            # finalize (or roll back) them first, so their errors are not
            # eaten by this read's wait
            self.wait()
        shape, name = self._meta[key]
        buf = torch.empty(shape, dtype=torch_dtype(name))
        self.aio.async_pread(buf, self._path(key))
        if not async_op:
            errs = self.aio.wait()
            if errs:
                raise IOError(f"swap_in({key}): {errs} aio errors")
        return buf

    def wait(self):
        """Drain the aio queue and finalize pending swap-outs: error-free
        writes rename ``.swp.tmp`` -> ``.swp`` atomically; on any error every
        pending write is rolled back (temp removed, previous metadata
        restored) and the raise names the affected keys."""
        errs = self.aio.wait()
        if not self._pending:
            return errs
        pending, self._pending = self._pending, {}
        if errs:
            for key, (tmp, prev_meta) in pending.items():
                if prev_meta is None:
                    self._meta.pop(key, None)
                else:
                    self._meta[key] = prev_meta
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            keys = ", ".join(sorted(pending))
            raise IOError(
                f"swap_out({keys}): {errs} aio errors (partial .swp.tmp "
                "files removed; previous .swp contents intact)")
        for key, (tmp, _prev) in pending.items():
            os.replace(tmp, self._path(key))
        return errs

    def adopt(self, key: str, shape, dtype) -> None:
        """Register metadata for a key whose committed ``.swp`` file was
        written by ANOTHER swapper instance (a process that died, or the
        JAX package). ``dtype``: a ``dtype_name`` or a dtype. No-op when
        the key is already tracked."""
        if key in self._meta:
            return
        if not os.path.exists(self._path(key)):
            raise FileNotFoundError(f"adopt({key}): no committed {self._path(key)}")
        name = dtype if isinstance(dtype, str) else dtype_name(dtype)
        self._meta[key] = (tuple(shape), name)

    def release(self, key: str):
        """Delete a key's committed file and metadata, after draining the
        aio queue when any write is still pending (a queued write would
        otherwise recreate the removed staging file)."""
        try:
            if self._pending:
                self.wait()
        finally:
            self._meta.pop(key, None)
            pend = self._pending.pop(key, None)
            for path in ([pend[0]] if pend else []) + [self._path(key)]:
                try:
                    os.remove(path)
                except OSError:
                    pass


class OptimizerSwapper:
    """Whole-tree swapping of an optimizer state (the JAX
    ``OptimizerSwapper``): ``swap_out_optimizer`` writes every leaf of
    ``{"step", "slots"}`` (host tensors; a Python int, the step, travels
    as a 0-d int64 tensor and comes back an int) and ``swap_in_optimizer``
    reads them back as the tree."""

    def __init__(self, swap_dir: str, aio_handle: Optional[AsyncIOHandle] = None):
        self.swapper = AsyncTensorSwapper(swap_dir, aio_handle)
        self._paths = None
        self._ints = set()
        self._resident = None

    def swap_out_optimizer(self, opt_state, async_op: bool = False):
        pairs = tree_paths(opt_state)
        self._paths = [p for p, _ in pairs]
        self._ints = set()
        for i, (_, leaf) in enumerate(pairs):
            if isinstance(leaf, int):
                self._ints.add(i)
                leaf = torch.tensor(leaf, dtype=torch.int64)
            self.swapper.swap_out(f"opt_{i}", leaf.detach().cpu(), async_op=True)
        if not async_op:
            self.swapper.wait()
        self._resident = False
        return len(pairs)

    def swap_in_optimizer(self):
        if self._paths is None:
            raise RuntimeError("swap_in_optimizer before swap_out_optimizer")
        bufs = [self.swapper.swap_in(f"opt_{i}", async_op=True)
                for i in range(len(self._paths))]
        errs = self.swapper.aio.wait()
        if errs:
            raise IOError(f"optimizer swap_in: {errs} aio errors")
        self._resident = True
        return tree_from_paths((p, int(b) if i in self._ints else b)
                               for i, (p, b) in enumerate(zip(self._paths, bufs)))
