"""ZeRO-Offload host optimizer: the host Adam in the engine loop.

Mirrors ``deepspeed_tpu/runtime/zero/offload_host.py``. The engine
accumulates the f32 gradients on the card and cuts them to the optimizer
layout (``ZeroPartition.reduce_grads``); this class owns the f32 master
weights and the Adam moments of **this rank's** optimizer-layout shards as
host tensors and updates them with the host kernel (``ops/cpu_adam_native``
over ``csrc/adam/cpu_adam.cpp``, the JAX package's source and flags).

Where JAX fetches each leaf's local shard whole (``copy_to_host_async``),
the port streams each host-bound gradient in runs of ``CHUNK`` elements
through two pinned host buffers: the copy of run i + 1 card -> host runs on
a side stream while the host updates run i, and each updated run of the
master goes back into the card's parameter (``out``) at once. So the host
holds the masters and moments (12 bytes an element) and two runs, not a
second copy of the gradients. On the CPU the gradients are host tensors and
the update reads them where they lie.

The state is ``{"step", "slots": {m, v, master}}`` at ``state_dict()``, the
device optimizers' layout, with ``None`` for the leaves Twin-Flow keeps on
the card; the slots are this rank's shards (the engine gathers them for a
universal checkpoint and cuts them back at load).
"""

import math
import time
from typing import Any, Dict, Optional

import torch

from ...ops.cpu_adam_native import cpu_adam_step
from ...utils.tree import tree_from_paths, tree_paths

NOT_PORTED = "is not ported yet (ROADMAP.md section A, item 16)"
CHUNK = 1 << 26          # elements a staging run holds (256 MB of f32)


def _get(tree, path):
    """The node at a dotted path of a nested dict, or None."""
    for k in path.split("."):
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


class _KernelAdam:
    """{m, v} slots; ``ds_cpu_adam_step`` (JAX ``_KernelAdam`` over
    ``_HostAdam``: bias-corrected AdamW with the optimizer's lr, betas, eps
    and weight decay)."""

    fields = ("m", "v")

    def __init__(self, hyper, threads=None):
        self.lr = float(hyper.get("lr", 1e-3))
        self.betas = tuple(hyper.get("betas", (0.9, 0.999)))
        self.eps = float(hyper.get("eps", 1e-8))
        self.weight_decay = float(hyper.get("weight_decay", 0.0))
        self.threads = threads

    def step(self, master, g, slots, step_num, lr):
        cpu_adam_step(master, g, slots["m"], slots["v"], step_num,
                      lr if lr is not None else self.lr, self.betas, self.eps,
                      self.weight_decay, threads=self.threads)


_HOST_KERNELS = {"adam": _KernelAdam, "adamw": _KernelAdam, "cpu_adam": _KernelAdam}


def build_host_kernel(name: str, hyper, threads=None):
    key = name.lower().replace("-", "_")
    if key not in _HOST_KERNELS:
        raise NotImplementedError(f"the host optimizer for {name!r} under offload {NOT_PORTED}; "
                                  f"offload runs {sorted(_HOST_KERNELS)}")
    return _HOST_KERNELS[key](hyper, threads)


class HostOffloadOptimizer:
    """f32 masters and moments of this rank's shards on the host, updated by
    the host Adam."""

    def __init__(self, hyper: Dict[str, Any], param_tree, *, gradient_clipping: float = 0.0,
                 optimizer_name: str = "adam", pin_memory: bool = False, threads=None,
                 world_size: int = 1):
        """``param_tree``: the rank's optimizer-layout parameter tensors (on
        the card or the CPU); ``None`` leaves stay on the card (Twin-Flow).
        The masters of leaves on the card are page-locked (their runs go
        back to the card asynchronously, under the host Adam of the next
        run); ``pin_memory`` page-locks the moments too. ``threads``: the
        host Adam's threads (default ``torch.get_num_threads()``)."""
        self.kernel = build_host_kernel(optimizer_name, hyper, threads)
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.world_size = world_size
        pin = bool(pin_memory) and torch.cuda.is_available()

        def slot(p):
            if p is None:
                return None
            master = torch.empty(p.shape, dtype=torch.float32,
                                 pin_memory=pin or p.device.type == "cuda")
            master.copy_(p.detach())
            return {"master": master, **{f: torch.zeros(p.shape, dtype=torch.float32,
                                                        pin_memory=pin)
                                         for f in self.kernel.fields}}

        # dotted path -> {master, m, v} of the rank's shard, or None (the card's)
        self._slots = {path: slot(p) for path, p in tree_paths(param_tree)}
        self._step = 0
        self._staging = None       # two pinned runs, made at the first card step
        self._d2h = None           # the side stream of the card -> host copies
        self.stats = {}

    # ---- the update ----

    def step(self, grads, *, grad_divisor: float = 1.0, lr: Optional[float] = None,
             grad_norm_sq: Optional[float] = None, out=None):
        """Update the masters in place from ``grads`` (the optimizer-layout
        gradients, summed over the group, loss-scaled and not divided;
        ``None`` where the card keeps the leaf), and copy each updated
        master into ``out``'s leaf (the card's parameter in that layout)
        where ``out`` is given. Returns the masters (``params()``).

        ``grad_divisor`` folds the loss scale and the accumulation count
        into the clipping pass; ``grad_norm_sq`` is the unscaled global
        gradient norm squared, which the engine computes on the card over
        the group (without it, clipping takes this process's own norm,
        right only in a world of one)."""
        self._step += 1
        scale = 1.0 / grad_divisor
        jobs = []
        got = dict(tree_paths(grads))
        for path, s in self._slots.items():
            if s is None:
                continue
            g = got.get(path)
            if g is None or tuple(g.shape) != tuple(s["master"].shape):
                raise ValueError(f"gradient of {path} does not match its host shard "
                                 f"{tuple(s['master'].shape)}")
            jobs.append((path, s, g.reshape(-1)))
        if self.gradient_clipping > 0.0:
            if grad_norm_sq is None:
                if self.world_size > 1:
                    raise ValueError("host offload over several ranks needs the global "
                                     "gradient norm (grad_norm_sq) from the card")
                grad_norm_sq = sum(float(torch.dot(g.float(), g.float()))
                                   for _, _, g in jobs) * scale * scale
            gnorm = math.sqrt(grad_norm_sq)
            scale *= min(1.0, self.gradient_clipping / (gnorm + 1e-6))
        outs = dict(tree_paths(out)) if out is not None else {}
        self.stats = {"adam_s": 0.0, "d2h_bytes": 0, "h2d_bytes": 0, "d2h_wait_s": 0.0}
        on_card = any(g.device.type == "cuda" for _, _, g in jobs)
        if on_card:
            self._stream_step(jobs, scale, lr, outs)
        else:
            for path, s, g in jobs:
                gh = g * scale if scale != 1.0 else g.contiguous()
                self._update(s, gh, 0, g.numel(), lr)
                if path in outs:
                    outs[path].copy_(s["master"])
        return self.params()

    def _update(self, s, gh, start, count, lr):
        t0 = time.perf_counter()
        run = {f: s[f].view(-1)[start:start + count] for f in ("master",) + self.kernel.fields}
        self.kernel.step(run["master"], gh, run, self._step, lr)
        self.stats["adam_s"] += time.perf_counter() - t0

    def _stream_step(self, jobs, scale, lr, outs):
        """Runs of each gradient card -> pinned host buffer on a side stream,
        one run ahead of the host update; each updated run of the master
        back into the card's parameter on the current stream."""
        dev = jobs[0][2].device
        cur = torch.cuda.current_stream(dev)
        if self._staging is None:
            n = min(CHUNK, max(g.numel() for _, _, g in jobs))
            self._staging = [torch.empty(n, dtype=torch.float32, pin_memory=True)
                             for _ in range(2)]
            self._d2h = torch.cuda.Stream(dev)
        n = self._staging[0].numel()
        runs = [(s, g, path, a, min(n, g.numel() - a))
                for path, s, g in jobs for a in range(0, g.numel(), n)]
        self._d2h.wait_stream(cur)
        copies = []

        def fetch(i):
            s, g, _, a, c = runs[i]
            buf = self._staging[i % 2]
            with torch.cuda.stream(self._d2h):
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                buf[:c].copy_(g[a:a + c], non_blocking=True)
                t1.record()
            copies.append(("d2h", t0, t1))
            self.stats["d2h_bytes"] += 4 * c
            return t1

        ready = fetch(0)
        for i, (s, g, path, a, c) in enumerate(runs):
            t0 = time.perf_counter()
            ready.synchronize()
            self.stats["d2h_wait_s"] += time.perf_counter() - t0
            if i + 1 < len(runs):
                nxt = fetch(i + 1)
            gh = self._staging[i % 2][:c]
            if scale != 1.0:
                gh.mul_(scale)
            self._update(s, gh, a, c, lr)
            if path in outs:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record(cur)
                outs[path].view(-1)[a:a + c].copy_(s["master"].view(-1)[a:a + c],
                                                   non_blocking=True)
                e1.record(cur)
                copies.append(("h2d", e0, e1))
                self.stats["h2d_bytes"] += 4 * c
            if i + 1 < len(runs):
                ready = nxt
        cur.wait_stream(self._d2h)
        cur.synchronize()
        for kind, e0, e1 in copies:
            key = f"{kind}_s"
            self.stats[key] = self.stats.get(key, 0.0) + e0.elapsed_time(e1) / 1e3

    # ---- state ----

    def reset_masters(self, param_tree):
        """Overwrite the masters from new weights in the optimizer layout
        (moments kept): the sync after weights are loaded outside the
        checkpoint path, since every update starts from the masters."""
        got = dict(tree_paths(param_tree))
        for path, s in self._slots.items():
            if s is None:
                continue
            p = got.get(path)
            if p is None or tuple(p.shape) != tuple(s["master"].shape):
                raise ValueError(f"{path}: no parameter of the host shard's shape "
                                 f"{tuple(s['master'].shape)}")
            s["master"].copy_(p.detach())

    def params(self):
        """The masters (host f32), ``None`` where the card keeps the leaf."""
        return tree_from_paths((path, None if s is None else s["master"])
                               for path, s in self._slots.items())

    def local_element_count(self) -> int:
        """Optimizer-state elements this process holds (x3 for master, m, v)."""
        return sum(s["master"].numel() for s in self._slots.values() if s is not None)

    def state_dict(self):
        """``{"step", "slots": {m, v, master}}`` of this rank's shards: the
        host tensors themselves (no copy)."""
        return {"step": self._step, "slots": tree_from_paths(
            (path, None if s is None else {f: s[f] for f in ("master",) + self.kernel.fields})
            for path, s in self._slots.items())}

    def abstract_state_dict(self):
        """``state_dict()``'s tree with (shape, dtype) leaves."""
        return {"step": self._step, "slots": tree_from_paths(
            (path, None if s is None else {f: (tuple(s[f].shape), s[f].dtype)
                                           for f in ("master",) + self.kernel.fields})
            for path, s in self._slots.items())}

    def load_state_dict(self, sd):
        """Copy a ``state_dict()`` of this rank's shards in; a leaf this
        optimizer hosts must be there (a Twin-Flow split that differs
        between save and load raises)."""
        self._step = int(sd["step"])
        for path, s in self._slots.items():
            if s is None:
                continue
            slot = _get(sd["slots"], path)
            if slot is None:
                raise ValueError(
                    f"saved optimizer state has no host shard for {path}, a leaf this engine "
                    "hosts: the host/device split (Twin-Flow ratio) differs between save "
                    "and load")
            for f in ("master",) + self.kernel.fields:
                src = slot[f]
                src = src if torch.is_tensor(src) else torch.as_tensor(src)
                if tuple(src.shape) != tuple(s[f].shape):
                    raise ValueError(f"{path}.{f}: saved {tuple(src.shape)}, this rank's "
                                     f"shard {tuple(s[f].shape)}")
                s[f].copy_(src)
