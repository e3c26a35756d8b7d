"""CUDA graphs of the decode programs: one captured step per shape key.

The JAX package compiles each serving and decode program once per shape
bucket: ``jax.jit`` over a ``lax.scan`` with the state donated
(``deepspeed_tpu/inference/v2/model_runner.py`` ``run``, ``decode_loop``,
``mixed_loop``, ``frame_loop``, ``frame_loop_spec``, ``mixed_loop_spec``;
``deepspeed_tpu/inference/engine.py`` ``generate``). The port writes each
program's step over static buffers that the step updates in place,
captures it once per key into a
``torch.cuda.CUDAGraph`` and replays it: a loop of ``steps`` steps is
``steps`` replays of one graph. A key is the jit's static shape arguments
without the step count, so the captures follow the power-of-two buckets
that bound JAX's recompiles, and every graph draws on one memory pool. A
speculative step's key adds gamma and the draft runner's tag; its graph
holds the draft's forwards and the target's verify, and reads the draft's
weights and pools too (``bind``), which a draft re-attach drops
(``evict``).

The first call of a key runs its step eagerly on the capture stream: that
is the call's real step, and it loads the kernel libraries and makes K1's
and K2's arrival counters at the key's shape before anything is captured.
Then the step is captured (capture runs no kernel). A failed capture or
replay raises; nothing falls back to eager. A step that samples is never
captured: its caller asks for an eager run (``capture=False``), so each call
draws fresh numbers from its generator.

On the CPU there is nothing to capture, so every step runs eagerly on the
same static buffers; the CPU tests hold this path against the functional
loops and count its keys.

Tensor parallelism: a step holds the tp collectives (NCCL), captured with
it; the engine runs one collective before any capture, so the communicator
exists. Every rank must run the same keys in the same order, or their
collectives wait on each other forever. With ``agree_keys`` set (rank 0's
value of a host object, ``tp.TPContext.agree``), a key's first use on a
rank checks that rank 0 is at the same key and raises if it is not. The
check is itself a collective, so it raises only when the ranks diverge
onto new keys together: a rank at a new key while rank 0 replays a key it
has seen meets the collectives of rank 0's graph instead, and hangs until
the process group's timeout. Replicated host state is what keeps the ranks
on one sequence of keys; the check catches a first divergence, not every
one.

Launch counts: a kernel wrapper adds to its ``.launches`` when it runs.
Capture only records, so the counts it adds are taken back, and every
replay adds the launches its graph recorded to ``StepGraphs.replayed``.
"""

import collections
import time

import torch

from ..ops.decode_attention import fused_decode_attention
from ..ops.paged_attention import paged_ragged_attention

# kernel wrappers on the captured paths, by the name chip_smoke.py counts
COUNTED = {"paged_attention": paged_ragged_attention,
           "fused_decode_attention": fused_decode_attention}

# rows of the per-step output buffers: a loop copies them out every
# OUT_ROWS steps, so no buffer grows with the step count
OUT_ROWS = 64


class StepGraphs:
    """The captured steps of one engine, keyed by shape."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._graphs = {}              # key -> (CUDAGraph, {kernel: launches})
        self._seen = {}                # every key run, in first-use order
        self._binding = None
        self._pool = self._stream = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.replayed = collections.Counter()
        self.agree_keys = None         # under tp: rank 0's value of an object

    def keys(self):
        """Every key a step ran under, captured or not, in first-use order."""
        return list(self._seen)

    def bind(self, *objs) -> None:
        """A graph reads the weights and pools it was captured over: a call
        over other objects drops every graph. The bound objects are held, so
        no graph outlives what it reads. A call over a prefix of the bound
        objects keeps them (a plain step of an engine whose speculative
        steps also read the draft's weights and pools), and a call that
        extends them keeps its graphs and holds the longer list."""
        held = self._binding
        n = 0 if held is None else min(len(objs), len(held))
        if held is None or any(a is not b for a, b in zip(objs[:n], held[:n])):
            self.reset()
            self._binding = objs
        elif len(objs) > len(held):
            self._binding = objs

    def evict(self, *programs) -> None:
        """Drop the graphs of the given programs (the first entry of a key),
        e.g. the speculative steps on a draft re-attach, as JAX's
        ``PagedModelRunner.evict`` drops their compiled programs."""
        for key in [k for k in self._graphs if k[0] in programs]:
            del self._graphs[key]

    def reset(self) -> None:
        """Drop every graph and the objects they were bound to."""
        self._graphs.clear()
        self._binding = None

    def run(self, key, step, capture: bool = True) -> None:
        """Run ``step()`` once as program ``key``: replay its graph, or on the
        key's first call run it eagerly and capture it. ``capture=False``
        (a sampled step) and the CPU run it eagerly every time."""
        if key not in self._seen and self.agree_keys is not None:
            first = self.agree_keys(key)
            if first != key:
                raise RuntimeError(f"step key {key} on this rank, {first} on rank 0: the tp "
                                   "ranks' host state diverged and their collectives would "
                                   "hang")
        self._seen.setdefault(key, None)
        if not (self.capture and capture):
            step()
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._capture(key, step)
            return
        graph, launched = entry
        graph.replay()
        self.replays += 1
        self.replayed.update(launched)

    def _capture(self, key, step) -> None:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            step()                         # this call's step, run for real
        before = {name: (fn.launches, dict(getattr(fn, "routes", {})))
                  for name, fn in COUNTED.items()}
        graph = torch.cuda.CUDAGraph()
        # under tp, NCCL's watchdog thread queries events while this thread
        # captures: only this thread's calls may end the capture
        mode = "global" if self.agree_keys is None else "thread_local"
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode=mode):
                step()
        finally:
            launched = {name: fn.launches - before[name][0]
                        for name, fn in COUNTED.items() if fn.launches != before[name][0]}
            for name, fn in COUNTED.items():
                fn.launches = before[name][0]
                if hasattr(fn, "routes"):
                    fn.routes.update(before[name][1])
        current.wait_stream(self._stream)
        self._graphs[key] = (graph, launched)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def stats(self) -> dict:
        """Captures, their seconds, replays and the kernel launches replayed."""
        return {"captures": self.captures, "capture_s": self.capture_s,
                "replays": self.replays, "replayed_launches": dict(self.replayed)}


class StepRows:
    """Per-step outputs of a loop over one captured step: each step writes
    its row of values (shape ``row``: (B,), or (B, gamma + 1) for a
    speculative step) as row ``at`` of (OUT_ROWS, *row) buffers and
    advances the device counter ``at``; ``loop`` runs the steps in runs of
    OUT_ROWS and copies the rows out."""

    def __init__(self, row, dtypes, device):
        row = (row,) if isinstance(row, int) else tuple(row)
        self.bufs = [torch.zeros((OUT_ROWS,) + row, dtype=dt, device=device) for dt in dtypes]
        self.at = torch.zeros((1,), dtype=torch.long, device=device)

    def write(self, *vals) -> None:
        for buf, v in zip(self.bufs, vals):
            buf.index_copy_(0, self.at, v[None].to(buf.dtype))
        self.at.add_(1)

    def loop(self, steps: int, step):
        """Call ``step()`` ``steps`` times; returns one (steps, *row) tensor
        per buffer."""
        outs = [torch.empty((steps,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                            device=buf.device) for buf in self.bufs]
        for s0 in range(0, steps, OUT_ROWS):
            n = min(OUT_ROWS, steps - s0)
            self.at.zero_()
            for _ in range(n):
                step()
            for out, buf in zip(outs, self.bufs):
                out[s0:s0 + n].copy_(buf[:n])
        return outs
