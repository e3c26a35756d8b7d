"""Tensor-parallel collectives for per-step decode, over ``torch.distributed``.

Mirrors ``deepspeed_tpu/parallel/collectives.py``. A decode step of a
tensor-parallel engine issues two all-reduces a layer (the attention and MLP
output projections are row-parallel), a masked-embedding all-reduce and a
logit all-gather. Each has three lowerings, picked by ``TPCollectives``:

- **exact**: ``all_reduce`` / a tiled all-gather. The default: greedy
  tokens at tp = N are the tokens of tp = 1.
- **overlap** (T3, arXiv 2401.16677): the all-reduce as a ring
  reduce-scatter then a ring all-gather of ``degree`` chunks of the last
  dim, one neighbour exchange a hop (``comm.ring_send_recv``), in JAX's
  chunk order. Its sums run in ring order, so it is parity at tolerance.
- **quantized** (EQuARX, arXiv 2506.17615): one-byte payloads with per-row
  f32 scales, int8 (absmax / 127) or fp8 e4m3 (absmax / 448). The
  all-reduce is a quantized reduce-scatter (``all_to_all`` of the chunks
  and their scales, dequantized and summed in f32 locally, shard 0 first)
  followed by a quantized all-gather of the reduced chunks.

Where JAX calls these inside a ``shard_map`` region over a mesh axis, the
port calls them in every rank's process with the tp process group
(``group``; None is the world); ``degree == 1`` is the identity. The
quantizers are elementwise ops and a row reduction (XLA ops in JAX, not
Pallas kernels), so they are plain torch ops here. fp8 payloads cross the
wire as their bytes (``comm._wire``).
"""

import dataclasses
from typing import Any

import torch

from ..comm import comm


def psum_exact(x, group=None):
    """The sum over the group's ranks, written into ``x`` (callers pass a
    fresh product they do not read again; a copy would add a kernel to
    every all-reduce of a step)."""
    return comm.all_reduce(x, group=group)


def all_gather_exact(x, group=None, gather_axis: int = -1):
    return comm.all_gather_into_tensor(x, dim=gather_axis % x.dim(), group=group)


# ---------------------------------------------------------------------------
# overlap path: ring all-reduce as neighbour exchanges (T3-style)
# ---------------------------------------------------------------------------


def psum_ring(x, group, degree: int):
    """All-reduce as ring reduce-scatter + ring all-gather over ``degree``
    chunks of the last dim (JAX ``psum_ring``: the same chunk each rank
    seeds, adds and forwards at each hop, so the same sums in the same
    order). Falls back to ``psum_exact`` when the last dim does not split
    evenly."""
    d = x.shape[-1]
    if degree == 1:
        return x
    if d % degree != 0:
        return psum_exact(x, group)
    r = comm.get_rank(group)
    chunks = x.reshape(x.shape[:-1] + (degree, d // degree))

    def chunk(i):
        return chunks[..., i % degree, :]

    # reduce-scatter: the partial for chunk j starts at rank j + 1 and takes
    # one local contribution a hop, landing fully reduced on rank j
    acc = chunk(r + degree - 1)
    for k in range(1, degree):
        acc = comm.ring_send_recv([acc], group)[0] + chunk(r + 2 * degree - 1 - k)
    # all-gather the reduced chunks back around the ring: rank r holds chunk
    # r, then receives chunks r - 1, r - 2, ... in turn
    parts = [acc]
    for _ in range(degree - 1):
        parts.append(comm.ring_send_recv([parts[-1]], group)[0])
    out = torch.empty_like(chunks)
    for k, p in enumerate(parts):
        out[..., (r - k) % degree, :] = p
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# quantized path: int8/fp8 payloads + per-row f32 scales (EQuARX-style)
# ---------------------------------------------------------------------------

_FP8_MAX = 448.0  # float8_e4m3fn largest finite value


def _scaled(x, qmax: float):
    """(x / scale in f32, scale) with scale = row absmax / ``qmax`` (keepdims)
    and all-zero rows at scale 0 and value 0. The divisions divide by
    tensors, as JAX's do (a Python divisor becomes a reciprocal multiply on
    the card)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, qmax)
    live = scale > 0
    q = torch.where(live, x32 / torch.where(live, scale, torch.ones_like(scale)),
                    torch.zeros_like(x32))
    return q, scale


def _quantize_int8(x):
    """Symmetric per-row (last-dim) int8 quantization (JAX
    ``_quantize_int8``): (q, scale) with ``x ~= q * scale``, round half to
    even, clipped to +-127; all-zero rows get scale 0."""
    q, scale = _scaled(x, 127.0)
    return torch.round(q).clamp(-127, 127).to(torch.int8), scale


def _quantize_fp8(x):
    """Per-row scaled cast to e4m3 (JAX ``_quantize_fp8``): the row spans
    e4m3's range, clipped to its largest finite value so the cast never
    makes inf or NaN."""
    q, scale = _scaled(x, _FP8_MAX)
    return q.clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn), scale


def _quantize(x, payload: str):
    if payload == "fp8":
        return _quantize_fp8(x)
    return _quantize_int8(x)


def _sum_shards(t, axis: int):
    """Sum over ``axis`` shard 0 first, in f32 (the order JAX's reduction
    takes on the chunk axis)."""
    parts = t.unbind(axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum_quantized(x, group, degree: int, payload: str = "int8"):
    """All-reduce with one-byte payloads, reduce-scatter shaped (JAX
    ``psum_quantized``): chunk the last dim ``degree`` ways, quantize each
    chunk with its own per-row scale, ``all_to_all`` the chunks and scales
    (rank r receives every rank's chunk r), dequantize and sum them in f32,
    requantize the reduced chunk once and all-gather it back. Falls back to
    a gather of the whole quantized row when the last dim does not chunk
    evenly."""
    if degree == 1:
        return x
    d = x.shape[-1]
    if d % degree != 0:
        q, s = _quantize(x, payload)
        qg = comm.all_gather_into_tensor(q[None], dim=0, group=group)   # (degree, ...)
        sg = comm.all_gather_into_tensor(s[None], dim=0, group=group)
        return _sum_shards(qg.float() * sg, 0).to(x.dtype)
    shard = d // degree
    chunks = x.reshape(x.shape[:-1] + (degree, shard))
    q, s = _quantize(chunks, payload)                   # s: (..., degree, 1)
    ca = x.dim() - 1                                    # the chunk axis
    qx = comm.all_to_all_single(q, scatter_dim=ca, gather_dim=ca, group=group)
    sx = comm.all_to_all_single(s, scatter_dim=ca, gather_dim=ca, group=group)
    red = _sum_shards(qx.float() * sx, -2)              # (..., shard)
    q2, s2 = _quantize(red, payload)
    qg = comm.all_gather_into_tensor(q2, dim=ca, group=group)     # (..., d)
    sg = comm.all_gather_into_tensor(s2, dim=ca, group=group)     # (..., degree)
    deq = qg.reshape(qg.shape[:-1] + (degree, shard)).float() * sg[..., None]
    return deq.reshape(x.shape[:-1] + (d,)).to(x.dtype)


def all_gather_quantized(x, group, degree: int, payload: str = "int8"):
    """Tiled all-gather of the last dim with one-byte payloads (the logit
    exchange of a vocab-sharded LM head; JAX ``all_gather_quantized``)."""
    if degree == 1:
        return x
    q, s = _quantize(x, payload)                        # s: (..., 1)
    qg = comm.all_gather_into_tensor(q, dim=q.dim() - 1, group=group)
    sg = comm.all_gather_into_tensor(s, dim=s.dim() - 1, group=group)   # (..., degree)
    shard = x.shape[-1]
    deq = qg.reshape(qg.shape[:-1] + (degree, shard)).float() * sg[..., None]
    return deq.reshape(qg.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# the layer the serving forward calls
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPCollectives:
    """An engine's choice of collective lowerings (JAX ``TPCollectives``).

    ``quantized`` switches the activation all-reduces, the masked-embedding
    all-reduce and the logit all-gather to one-byte payloads; ``payload``
    picks the wire format ("int8", or "fp8" = e4m3); ``overlap`` switches
    the MLP all-reduce to the chunked ring. ``quantized`` wins when both
    are set. ``group`` is the tp process group (None: the world)."""

    group: Any
    degree: int
    quantized: bool = False
    overlap: bool = False
    payload: str = "int8"

    def psum_attn(self, x):
        """Attention-output (row-parallel wo) all-reduce."""
        if self.degree == 1:
            return x
        if self.quantized:
            return psum_quantized(x, self.group, self.degree, self.payload)
        return psum_exact(x, self.group)

    def psum_mlp(self, x):
        """MLP-output (row-parallel w_out) all-reduce, the overlap target."""
        if self.degree == 1:
            return x
        if self.quantized:
            return psum_quantized(x, self.group, self.degree, self.payload)
        if self.overlap:
            return psum_ring(x, self.group, self.degree)
        return psum_exact(x, self.group)

    def psum_embed(self, x):
        """Vocab-sharded embedding reduce: each token's row is nonzero on one
        rank only; quantized, the other ranks' zero rows carry scale 0."""
        if self.degree == 1:
            return x
        if self.quantized:
            return psum_quantized(x, self.group, self.degree, self.payload)
        return psum_exact(x, self.group)

    def gather_logits(self, x):
        """Vocab-sharded logits (..., V / tp) -> (..., V)."""
        if self.degree == 1:
            return x
        if self.quantized:
            return all_gather_quantized(x, self.group, self.degree, self.payload)
        return all_gather_exact(x, self.group, gather_axis=-1)
