"""Paged ragged attention: flash attention over in-place KV pages.

Mirrors ``deepspeed_tpu/ops/pallas/paged_attention.py``. One function
serves decode (C == 1) and chunked prefill (C > 1): each sequence's queries
attend its KV pages read through the block table, plus the chunk's own KV
as a final virtual page, with causal, sliding-window, ALiBi and softcap
handling by absolute position.

``paged_ragged_attention`` takes the tensors' device as the choice of
implementation: on CUDA tensors it launches the hand-written Hopper kernel
(``csrc/paged_attention.cu``) or raises; on CPU tensors it runs
``paged_ragged_attention_plain``, the plain PyTorch version the CPU tests
and the card's comparisons use. The TPU kernel's ``pages_per_step`` tiling
knob has no counterpart here.
"""

import ctypes
import math

import torch

from . import op_builder

# the kernel's compiled head dims (csrc/paged_attention.cu); it takes bf16
KERNEL_HEAD_DIMS = (64, 128, 256)


def _chunk_start(positions, has_chunk):
    """Per row, the first stale pool slot, as the TPU kernel computes it:
    the chunk's earliest position (0 for an all-pad row) when the chunk's
    KV rides beside the pool, else one past the last query."""
    valid = positions >= 0
    if has_chunk:
        big = 1 << 30
        minpos = torch.where(valid, positions, big).amin(dim=1)
        return torch.where(minpos == big, 0, minpos)
    return torch.where(valid, positions, -1).amax(dim=1) + 1


def paged_ragged_attention_plain(q, kpool, vpool, block_tables, positions,
                                 chunk_k=None, chunk_v=None, *, layer=None,
                                 scale=None, window=0, alibi_slopes=None,
                                 softcap=0.0):
    """The plain PyTorch version: gather every table page, one masked
    softmax in f32. Same arguments and result as ``paged_ragged_attention``.
    Probabilities are rounded to the value dtype before the P.V product,
    as the TPU kernel does; a row with no visible key outputs 0."""
    if kpool.dim() == 4:
        kpool, vpool, layer = kpool[None], vpool[None], 0
    b, c, h, d = q.shape
    _, kvh, _, bs, _ = kpool.shape
    mb = block_tables.shape[1]
    g = h // kvh
    scale = float(scale if scale is not None else d ** -0.5)
    window = int(window or 0)
    pos = positions.long()
    cs = _chunk_start(pos, chunk_k is not None)
    bt = block_tables.long()
    # (KVH, B, MB, bs, D) -> (B, KVH, MB*bs, D)
    keys = kpool[layer][:, bt].reshape(kvh, b, mb * bs, d).transpose(0, 1)
    vals = vpool[layer][:, bt].reshape(kvh, b, mb * bs, d).transpose(0, 1)
    slot = torch.arange(mb * bs, device=q.device)
    kpos = torch.where(slot[None] < cs[:, None], slot[None], -1)    # (B, S)
    if chunk_k is not None:
        keys = torch.cat([keys, chunk_k.to(keys.dtype).transpose(1, 2)], dim=2)
        vals = torch.cat([vals, chunk_v.to(vals.dtype).transpose(1, 2)], dim=2)
        kpos = torch.cat([kpos, torch.where(pos >= 0, pos, -1)], dim=1)
    # keys no row may see (stale slots, table padding -> trash block 0, pad
    # chunk rows) contribute 0 * value: zero the values so a non-finite row
    # parked there (a quarantined sequence's trash writes) cannot reach a
    # live row, as the kernel never loads them
    vals = torch.where((kpos >= 0)[:, None, :, None], vals, 0)
    # rows r = c*G + g per kv head: (B, KVH, C*G, D)
    qg = q.float().reshape(b, c, kvh, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, kvh, c * g, d)
    s = (qg @ keys.float().transpose(-1, -2)) * scale              # (B, KVH, R, S)
    qpos = pos.repeat_interleave(g, dim=1)[:, None, :, None]       # (B, 1, R, 1)
    kp = kpos[:, None, None, :]                                    # (B, 1, 1, S)
    if alibi_slopes is not None:
        sl = alibi_slopes.float().reshape(kvh, g).repeat(1, c)     # (KVH, R)
        s = s + sl[None, :, :, None] * (kp - qpos).float()
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = (kp >= 0) & (kp <= qpos)
    if window > 0:
        mask = mask & (kp > qpos - window)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)        # fully masked row: all p = 0
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(vals.dtype).float() @ vals.float()
    o = o / torch.where(l == 0, 1.0, l)
    return o.reshape(b, kvh, c, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, c, h, d).to(q.dtype)


def _lib():
    lib = op_builder.load("paged_attention")
    fn = lib.ds_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype=None, shape=None, device=None):
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_ragged_attention(q, kpool, vpool, block_tables, positions,
                           chunk_k=None, chunk_v=None, *, layer=None,
                           scale=None, window=0, alibi_slopes=None,
                           softcap=0.0):
    """Unified paged attention for decode AND chunked prefill.

    q: (B, C, H, D); kpool/vpool: the full (L, KVH, NB, bs, D) pools with
    ``layer`` the layer index (a 4-D single-layer pool with ``layer=None``
    is also accepted). The pools are read-only here and must not yet hold
    the current chunk: ``chunk_k``/``chunk_v`` (B, C, KVH, D) carry it,
    keyed by ``positions``, and pool slots at or beyond the chunk's first
    position are stale. With ``chunk_k=None`` the pool already holds every
    slot up to each query's position. block_tables: (B, MB) int32 page ids;
    positions: (B, C) int32 absolute slot of each query, -1 for padding.
    ``window`` > 0 limits a query at p to keys in (p - window, p];
    ``alibi_slopes``: (H,) f32; ``softcap``: tanh cap on the scores.
    Returns (B, C, H, D); rows with no visible key are 0.

    CPU tensors run the plain version; CUDA tensors launch the kernel (bf16,
    D in {64, 128, 256}, block size a power of two >= 16) and count
    the launch in ``paged_ragged_attention.launches``.
    """
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(
            q, kpool, vpool, block_tables, positions, chunk_k, chunk_v,
            layer=layer, scale=scale, window=window,
            alibi_slopes=alibi_slopes, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_ragged_attention: no kernel for {q.device}")
    if kpool.dim() == 4:
        kpool, vpool, layer = kpool[None], vpool[None], 0
    b, c, h, d = q.shape
    n_layers, kvh, nb, bs, _ = kpool.shape
    mb = block_tables.shape[1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"paged_ragged_attention kernel takes bf16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_ragged_attention kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if bs < 16 or bs & (bs - 1):
        raise ValueError(f"paged_ragged_attention kernel: block size {bs} is not a power of two >= 16")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"layer {layer} outside the {n_layers}-layer pool")
    dev = q.device
    _check("q", q, device=dev)
    _check("kpool", kpool, q.dtype, device=dev)
    _check("vpool", vpool, q.dtype, kpool.shape, dev)
    _check("block_tables", block_tables, torch.int32, (b, mb), dev)
    _check("positions", positions, torch.int32, (b, c), dev)
    if chunk_k is not None:
        _check("chunk_k", chunk_k, q.dtype, (b, c, kvh, d), dev)
        _check("chunk_v", chunk_v, q.dtype, (b, c, kvh, d), dev)
    if alibi_slopes is not None:
        _check("alibi_slopes", alibi_slopes, torch.float32, (h,), dev)
    fn = _lib()
    out = torch.empty_like(q)
    ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
    err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
             block_tables.data_ptr(), positions.data_ptr(), ptr(chunk_k),
             ptr(chunk_v), ptr(alibi_slopes), out.data_ptr(), b, c, h, kvh, d,
             nb, bs, mb, int(layer), int(window or 0),
             float(scale if scale is not None else d ** -0.5),
             float(softcap or 0.0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: cudaError {err}")
    paged_ragged_attention.launches += 1
    return out


paged_ragged_attention.launches = 0
