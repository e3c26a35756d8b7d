"""Fused single-token decode attention over a contiguous KV cache.

Mirrors ``deepspeed_tpu/ops/pallas/decode_attention.py``: one query token
per sequence attends over its (B, S_max, KVH, D) cache slots below
``cache_len`` with an online softmax, and the (B, H, S_max) logits the
einsum path materialises never exist. GQA runs the G = H / KVH query heads
of each kv head against one read of its rows.

``fused_decode_attention`` takes the tensors' device as the choice of
implementation: on CUDA tensors it launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs
``fused_decode_attention_plain``. The TPU wrapper's ``block`` argument (its
VMEM tile of cache slots) has no counterpart: the kernel splits each
sequence's live slots into chunks of 64-slot tiles by ``plan`` (sized to the
SM count, evaluated on the card from ``cache_len``), merges the chunks in
the same launch, and reads the cache in its own layout where the TPU
wrapper copies it to (B, KVH, S_max, D) first.
"""

import ctypes

import torch

from . import op_builder

# the kernel's compiled head dims (csrc/decode_attention.cu); it takes bf16
KERNEL_HEAD_DIMS = (64, 128, 192, 256)
# cache slots a tile (one TMA box) and query rows an item of the kernel
TILE = 64
ROWS = 16


def fused_decode_attention_plain(q, k_cache, v_cache, cache_len, *, scale=None):
    """The plain PyTorch version: one masked softmax in f32 over every
    slot. Same arguments and result as ``fused_decode_attention``. The
    scale multiplies the f32 dot; probabilities are rounded to the cache
    dtype before the P.V product while their sum stays f32, as the TPU
    kernel does; a sequence with ``cache_len == 0`` outputs 0."""
    b, h, d = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = float(scale if scale is not None else d ** -0.5)
    qg = q.float().reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    live = torch.arange(s_max, device=q.device)[None] < cache_len.to(q.device).long()[:, None]
    live = live[:, None, None, :]                                     # (B, 1, 1, S)
    m = s.masked_fill(~live, -torch.inf).amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)                      # empty row: all 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    o = o / torch.where(l == 0, 1.0, l)
    return o.reshape(b, h, d).to(q.dtype)


def plan(lens, kvh, groups, sms):
    """The kernel's work items for live lengths ``lens`` (each clamped to
    [0, S_max] by the caller), ``kvh`` kv heads, ``groups`` row groups of 16
    query rows and ``sms`` SMs: a list of (b, kv head, row group, chunk,
    chunks of b, first slot, end slot), in launch order.

    The kernel evaluates the same arithmetic from ``cache_len`` on the card
    (``find_item`` in csrc/decode_attention.cu): T live tiles of 64 slots in
    all, ``tpc = max(1, ceil(T kvh groups / sms))`` tiles a chunk, sequence b
    cut evenly into ``max(1, ceil(tiles_b / tpc))`` chunks. A sequence with
    no live slot gets one empty chunk, which writes its zeros."""
    tiles = [-(-n // TILE) for n in lens]
    per = kvh * groups
    tpc = max(1, -(-sum(tiles) * per // sms))
    items = []
    for b, (n, tb) in enumerate(zip(lens, tiles)):
        chunks = max(1, -(-tb // tpc))
        for j in range(chunks):
            t0, t1 = j * tb // chunks, (j + 1) * tb // chunks
            for kh in range(kvh):
                for rg in range(groups):
                    items.append((b, kh, rg, j, chunks, t0 * TILE, min(t1 * TILE, n)))
    return items


def max_chunks(s_max, kvh, groups, sms):
    """The most chunks ``plan`` gives one sequence of at most ``s_max``
    slots: no more than its tiles, nor than ceil(sms / (kvh groups)), since a
    chunk holds at least T kvh groups / sms of the T tiles."""
    return max(1, min(-(-s_max // TILE), -(-sms // (kvh * groups))))


def grid_size(b, kvh, groups, sms):
    """The blocks the kernel launches: an upper bound of ``plan``'s items
    (sms from the chunks' share of the tiles, one more chunk a sequence at
    most from rounding)."""
    return sms + b * kvh * groups


_SMS = {}
_COUNTERS = {}


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _counters(device, stream, n):
    """Arrival counters for the kernel's last-block merge, kept per (device,
    stream) and grown as needed (calls on one stream run in order): zero at
    first, and every launch leaves them zero."""
    key = (device, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return cnt


def _lib():
    fn = op_builder.load("decode_attention").ds_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """q: (B, H, D), one decode token per sequence; k_cache/v_cache:
    (B, S_max, KVH, D); cache_len: (B,) valid slots per sequence (including
    the one just written). Returns (B, H, D).

    CPU tensors run the plain version; CUDA tensors launch the kernel (bf16,
    D in {64, 128, 192, 256}, contiguous) and count the launch in
    ``fused_decode_attention.launches``."""
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_cache, v_cache, cache_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: no kernel for {q.device}")
    b, h, d = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the decode attention kernel takes bf16, got {q.dtype} (f16/f32 "
            "instantiations: ROADMAP.md section A, item 15)")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the decode attention kernel is compiled for head dims {KERNEL_HEAD_DIMS}, got {d}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    for name, t, dtype, shape in (("q", q, q.dtype, (b, h, d)),
                                  ("k_cache", k_cache, q.dtype, (b, s_max, kvh, d)),
                                  ("v_cache", v_cache, q.dtype, (b, s_max, kvh, d)),
                                  ("cache_len", cache_len, torch.int32, (b,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "cache_len" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel's vector loads)")
    groups = -(-(h // kvh) // ROWS)
    sms = _sm_count(q.device)
    maxc = max_chunks(s_max, kvh, groups, sms)
    rows = b * kvh * groups * maxc * ROWS        # (B, KVH, RG, maxc, 16) partial rows
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, stream, b * kvh * groups)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
                 ws.data_ptr(), ws.data_ptr() + rows * d * 4, counters.data_ptr(), out.data_ptr(),
                 b, h, kvh, s_max, d, sms, maxc, grid_size(b, kvh, groups, sms),
                 float(scale if scale is not None else d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
