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
and the card's comparisons use. The kernel has two routes, chosen on the
host by shape (``route``): "split" for few query rows a kv head (decode),
a split of each row group's live pool slots over the SMs planned on the
card from ``positions`` (``plan`` is the same arithmetic) and merged in the
same launch; "wgmma" for many (prefill), mode PAGED of the wgmma forward
mainloop over 128-row items. The TPU kernel's ``pages_per_step`` tiling
knob has no counterpart here.
"""

import ctypes
import math

import torch

from . import op_builder

# the kernel's compiled head dims (csrc/paged_attention.cu); it takes bf16
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)
# the head dims of the wgmma route (its swizzled tiles need D % 64 == 0)
WGMMA_HEAD_DIMS = (64, 128, 256)
# the split route: pool slots a tile and query rows an item (the mma's M)
TILE = 64
ROWS = 16
# the crossover at a wgmma head dim, measured on the card by chip_smoke.py's
# k1_crossover: the split route runs up to SPLIT_MAX_ROWS query rows a kv
# head (C * G) or SPLIT_MAX_C chunk rows (llama3-8b, G 4, crossed between C
# 4 and 8; falcon-7b, G 71 on one kv head, between C 2 and 4)
SPLIT_MAX_ROWS = 16
SPLIT_MAX_C = 2


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


def route(c, g, d, bs):
    """The kernel's route for C chunk rows, G query heads a kv head, head
    dim D and block size bs: "split" when D has no wgmma instantiation (80,
    96), or the C * G query rows of a kv head are at most SPLIT_MAX_ROWS,
    or C is at most SPLIT_MAX_C; else "wgmma". Both take every power-of-two
    block size >= 16 (a tile spans pages, or part of one), so bs does not
    move the choice."""
    del bs
    if d not in WGMMA_HEAD_DIMS or c * g <= SPLIT_MAX_ROWS or c <= SPLIT_MAX_C:
        return "split"
    return "wgmma"


def _unit(pos_b, rg, g, window, bs, mb, has_chunk):
    """Row group rg of one sequence (rows [16 rg, 16 rg + 16) of its C * G):
    (lo, hi, base, tiles, pmin, pmax) as ``unit_of`` in the kernel computes
    them: its live pool slots [lo, hi), their 64-slot tiles from ``base``,
    its rows' least and greatest position (pmax -1: no live row)."""
    rows = len(pos_b) * g
    r1 = min(rg * ROWS + ROWS, rows)
    live = [p for p in pos_b[rg * ROWS // g:(r1 - 1) // g + 1] if p >= 0]
    if not live:
        return 0, 0, 0, 0, -1, -1
    pmin, pmax = min(live), max(live)
    end = mb * bs
    if has_chunk:
        end = min(end, min(p for p in pos_b if p >= 0))
    hi = end if has_chunk else min(end, pmax + 1)
    lo = max(pmin - window + 1, 0) if window > 0 else 0
    if lo >= hi:
        return 0, 0, 0, 0, pmin, pmax
    base = lo // TILE * TILE
    return lo, hi, base, -(-(hi - base) // TILE), pmin, pmax


def plan(positions, window, bs, mb, kvh, g, sms, has_chunk=True):
    """The split route's work items for ``positions`` (B lists of C ints,
    -1 padding), in launch order: a list of (b, row group, kv head, chunk,
    chunks of the row group, first slot, end slot, first chunk key, end
    chunk key). The kernel evaluates the same arithmetic from the device's
    positions (``find_item`` in csrc/paged_attention.cu): T live 64-slot
    tiles over every (sequence, row group), ``tpc = max(1, ceil(T kvh /
    sms))`` tiles a chunk, a row group's tiles cut evenly into
    ``max(1, ceil(tiles / tpc))`` chunks. The last chunk also folds in the
    chunk keys [first, end) whose positions its rows can see; a row group
    with no live row gets one item with no keys, which writes its zeros."""
    window = int(window or 0)
    rgs = -(-len(positions[0]) * g // ROWS)
    units = [(b, rg, _unit(list(pos_b), rg, g, window, bs, mb, has_chunk))
             for b, pos_b in enumerate(positions) for rg in range(rgs)]
    tpc = max(1, -(-sum(u[3] for *_, u in units) * kvh // sms))
    items = []
    for b, rg, (lo, hi, base, tiles, pmin, pmax) in units:
        n = max(1, -(-tiles // tpc))
        ck = (0, 0)
        if has_chunk and pmax >= 0:
            floor = pmin - window + 1 if window > 0 else 0
            seen = [c for c, p in enumerate(positions[b]) if 0 <= p <= pmax and p >= floor]
            if seen:
                ck = (min(seen), max(seen) + 1)
        for j in range(n):
            t0, t1 = j * tiles // n, (j + 1) * tiles // n
            s0, s1 = max(base + t0 * TILE, lo), min(base + t1 * TILE, hi)
            for kh in range(kvh):
                items.append((b, rg, kh, j, n, s0, s1) + (ck if j == n - 1 else (0, 0)))
    return items


def max_chunks(mb, bs, kvh, sms):
    """The most chunks ``plan`` gives one row group: no more than its tiles
    (a table of MB * bs slots, one more from rounding lo down), nor than
    ceil(sms / kvh), since a chunk holds at least T kvh / sms of T tiles."""
    return max(1, min(-(-mb * bs // TILE) + 1, -(-sms // kvh)))


def grid_size(b, rgs, kvh, sms):
    """The blocks the split route launches: an upper bound of ``plan``'s
    items (sms from the chunks' share of the tiles, one more chunk a row
    group at most from rounding)."""
    return sms + b * rgs * kvh


_SMS = {}
_COUNTERS = {}
_OUTGROWN = []   # counters a larger call replaced: a captured graph may hold one


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _counters(device, stream, n):
    """Arrival counters for the split route's last-block merge, kept per
    (device, stream) and grown as needed (calls on one stream run in
    order): zero at first, and every launch leaves them zero. A buffer that a
    larger call replaces is kept alive, since a CUDA graph captured over it
    goes on launching on it."""
    key = (device, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        if cnt is not None:
            _OUTGROWN.append(cnt)
        cnt = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return cnt


def _lib():
    lib = op_builder.load("paged_attention")
    fn = lib.ds_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_info(route_name, d):
    """{"smem_bytes", "threads"} of the built kernel of ``route_name``
    ("split" or "wgmma") at head dim d."""
    fn = op_builder.load("paged_attention").ds_paged_attention_kernel_info
    info = (ctypes.c_int * 3)()
    err = fn(ctypes.c_int({"split": 0, "wgmma": 1}[route_name]), ctypes.c_int(d), info)
    if err != 0:
        raise ValueError(f"paged attention: no {route_name} kernel at head dim {d}")
    return {"smem_bytes": info[1], "threads": info[2]}


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
    D in KERNEL_HEAD_DIMS, block size a power of two >= 16, 16-byte aligned
    tensors) on the route ``route`` picks, count the launch in
    ``paged_ragged_attention.launches`` and the route's in
    ``paged_ragged_attention.routes``.
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
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool), ("chunk_k", chunk_k),
                    ("chunk_v", chunk_v)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel's 16-byte copies)")
    g = h // kvh
    way = route(c, g, d, bs)
    rgs = -(-c * g // ROWS)
    sms = _sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    maxc = grid = 0
    ws = counters = None
    if way == "split":
        maxc = max_chunks(mb, bs, kvh, sms)
        grid = grid_size(b, rgs, kvh, sms)
        rows = b * rgs * kvh * maxc * ROWS    # (B, RG, KVH, maxc, 16) partial rows
        ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=dev)
        counters = _counters(dev, stream, b * rgs * kvh)
    out = torch.empty_like(q)
    ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
    err = _lib()(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 block_tables.data_ptr(), positions.data_ptr(), ptr(chunk_k),
                 ptr(chunk_v), ptr(alibi_slopes), out.data_ptr(), ptr(ws),
                 None if ws is None else ws.data_ptr() + rows * d * 4, ptr(counters),
                 b, c, h, kvh, d, n_layers, nb, bs, mb, int(layer), int(window or 0),
                 float(scale if scale is not None else d ** -0.5), float(softcap or 0.0),
                 0 if way == "split" else 1, sms, maxc, grid, stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: cudaError {err}")
    paged_ragged_attention.launches += 1
    paged_ragged_attention.routes[way] += 1
    return out


paged_ragged_attention.launches = 0
paged_ragged_attention.routes = {"split": 0, "wgmma": 0}
