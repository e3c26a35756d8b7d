"""Block-sparse flash attention: the forward walks live tiles only.

Mirrors ``deepspeed_tpu/ops/pallas/sparse_flash.py``. The sparsity layout
(a boolean (S/block, S/block) grid from ``SparsityConfig.make_layout``) is
compiled, per 128-row query tile, into a table of live 128-key tiles, their
counts, and the exact token mask of each live tile with causality folded in
(``compile_layout_tables``, the same numpy code and arrays as the JAX
package's). The port packs each tile's mask to bits once per layout
(``pack_mask_bits``), the form its kernel reads.

``sparse_flash_fwd`` takes the tensors' device as the choice of
implementation: on CUDA tensors it launches the hand-written Hopper kernel
(``csrc/sparse_flash.cu``, K11), which walks only the live 16-key blocks of
each query tile (``compile_key_blocks``, compiled once per tables), or
raises; on CPU tensors it runs ``sparse_flash_plain``, the TPU kernel's
tile walk in torch. The backward pass is
not a kernel in either package: it rebuilds the (S, S) token mask from the
tiles and recomputes the dense masked attention. Unlike the TPU kernel,
masked keys get p = 0 explicitly, so a query row that sees no key outputs 0
(ROADMAP.md section C); every row of the four layout classes sees its own
key, and there the two agree.

Layouts: q, k, v are (B, S, H, D) at every function here; the JAX wrapper
transposes to (B, H, S, D) for its kernel, the port's kernel reads the
(B, S, H, D) rows in place.
"""

import ctypes
import heapq
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..accelerator import get_device
from . import op_builder

NEG_INF = -1e30
TILE_Q = 128
TILE_K = 128
KEY_BLOCK = 16                 # the kernel's key grain: one wgmma k-step, one TMA box
STAGE_SLOTS = 8                # key blocks a kernel stage (128 keys)
ITEM_COST = 0.5                # an item's Q load and epilogue, in stages, for the deal
KERNEL_HEAD_DIMS = (64, 128)   # the kernel's compiled head dims; it takes bf16


def compile_layout_tables(layout: np.ndarray, layout_block: int, causal: bool):
    """Coarsen the fine (n, n) layout to kernel tiles.

    Returns (table (QT, MA) int32 -- live key tiles per query tile, padded;
    counts (QT,) int32; masks (QT, MA, TILE_Q, TILE_K) f32 0/1 -- exact token
    mask per live tile with causality folded in)."""
    n = layout.shape[0]
    s = n * layout_block
    if s % TILE_Q or s % TILE_K:
        raise ValueError(f"seq {s} not divisible by kernel tiles")
    token = np.repeat(np.repeat(layout.astype(bool), layout_block, 0), layout_block, 1)
    if causal:
        token &= np.tril(np.ones((s, s), bool))
    qt, kt = s // TILE_Q, s // TILE_K
    tiled = token.reshape(qt, TILE_Q, kt, TILE_K).transpose(0, 2, 1, 3)
    coarse = tiled.any(axis=(2, 3))                 # (QT, KT)
    counts = coarse.sum(axis=1).astype(np.int32)
    ma = max(1, int(counts.max()))
    table = np.zeros((qt, ma), np.int32)
    masks = np.zeros((qt, ma, TILE_Q, TILE_K), np.float32)
    for i in range(qt):
        active = np.nonzero(coarse[i])[0]
        table[i, :len(active)] = active
        for j, ki in enumerate(active):
            masks[i, j] = tiled[i, ki]
    return table, counts, masks


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """(QT, MA, TILE_Q, TILE_K) 0/1 tile masks -> (QT, MA, TILE_Q, TILE_K / 32)
    int32 words: bit c % 32 of word c / 32 is the mask at key column c."""
    qt, ma = masks.shape[:2]
    on = (masks > 0).reshape(qt, ma, TILE_Q, TILE_K // 32, 32).long()
    words = (on << torch.arange(32, device=masks.device)).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_mask_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_mask_bits``, as bool."""
    qt, ma = bits.shape[:2]
    w = bits.long() & 0xFFFFFFFF
    on = (w[..., None] >> torch.arange(32, device=bits.device)) & 1
    return on.reshape(qt, ma, TILE_Q, TILE_K).bool()


class KeyBlocks(NamedTuple):
    """The kernel's walk over the live 16-key blocks of each 128-row query
    tile (``compile_key_blocks``), stages of STAGE_SLOTS blocks in CSR form:
    query tile t walks stages ``stage_start[t]`` .. ``stage_start[t + 1]``."""
    order: torch.Tensor        # (QT,) int32: query tiles, most stages first
    stage_start: torch.Tensor  # (QT + 1,) int32
    blocks: torch.Tensor       # (NS, STAGE_SLOTS) int32: key block of each slot, -1 padding
    bits: torch.Tensor         # (NS, TILE_Q, 4) int32: the mask of the stage's 128
    #                            gathered columns (slot c // 16, key 16 block + c % 16)
    full: torch.Tensor         # (NS,) int32: 1 where every bit of the stage is set


def compile_key_blocks(table, counts, bits) -> KeyBlocks:
    """The live KEY_BLOCK-key blocks of each query tile, from the tile
    tables (table, counts, bits) of ``compile_layout_tables`` /
    ``pack_mask_bits``: a block is listed if any row of the tile sees one of
    its keys. Blocks go in ascending order, STAGE_SLOTS to a stage of 128
    keys, the last stage padded with empty slots (-1, no mask bit set).
    Computed where ``bits`` lies; the kernel's input form."""
    dev = bits.device
    qt, ma = table.shape
    per_tile = TILE_K // KEY_BLOCK
    valid = torch.arange(ma, device=dev)[None, :] < counts.to(dev).long()[:, None]
    w = bits.long() & 0xFFFFFFFF                                     # (QT, MA, TQ, 4)
    halves = torch.stack((w & 0xFFFF, w >> 16), dim=-1).reshape(qt, ma, TILE_Q, per_tile)
    live = (halves != 0).any(dim=2) & valid[:, :, None]              # (QT, MA, 8)
    key = table.to(dev).long()[:, :, None] * per_tile + torch.arange(per_tile, device=dev)
    big = torch.iinfo(torch.int64).max
    key = torch.where(live, key, big).reshape(qt, ma * per_tile)
    key, src = key.sort(dim=1, stable=True)                           # live blocks first
    n_live = live.reshape(qt, -1).sum(dim=1)
    n_stages = (n_live + STAGE_SLOTS - 1) // STAGE_SLOTS
    stage_start = torch.zeros(qt + 1, dtype=torch.long, device=dev)
    stage_start[1:] = n_stages.cumsum(0)
    ns = int(stage_start[-1])
    ms = int(n_stages.max()) if qt else 0
    width = ms * STAGE_SLOTS
    if width > key.shape[1]:                                          # room for padding
        pad = width - key.shape[1]
        key = torch.cat((key, torch.full((qt, pad), big, device=dev)), dim=1)
        src = torch.cat((src, torch.zeros((qt, pad), dtype=src.dtype, device=dev)), dim=1)
    key, src = key[:, :width], src[:, :width]
    on = key != big                                                   # (QT, MS * 8)
    # each slot's 16 columns of every row: 16-bit halves of the tile's words
    flat = halves.permute(0, 1, 3, 2).reshape(qt, ma * per_tile, TILE_Q)
    cols = torch.gather(flat, 1, src[:, :, None].expand(-1, -1, TILE_Q))
    cols = torch.where(on[:, :, None], cols, 0).reshape(qt, ms, STAGE_SLOTS // 2, 2, TILE_Q)
    words = (cols[:, :, :, 0] | (cols[:, :, :, 1] << 16)).permute(0, 1, 3, 2)  # (QT, MS, TQ, 4)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    in_csr = torch.arange(ms, device=dev)[None, :] < n_stages[:, None]   # (QT, MS)
    blocks = torch.where(on, key, -1).reshape(qt, ms, STAGE_SLOTS)[in_csr]
    words = words[in_csr]
    full = (words == -1).reshape(ns, TILE_Q * 4).all(dim=1)
    order = torch.sort(n_stages, descending=True, stable=True).indices
    i32 = torch.int32
    return KeyBlocks(order.to(i32), stage_start.to(i32), blocks.to(i32).contiguous(),
                     words.to(i32).contiguous(), full.to(i32))


def deal_items(stage_start, order, b, h, blocks):
    """The kernel's items dealt to ``blocks`` persistent blocks: item i is
    query tile ``order[i // (h b)]`` of (batch, head) i % (h b), so items
    come longest first; each goes to the block with the least work so far
    (its stages plus ITEM_COST an item; ties to the lowest block). Returns
    (start (blocks + 1,), items) int32 on the CPU: block x takes items
    ``items[start[x]:start[x + 1]]`` in that order."""
    n_stages = (stage_start[1:] - stage_start[:-1]).tolist()
    weights = [n_stages[t] + ITEM_COST for t in order.tolist()]
    hb = h * b
    heap = [(0.0, x) for x in range(blocks)]
    lists = [[] for _ in range(blocks)]
    for i in range(len(weights) * hb):
        load, x = heapq.heappop(heap)
        lists[x].append(i)
        heapq.heappush(heap, (load + weights[i // hb], x))
    start = np.cumsum([0] + [len(items) for items in lists])
    return (torch.tensor(start, dtype=torch.int32),
            torch.tensor([i for items in lists for i in items], dtype=torch.int32))


class _LayoutCache:
    """layout bytes -> compiled (table, counts, bits) on the CPU (the f32
    masks are packed to bits at once and dropped), and copies on each
    device they were asked for; the kernel's key-block tables of each copy
    are compiled at its first launch and kept in ``_KEY_BLOCKS``, keyed by
    the copy's bits, which this cache holds for good."""

    def __init__(self):
        self._store = {}
        self._device = {}

    def on_device(self, layout: np.ndarray, layout_block: int, causal: bool, device):
        key = (layout.tobytes(), layout.shape, layout_block, causal)
        if key not in self._store:
            table, counts, masks = compile_layout_tables(layout, layout_block, causal)
            self._store[key] = (torch.from_numpy(table), torch.from_numpy(counts),
                                pack_mask_bits(torch.from_numpy(masks)))
        dkey = key + (str(device),)
        if dkey not in self._device:
            self._device[dkey] = tuple(t.to(device) for t in self._store[key])
        return self._device[dkey]


_LAYOUTS = _LayoutCache()
# the f32 masks precompile_layout handed out -> their cached bits, so that
# ``tables=`` does not pack them again
_BITS_OF_MASKS = WeakTensorKeyDictionary()
# bits -> their compile_key_blocks tables: a second launch on the same
# tables compiles nothing
_KEY_BLOCKS = WeakTensorKeyDictionary()


def key_blocks_of(table, counts, bits) -> KeyBlocks:
    """``compile_key_blocks`` of these tables, compiled once per bits tensor."""
    kb = _KEY_BLOCKS.get(bits)
    if kb is None:
        kb = _KEY_BLOCKS[bits] = compile_key_blocks(table, counts, bits)
    return kb


_DEALS = WeakTensorKeyDictionary()   # bits -> {(b, h, blocks): deal_items on bits' device}


def _deal_of(kb, bits, b, h):
    """The deal of these tables' items at (b, h) to one block an SM (fewer
    when there are fewer items), made once per bits tensor and shape."""
    items = kb.order.numel() * h * b
    sms = torch.cuda.get_device_properties(bits.device).multi_processor_count
    blocks = min(items, sms)
    deals = _DEALS.setdefault(bits, {})
    if (b, h, blocks) not in deals:
        deals[(b, h, blocks)] = tuple(t.to(bits.device) for t in deal_items(
            kb.stage_start.cpu(), kb.order.cpu(), b, h, blocks))
    return (*deals[(b, h, blocks)], blocks)


def precompile_layout(layout, layout_block: int, causal: bool = False, device=None):
    """Host-side layout compilation: returns the (table, counts, masks)
    tensors of ``compile_layout_tables`` on ``device`` (None: the current
    CUDA device) to pass to ``sparse_flash_attention(..., tables=...)``."""
    layout, device = np.asarray(layout, bool), get_device(device)
    table, counts, bits = _LAYOUTS.on_device(layout, layout_block, causal, device)
    masks = unpack_mask_bits(bits).float()
    _BITS_OF_MASKS[masks] = bits
    return table, counts, masks


def _dense_reference(q, k, v, token_mask, scale):
    """Dense masked attention over (B, S, H, D) -- the backward-pass form."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~token_mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    # the product accumulates in f32 and rounds once, as XLA's does
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)


def token_mask_from_tiles(table, counts, bits):
    """The (S, S) bool token mask the tiles describe (padding slots add
    nothing), as the JAX backward reassembles it from its f32 tiles."""
    qt, ma = table.shape
    s = qt * TILE_Q
    kt = s // TILE_K
    valid = torch.arange(ma, device=table.device)[None, :] < counts[:, None]
    tiles = unpack_mask_bits(bits) & valid[:, :, None, None]
    dest = (torch.arange(qt, device=table.device)[:, None] * kt + table.long()).reshape(-1)
    full = torch.zeros(qt * kt, TILE_Q, TILE_K, dtype=torch.uint8, device=table.device)
    full.index_add_(0, dest, tiles.reshape(-1, TILE_Q, TILE_K).to(torch.uint8))
    return full.reshape(qt, kt, TILE_Q, TILE_K).permute(0, 2, 1, 3).reshape(s, s) > 0


def sparse_flash_plain(q, k, v, table, counts, bits, scale):
    """The plain version of K11: the TPU kernel's walk over each query
    tile's live key tiles in torch (f32 scores, online softmax with m
    starting at -1e30, p rounded to v's dtype before P.V, masked keys
    p = 0). q, k, v (B, S, H, D) with as many kv heads as query heads."""
    b, s, h, d = q.shape
    qt, ma = table.shape
    qf = q.float().transpose(1, 2).reshape(b, h, qt, TILE_Q, d)
    kf = k.float().transpose(1, 2).reshape(b, h, s // TILE_K, TILE_K, d)
    vt = v.transpose(1, 2).reshape(b, h, s // TILE_K, TILE_K, d)
    masks = unpack_mask_bits(bits)
    tbl = table.long()
    m = torch.full((b, h, qt, TILE_Q, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, qt, TILE_Q, d), device=q.device)
    for j in range(ma):
        mask = masks[:, j] & (j < counts)[:, None, None]          # (QT, TQ, TK)
        sc = (qf @ kf[:, :, tbl[:, j]].transpose(-1, -2)) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt[:, :, tbl[:, j]].float()
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, s, d).transpose(1, 2).to(q.dtype)


def _check(q, k, v, table, counts, bits):
    """Raise unless the kernel takes these CUDA tensors."""
    b, s, h, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"sparse_flash_fwd: no kernel for {q.device}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the block-sparse kernel is bf16; {q.dtype} is not ported yet "
            "(ROADMAP.md section B)")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"block-sparse kernel: head dim {d} not in {KERNEL_HEAD_DIMS} "
            "(ROADMAP.md section B)")
    qt = s // TILE_Q
    ma = table.shape[1] if table.dim() == 2 else -1
    want = {"q": (q, torch.bfloat16, (b, s, h, d)), "k": (k, torch.bfloat16, (b, s, h, d)),
            "v": (v, torch.bfloat16, (b, s, h, d)), "table": (table, torch.int32, (qt, ma)),
            "counts": (counts, torch.int32, (qt,)),
            "bits": (bits, torch.int32, (qt, ma, TILE_Q, TILE_K // 32))}
    if s % TILE_Q:
        raise ValueError(f"block-sparse kernel: seq {s} not a multiple of {TILE_Q}")
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != q.device:
            raise ValueError(f"sparse_flash_fwd: tensors on {t.device} and {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("block-sparse kernel takes contiguous 16-byte aligned tensors")


def sparse_flash_fwd(q, k, v, table, counts, bits, scale):
    """K11: block-sparse attention of q against k, v over the live tiles of
    (table, counts, bits); the kernel walks their live 16-key blocks
    (``key_blocks_of``). CUDA launches count in
    ``sparse_flash_fwd.launches``."""
    if q.device.type == "cpu":
        return sparse_flash_plain(q, k, v, table, counts, bits, scale)
    _check(q, k, v, table, counts, bits)
    b, s, h, d = q.shape
    kb = key_blocks_of(table, counts, bits)
    deal_start, deal, blocks = _deal_of(kb, bits, b, h)
    out = torch.empty_like(q)
    fn = op_builder.load("sparse_flash").ds_sparse_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in kb),
             deal_start.data_ptr(), deal.data_ptr(), blocks, out.data_ptr(), b, s, h, d, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block-sparse attention kernel launch failed: cudaError {err}")
    sparse_flash_fwd.launches += 1
    return out


sparse_flash_fwd.launches = 0

_KINDS = {"fwd": 0}


def kernel_info(kind, d):
    """The CUDA kernel that ``sparse_flash_fwd`` (``kind`` "fwd") launches
    at head dim ``d``, as the built library reports it: its ``variant``
    ("wgmma"), ``smem_bytes`` (dynamic shared memory a block) and
    ``threads`` a block. Builds the library if needed."""
    info = (ctypes.c_int * 3)()
    fn = op_builder.load("sparse_flash").ds_sparse_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(_KINDS[kind], int(d), info) != 0:
        raise ValueError(f"block-sparse attention: no {kind} kernel at head dim {d}")
    return {"variant": "wgmma" if info[0] else "wmma", "smem_bytes": info[1],
            "threads": info[2]}


class _SparseAttn(torch.autograd.Function):
    """Kernel forward; the backward recomputes the dense masked attention
    from the token mask the tiles describe."""

    @staticmethod
    def forward(ctx, q, k, v, table, counts, bits, scale):
        ctx.save_for_backward(q, k, v, table, counts, bits)
        ctx.scale = scale
        return sparse_flash_fwd(q, k, v, table, counts, bits, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, table, counts, bits = ctx.saved_tensors
        token = token_mask_from_tiles(table, counts, bits)
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = _dense_reference(qd, kd, vd, token, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None


def sparse_flash_attention(q, k, v, layout=None, *, layout_block: int, scale=None,
                           causal: bool = False, tables=None):
    """Block-sparse attention with a block-skipping forward kernel.

    q: (B, S, H, D), k/v: (B, S, KVH, D); layout: (S/layout_block,)² bool
    numpy array, or ``tables=precompile_layout(...)``. GQA repeats KV heads.
    Sequences that are no multiple of the kernel tile, or shorter than one,
    take the dense masked form."""
    _, s, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    scale = float(scale if scale is not None else d ** -0.5)
    if tables is None:
        layout = np.asarray(layout, bool)
        if s % TILE_Q or s < TILE_Q:
            token = np.repeat(np.repeat(layout, layout_block, 0), layout_block, 1)
            if causal:
                token &= np.tril(np.ones((s, s), bool))
            return _dense_reference(q, k, v, torch.from_numpy(token).to(q.device), scale)
        table, counts, bits = _LAYOUTS.on_device(layout, layout_block, causal, q.device)
    else:
        table, counts, masks = tables
        bits = _BITS_OF_MASKS.get(masks)
        if bits is None:
            bits = pack_mask_bits(masks)
    return _SparseAttn.apply(q.contiguous(), k.contiguous(), v.contiguous(), table, counts,
                             bits, scale)
