"""Blocked (paged) KV cache.

Mirrors ``deepspeed_tpu/inference/v2/kv_cache.py``: KV lives in fixed-size
blocks of a device pool and sequences hold block lists, so memory scales
with the tokens actually held instead of max_seq_len per slot.

Layout: k/v pools are (L, KVH, num_blocks, block_size, lanes),
kv-head-major, so the paged attention kernel (``ops/paged_attention.py``)
reads each (page, head) slab contiguously in place. Block 0 is the trash
block that padded rows write to. Under tensor parallelism a rank's pools
hold its KVH / tp kv heads (``kv_heads`` is the local count); block ids,
the allocator and ``blocks_for`` are the same on every rank.

Quantized pages (``kv_dtype="int8"``): the pools are int8 and each
(token, head) row is D quantized values followed by its f32 absmax scale
stored as 4 int8 lanes (``quantize_kv_lanes`` / ``dequantize_kv_lanes``),
byte for byte the rows the JAX package writes. A page stays one int8 array,
so block tables and the page movers move the quantized rows unchanged.

The page movers (``copy_blocks``, ``read_pages``, ``scatter_pages``) are
frame-boundary operations on block ids padded to power-of-two buckets with
the trash block. JAX donates the pools and returns the new ones; the port
updates the pools in place and returns them, so call sites read the same
(``kv.k, kv.v = kv.copy_blocks(kv.k, kv.v, src, dst)``).
"""

from typing import List, Optional

import numpy as np
import torch

from .blocked_allocator import BlockedAllocator

# int8 lanes appended to each quantized page row: the row's f32 absmax
# scale, its bytes read as int8, so a page stays a single int8 array
KV_SCALE_LANES = 4


def quantize_kv_lanes(x):
    """Quantize ``(..., D)`` float rows to packed ``(..., D + 4)`` int8 page
    rows (JAX ``kv_cache.py`` ``quantize_kv_lanes``): symmetric absmax int8
    values, rounded half to even and clipped to +-127, then the f32 scale's
    four bytes in the trailing lanes. All-zero rows get scale 0. Both
    divisions divide by a tensor on x's device: the card multiplies by the
    reciprocal when the divisor is a Python number, which changes the last
    bit of some scales."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    live = scale > 0
    q = torch.where(live, torch.round(x32 / torch.where(live, scale, torch.ones_like(scale))),
                    torch.zeros_like(x32))
    q = q.clamp(-127, 127).to(torch.int8)
    return torch.cat([q, scale.contiguous().view(torch.int8)], dim=-1)


def dequantize_kv_lanes(packed, dtype):
    """Unpack ``(..., D + 4)`` int8 page rows to ``(..., D)`` in ``dtype``
    (JAX ``dequantize_kv_lanes``). A scale whose bytes read as NaN or inf
    (pool rows never written, the trash block) is taken as 0, so such rows
    read as 0 instead of poisoning the attention."""
    q = packed[..., :-KV_SCALE_LANES]
    scale = packed[..., -KV_SCALE_LANES:].contiguous().view(torch.float32)   # (..., 1)
    scale = torch.where(torch.isfinite(scale), scale, torch.zeros_like(scale))
    return (q.float() * scale).to(dtype)


class BlockedKVCache:
    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int = 64,
                 dtype=torch.bfloat16, device=None, kv_dtype: Optional[str] = None):
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.num_blocks = num_blocks
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.quantized = kv_dtype == "int8"
        # pool row width: head_dim floats, or head_dim int8 + scale lanes
        self.lanes = head_dim + KV_SCALE_LANES if self.quantized else head_dim
        pool_dtype = torch.int8 if self.quantized else dtype
        shape = (num_layers, kv_heads, num_blocks, block_size, self.lanes)
        self.k = torch.zeros(shape, dtype=pool_dtype, device=device)
        self.v = torch.zeros(shape, dtype=pool_dtype, device=device)
        self.allocator = BlockedAllocator(num_blocks)

    @property
    def block_bytes(self) -> int:
        """Resident device bytes per block across BOTH pools."""
        per_row = self.lanes * self.k.element_size()
        return 2 * self.num_layers * self.kv_heads * self.block_size * per_row

    def blocks_for(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def reserve_trash_block(self) -> None:
        """Pin block 0 as the trash block: padded/frozen rows' writes are
        routed there, so it must never be handed to a sequence. Call once,
        right after construction."""
        got = self.allocator.allocate(1)
        assert got == [0], "trash block must be block 0 (allocate first)"

    @staticmethod
    def bucket_width(need: int, cap: int) -> int:
        """Next power of two >= ``need``, clamped to ``cap`` (the shape
        buckets of block-table and prompt widths)."""
        w = 1
        while w < min(need, cap):
            w *= 2
        return min(w, cap)

    @staticmethod
    def floor_pow2(n: float) -> int:
        """Largest power of two <= ``n`` (min 1): the frame-steps buckets."""
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def write(self, block_ids, start_pos: int, new_k, new_v) -> None:
        """Scatter S new tokens into the pools (JAX ``write``). block_ids:
        (max_blocks,) block table of the sequence; new_k/new_v:
        (L, S, KVH, D) float rows. Quantized pools are written only by the
        serving forward, which quantizes at append."""
        if self.quantized:
            raise NotImplementedError(
                "write() takes raw float rows; quantized pools are written "
                "by the compiled loops via quantize_kv_lanes")
        dev = self.k.device
        block_ids = torch.as_tensor(block_ids, device=dev).long()
        pos = start_pos + torch.arange(new_k.shape[1], device=dev)
        blk = block_ids[pos // self.block_size]
        off = pos % self.block_size
        self.k[:, :, blk, off] = new_k.permute(0, 2, 1, 3).to(self.k.dtype)
        self.v[:, :, blk, off] = new_v.permute(0, 2, 1, 3).to(self.v.dtype)

    # ------------------------------------------------------------------
    # page movement (frame-boundary operations of the KV hierarchy)
    # ------------------------------------------------------------------

    def _pad_ids(self, ids: List[int], pad: int = 0):
        """``ids`` padded to their power-of-two bucket with ``pad`` (the
        trash block), as a long tensor on the pools' device (JAX
        ``_pad_ids``)."""
        w = self.bucket_width(max(len(ids), 1), self.num_blocks)
        out = np.full((w,), pad, np.int64)
        out[:len(ids)] = ids
        return torch.from_numpy(out).to(self.k.device)

    def copy_blocks(self, kpool, vpool, src_ids: List[int], dst_ids: List[int]):
        """Copy whole pages src[i] -> dst[i] in place (JAX ``copy_blocks``,
        the copy-on-write block copy); pad pairs copy the trash block onto
        itself. Returns the pools."""
        if len(src_ids) != len(dst_ids):
            raise ValueError(f"copy_blocks: {len(src_ids)} sources for {len(dst_ids)} "
                             "destinations")
        src, dst = self._pad_ids(src_ids), self._pad_ids(dst_ids)
        kpool[:, :, dst] = kpool[:, :, src]
        vpool[:, :, dst] = vpool[:, :, src]
        return kpool, vpool

    def read_pages(self, block_ids: List[int]):
        """Pages ``block_ids`` of both pools as host tensors, each
        (L, KVH, n, bs, lanes) in the pool's dtype (JAX ``read_pages``):
        one device-to-host copy a pool."""
        ids = self._pad_ids(block_ids)
        n = len(block_ids)
        return (self.k.index_select(2, ids).cpu()[:, :, :n],
                self.v.index_select(2, ids).cpu()[:, :, :n])

    def scatter_pages(self, kpool, vpool, block_ids: List[int], k_pages, v_pages):
        """Write page payloads (host tensors or numpy arrays, as
        ``read_pages`` gives them) into the pools at ``block_ids``, in
        place (JAX ``scatter_pages``); returns the pools. A payload whose dtype is not the pool's is
        refused: a blind cast would turn quantized scale lanes into garbage.
        Pad ids are 0: the padding rows land in the trash block."""
        k_pages, v_pages = torch.as_tensor(k_pages), torch.as_tensor(v_pages)
        for nm, pages, pool in (("k", k_pages, kpool), ("v", v_pages, vpool)):
            if pages.dtype != pool.dtype:
                raise ValueError(
                    f"scatter_pages: {nm}-page payload dtype {pages.dtype} "
                    f"!= pool dtype {pool.dtype} — refusing the mixed-dtype "
                    "move (stale tier record from a differently-quantized "
                    "pool?); re-ingest the sequence instead")
        ids = self._pad_ids(block_ids)
        w, n = int(ids.shape[0]), len(block_ids)
        if w > n:   # pad payload rows to the id bucket (land in trash)
            pad = (0, 0, 0, 0, 0, w - n)
            k_pages = torch.nn.functional.pad(k_pages, pad)
            v_pages = torch.nn.functional.pad(v_pages, pad)
        kpool[:, :, ids] = k_pages.to(kpool.device)
        vpool[:, :, ids] = v_pages.to(vpool.device)
        return kpool, vpool

    def gather(self, block_table):
        """JAX ``gather``: block_table (B, max_blocks) -> (L, B,
        max_blocks * block_size, KVH, lanes) contiguous logical view of both pools (padding blocks
        read block 0; callers mask by sequence length). Quantized pools give
        their packed rows (dequantize with ``dequantize_kv_lanes``)."""
        bt = torch.as_tensor(block_table, device=self.k.device).long()
        out = []
        for pool in (self.k, self.v):
            p = pool[:, :, bt]                  # (L, KVH, B, MB, bs, lanes)
            l, kvh, b, nb, bs, d = p.shape
            out.append(p.reshape(l, kvh, b, nb * bs, d).permute(0, 2, 3, 1, 4))
        return tuple(out)
