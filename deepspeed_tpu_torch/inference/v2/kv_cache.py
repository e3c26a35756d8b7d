"""Blocked (paged) KV cache.

Mirrors ``deepspeed_tpu/inference/v2/kv_cache.py`` for float pools: KV lives
in fixed-size blocks of a device pool and sequences hold block lists, so
memory scales with the tokens actually held instead of max_seq_len per
slot.

Layout: k/v pools are (L, KVH, num_blocks, block_size, D), kv-head-major,
so the paged attention kernel (``ops/paged_attention.py``) reads each
(page, head) slab contiguously in place. Block 0 is the trash block that
padded rows write to. The int8 page lanes and the page movers of the JAX
module are not ported yet (ROADMAP.md).
"""

import torch

from .blocked_allocator import BlockedAllocator


class BlockedKVCache:
    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int = 64,
                 dtype=torch.bfloat16, device=None):
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.lanes = head_dim
        shape = (num_layers, kv_heads, num_blocks, block_size, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
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
