"""KV block allocator.

Mirrors ``deepspeed_tpu/inference/v2/blocked_allocator.py`` unchanged (it is
plain Python; the port keeps its own copy). Analog of the reference's
``inference/v2/ragged/blocked_allocator.py`` (BlockedAllocator):
free-list over a fixed pool of KV-cache blocks. Host-side bookkeeping — the
device only ever sees block-id tensors.

REFCOUNTED for the prefix cache (README "KV memory hierarchy"): a block may
be mapped read-only into several sequences' block tables at once (shared
prompt prefixes) plus held by the host-side prefix index. ``allocate``
hands out blocks at refcount 1; ``share`` adds a reference for an existing
mapping; ``free`` drops one reference per listed block and only returns a
block to the free list when its count reaches zero. Callers that never
share (the training/offload paths, cache-off serving) see the exact
pre-refcount semantics: every allocate is ref 1 and every free releases.
"""

from collections import Counter
from typing import Dict, Iterable, List


class BlockedAllocator:
    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        # block id -> reference count; absent = free (count 0)
        self._ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def allocate(self, num_blocks: int) -> List[int]:
        if num_blocks > len(self._free):
            raise RuntimeError(f"Out of KV blocks: requested {num_blocks}, "
                               f"free {len(self._free)}/{self._num_blocks}")
        taken, self._free = self._free[:num_blocks], self._free[num_blocks:]
        for b in taken:
            self._ref[b] = 1
        return taken

    def share(self, blocks: Iterable[int]) -> None:
        """Add one reference per listed block (mapping an already-allocated
        block into another sequence's table, or pinning it in the prefix
        index). Sharing a free block is a bug — it could be handed out by
        ``allocate`` while the 'sharer' believes it owns the content."""
        for b in blocks:
            if b not in self._ref:
                raise RuntimeError(f"share() of free KV block {b}")
            self._ref[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block; blocks reaching refcount 0
        return to the free list. Releasing more references than a block
        holds — including the same block listed twice in one call — raises
        (the historical double-free guard, now per-reference)."""
        counts = Counter(blocks)
        bad = [b for b, n in counts.items() if self._ref.get(b, 0) < n]
        if bad:
            raise RuntimeError(f"double-free of KV blocks {sorted(bad)}")
        for b, n in counts.items():
            self._ref[b] -= n
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
