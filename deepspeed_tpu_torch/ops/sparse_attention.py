"""Block-sparse attention.

Mirrors ``deepspeed_tpu/ops/sparse_attention.py`` (the reference's
``deepspeed/ops/sparse_attention``): attention restricted to a block-level
sparsity pattern (fixed / bigbird / bslongformer / dense). A pattern is a
(num_blocks, num_blocks) boolean numpy layout, built by the same numpy code
as the JAX package's (BigBird's ``default_rng(seed)`` draws included), so
the two packages give identical layouts.

``SparseSelfAttention`` routes a CUDA tensor whose sequence is a multiple
of the kernel's 128-row tile through the block-skipping Hopper kernel
(``ops/sparse_flash.py``, K11); otherwise, or with ``use_kernel=False``, it
computes the dense masked form.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SparsityConfig:
    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        return np.ones((n, n), bool)


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Reference FixedSparsityConfig: local window + periodic global blocks."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"   # or "unidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        layout = np.zeros((n, n), bool)
        for i in range(n):
            w0 = (i // self.num_local_blocks) * self.num_local_blocks
            layout[i, w0:w0 + self.num_local_blocks] = True
            for g in range(self.num_global_blocks):
                layout[i, g::self.num_local_blocks] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))
        return layout


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for i in range(n):
            layout[i, max(0, i - half):min(n, i + half + 1)] = True
            layout[i, :self.num_global_blocks] = True
            layout[:self.num_global_blocks, i] = True
            rnd = rng.choice(n, size=min(self.num_random_blocks, n), replace=False)
            layout[i, rnd] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))
        return layout


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(0, i - half):min(n, i + half + 1)] = True
        for g in self.global_block_indices:
            layout[:, g] = True
            layout[g, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))
        return layout


class SparseSelfAttention:
    """Reference-named module: applies attention under a block-sparse layout."""

    def __init__(self, sparsity_config: SparsityConfig, max_seq_length: int = 2048):
        self.config = sparsity_config
        self.max_seq_length = max_seq_length
        self._layouts = {}

    def layout(self, seq_len: int) -> np.ndarray:
        """The (n, n) bool block layout for ``seq_len``, built once: the
        BigBird and Fixed builders loop over block rows on the host, which
        would cost milliseconds on every call."""
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, q, k, v, causal: Optional[bool] = None,
                 use_kernel: Optional[bool] = None):
        """q: (B, S, H, D), k/v: (B, S, KVH, D) -> (B, S, H, D).

        ``use_kernel`` (default: auto, a CUDA tensor with S a multiple of
        the kernel's 128-row tile) routes the forward through the
        block-skipping kernel (``ops/sparse_flash.py``): cost scales with
        the live tiles, not S². On a CPU tensor the kernel route runs its
        plain version. The dense masked form is the other route."""
        from .sparse_flash import TILE_Q, sparse_flash_attention
        s = q.shape[1]
        block = self.config.block
        if s % block:
            raise ValueError(f"seq {s} not divisible by block {block}")
        is_causal = bool(causal or self.config.attention == "unidirectional")
        if use_kernel is None:
            use_kernel = q.device.type == "cuda" and s % TILE_Q == 0 and s >= TILE_Q
        if use_kernel:
            return sparse_flash_attention(q, k, v, self.layout(s), layout_block=block,
                                          causal=is_causal)
        layout = torch.from_numpy(self.layout(s)).to(q.device)
        token_mask = layout.repeat_interleave(block, 0).repeat_interleave(block, 1)
        if is_causal:
            token_mask = torch.tril(token_mask)
        d, h, kvh = q.shape[-1], q.shape[2], k.shape[2]
        if kvh != h:
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
        logits = logits.masked_fill(~token_mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        # the product accumulates in f32 and rounds once, as XLA's does
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return out.to(torch.promote_types(q.dtype, v.dtype))
