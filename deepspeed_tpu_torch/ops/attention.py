"""Attention op dispatch: training, full-sequence forward and KV-cache decode.

Mirrors ``deepspeed_tpu/ops/attention.py``: one call site for the models.
The flash kernels (``ops/flash_attention.py``) take every eligible shape on
the card, with the JAX rules and "the tensors are on CUDA" in place of
``_use_pallas()``: S >= 128 with q and k of one length, D in {64, 128,
256}, no additive bias, no softcap and a static causal window. Everything
else runs the plain reference path, as in JAX. There is no try/except
around the kernel and no switch that turns it off: a shape the dispatch
sends to the kernel launches it or raises. The kernels are bf16, so an
eligible f16 or f32 shape on the card raises there; it never takes the
reference path in their place.

The JAX package's sequence-parallel paths (``impl="ring"``, and Ulysses
over a seq-sharded mesh) are not ported: the port runs on one card.

``decode_attention`` (the v1 inference path) keeps the JAX routing rule:
single-token decode over a cache of S_max >= 8192 slots (S_max % 128 == 0,
D % 64 == 0, no bias, window or softcap) on the card launches the fused
decode kernel (``ops/decode_attention.py``); every other call runs the
masked einsum, the JAX function's own non-Pallas branch. As for the flash
dispatch there is no try/except around the kernel. The 8192 crossover is
the JAX package's; the H100's own crossover is recorded in PERF.md and not
acted on here.
"""

from typing import Optional

import torch

from .decode_attention import fused_decode_attention
from .flash_attention import KERNEL_HEAD_DIMS, flash_attention

# f32 scores of one masked-einsum pass: query rows are taken in chunks so
# that a prefill over a long cache never holds more than this at once
DECODE_LOGITS_BYTES = 1 << 30
NOT_PORTED_SEQUENCE = ("sequence-parallel attention (ring, Ulysses) is not ported "
                       "yet: ROADMAP.md section A, item 16")


def _on_card(t) -> bool:
    """The auto dispatch's device rule (the JAX ``_use_pallas()``)."""
    return t.is_cuda


def window_mask(q_pos, k_pos, window):
    """Sliding-window visibility: key k is visible to query q iff
    q - k < window; ``window`` may be a tensor, and window <= 0 means
    global (the per-layer local/global sentinel)."""
    w = torch.as_tensor(window, dtype=torch.int32, device=q_pos.device)
    return (q_pos - k_pos < w) | (w <= 0)


def reference_attention(q, k, v, *, causal=True, bias=None, segment_ids=None, scale=None,
                        window=None, softcap=0.0):
    """Plain attention: (B, S, H, D) x (B, S, KVH, D) -> (B, S, H, D).

    GQA by repeating kv heads; f32 scores and softmax (the products of the
    inputs' values accumulated in f32, as JAX's ``preferred_element_type``);
    probabilities cast to q's dtype before P.V. ``softcap`` is applied to
    the scaled scores (+ bias) before masking; masked scores take the f32
    minimum, as the JAX reference does."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    sk = k.shape[1]
    neg = torch.finfo(torch.float32).min
    if causal or window is not None:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        mask = q_pos >= k_pos if causal else torch.ones(sq, sk, dtype=torch.bool,
                                                        device=q.device)
        if window is not None:
            mask = mask & window_mask(q_pos, k_pos, window)
        logits = torch.where(mask[None, None], logits, neg)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = torch.where(seg[:, None], logits, neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _alibi_bias_from_slopes(slopes, sq, sk):
    """(H,) slopes -> (1, H, Sq, Sk) additive f32 bias (the reference path)."""
    q_pos = torch.arange(sq, device=slopes.device) + (sk - sq)
    k_pos = torch.arange(sk, device=slopes.device)
    rel = (k_pos[None, :] - q_pos[:, None]).float()
    return (slopes.float()[:, None, None] * rel)[None]


def _reference_with_slopes(q, k, v, causal, bias, alibi_slopes, segment_ids,
                           scale, window, softcap=0.0):
    """The single reference entry: expand ALiBi slopes to a bias, then run
    ``reference_attention``."""
    if alibi_slopes is not None and bias is None:
        bias = _alibi_bias_from_slopes(alibi_slopes, q.shape[1], k.shape[1])
    return reference_attention(q, k, v, causal=causal, bias=bias,
                               segment_ids=segment_ids, scale=scale,
                               window=window, softcap=softcap)


def multihead_attention(q, k, v, *, causal=True, bias=None, segment_ids=None, scale=None,
                        window=None, alibi_slopes=None, impl: Optional[str] = None,
                        softcap=0.0):
    """Dispatching attention entry point.

    q: (B, S, H, D); k/v: (B, S, KVH, D). Returns (B, S, H, D).
    impl: None (auto) | "reference" | "flash". ``window``: an int >= S or
    <= 0 cannot bind and is dropped; a tensor window (per-layer patterns)
    takes the reference path. ``alibi_slopes``: (H,) slopes, built
    in-kernel by the flash path and expanded to a bias for the reference
    path; not differentiated; exclusive with ``bias``."""
    if bias is not None and alibi_slopes is not None:
        raise ValueError(
            "pass either an explicit additive bias or alibi_slopes, not "
            "both (the slopes would be silently dropped)")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(NOT_PORTED_SEQUENCE)
    if isinstance(window, int) and (window >= q.shape[1] or window <= 0):
        window = None   # cannot bind (or the <= 0 "global" sentinel)
    flash_window_ok = window is None or (isinstance(window, int) and causal)
    if impl == "flash" and (bias is not None or not flash_window_ok or softcap):
        raise NotImplementedError(
            "the flash kernels do not take an additive attention bias, a "
            "tensor or non-causal sliding window, or logit softcapping; use "
            "attn_impl='reference' (auto dispatch already routes these there)")
    if impl == "flash" or (
            impl is None and _on_card(q)
            and q.shape[1] >= 128 and k.shape[1] == q.shape[1]
            and q.shape[3] in KERNEL_HEAD_DIMS and bias is None and not softcap
            and flash_window_ok):
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               scale=scale, alibi_slopes=alibi_slopes, window=window)
    return _reference_with_slopes(q, k, v, causal, bias, alibi_slopes,
                                  segment_ids, scale, window, softcap)


def decode_attention(q, k_cache, v_cache, cache_len, *, bias=None, scale=None,
                     window=None, softcap=0.0):
    """Decode/prefill attention against a (B, S_max, KVH, D) KV cache.

    q: (B, S_new, H, D); the S_new query tokens occupy cache slots
    [cache_len - S_new, cache_len), and key slot k is visible to query i iff
    k < cache_len - S_new + i + 1. ``bias``: optional additive
    (B, H, S_new, S_max) bias (ALiBi), which routes around the fused kernel.
    ``window``: sliding-window width (int or tensor; <= 0 is global).

    Single-token decode over a long cache on the card runs the fused decode
    kernel; everything else the masked einsum (``masked_decode_attention``),
    in chunks of query rows whose f32 scores stay under
    ``DECODE_LOGITS_BYTES`` (the same masked softmax per row). A sequence
    whose query sees no slot (``cache_len`` 0 at decode) takes a uniform
    softmax over the masked scores there, as in JAX, where the fused kernel
    gives 0."""
    s_new, h, d = q.shape[1:]
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    if isinstance(window, int) and window >= s_max:
        window = None   # cannot bind within this cache
    if (s_new == 1 and bias is None and window is None and not softcap
            and _on_card(q) and s_max >= 8192 and s_max % 128 == 0
            and d % 64 == 0 and h % kvh == 0):
        return fused_decode_attention(q[:, 0], k_cache, v_cache, cache_len,
                                      scale=scale)[:, None]
    return masked_decode_attention(q, k_cache, v_cache, cache_len, bias=bias, scale=scale,
                                   window=window, softcap=softcap)


def masked_decode_attention(q, k_cache, v_cache, cache_len, *, bias=None, scale=None,
                            window=None, softcap=0.0):
    """The masked-einsum branch of ``decode_attention`` (same arguments):
    f32 scores over every cache slot, masked to the causal (and window)
    slots, softmax, probabilities cast to q's dtype before P.V."""
    b, s_new, h, d = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    if kvh != h:
        k_cache = k_cache.repeat_interleave(h // kvh, dim=2)
        v_cache = v_cache.repeat_interleave(h // kvh, dim=2)
    scale = scale if scale is not None else d ** -0.5
    k_t = k_cache.float().permute(0, 2, 3, 1).contiguous()                  # (B, H, D, S_max)
    v_h = v_cache.transpose(1, 2).contiguous()                               # (B, H, S_max, D)
    k_pos = torch.arange(s_max, device=q.device)[None, None, :]              # (1, 1, S_max)
    q_start = cache_len.to(q.device).long()[:, None] - s_new                 # (B, 1)
    neg = torch.finfo(torch.float32).min
    rows = max(1, DECODE_LOGITS_BYTES // (4 * b * h * s_max))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, s_new, rows):
        r1 = min(s_new, r0 + rows)
        logits = (q[:, r0:r1].float().transpose(1, 2) @ k_t) * scale      # (B, H, R, S_max)
        if bias is not None:
            logits = logits + bias[:, :, r0:r1]
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        q_pos = q_start + torch.arange(r0, r1, device=q.device)[None, :]     # (B, R)
        mask = k_pos <= q_pos[:, :, None]                                     # (B, R, S_max)
        if window is not None:
            mask = mask & window_mask(q_pos[:, :, None], k_pos, window)
        logits = torch.where(mask[:, None], logits, neg)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out[:, r0:r1] = (probs @ v_h).transpose(1, 2)
    return out
