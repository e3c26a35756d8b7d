"""Evoformer (DS4Science) attention.

Mirrors ``deepspeed_tpu/ops/evoformer.py`` (the reference's
``deepspeed/ops/deepspeed4science/evoformer_attn.py``): attention over
AlphaFold-style 5-D activations (batch, rows, seq, heads, dim) with up to
two additive biases, a per-row mask bias (B, N, 1, 1, S) and a pairwise
bias (B, 1, H, S, S).

Dispatch: on a CUDA tensor of an eligible shape (``evoformer_flash_supported``)
the forward is the fused bias-flash kernel (``ops/evoformer_flash.py``, K12)
and the backward a query-chunked recompute, which also yields the bias
gradients; on the card that route runs the kernel or raises. Other shapes,
and CPU tensors, take the query-chunked torch path end to end (autograd
through it). The JAX dispatcher's catch of a kernel failure, which falls
back to the chunked path, and its environment kill switch have no
counterpart (ROADMAP.md section C).
"""

from typing import Sequence

import torch

from .evoformer_flash import evoformer_flash_fwd, evoformer_flash_supported, prescale


def _bias_shapes(q):
    b, n, s, h = q.shape[:4]
    return (b, n, 1, 1, s), (b, 1, h, s, s)


def _use_kernel(q) -> bool:
    return q.device.type == "cuda"


def DS4Sci_EvoformerAttention(q, k, v, biases: Sequence = (), chunk: int = 256):
    """q/k/v: (B, N, S, H, D); biases: up to two of
    [(B, N, 1, 1, S) mask bias, (B, 1, H, S, S) pair bias].
    Returns (B, N, S, H, D) in q's dtype."""
    biases = [b for b in biases if b is not None]
    if len(biases) > 2:
        raise ValueError("at most two biases (mask, pair)")
    bias1 = bias2 = None
    s1, s2 = _bias_shapes(q)
    for b in biases:
        if tuple(b.shape) == s1:
            bias1 = b
        elif tuple(b.shape) == s2:
            bias2 = b
        else:
            raise ValueError(f"bias shape {tuple(b.shape)} matches neither mask "
                             f"{s1} nor pair {s2}")
    if _use_kernel(q) and evoformer_flash_supported(q.shape[2], q.shape[4]):
        return _EvoAttn.apply(q, k, v, bias1, bias2, chunk)
    return _chunked(q, k, v, bias1, bias2, chunk)


class _EvoAttn(torch.autograd.Function):
    """Kernel forward; the backward recomputes through ``_chunked`` (the
    same math, peak memory O(chunk * S) a (row, head) in its forward) and
    returns the gradients of q, k, v and of both biases."""

    @staticmethod
    def forward(ctx, q, k, v, bias1, bias2, chunk):
        ctx.save_for_backward(q, k, v, bias1, bias2)
        ctx.chunk = chunk
        out = evoformer_flash_fwd(q.movedim(3, 2), k.movedim(3, 2), v.movedim(3, 2),
                                  bias1, bias2, scale=q.shape[-1] ** -0.5)
        return out.movedim(2, 3)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            out = _chunked(*inputs, ctx.chunk)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*[next(grads) if t is not None and t.requires_grad else None
                  for t in inputs], None)


def _chunked(q, k, v, bias1, bias2, chunk: int = 256):
    """Attention over query chunks of ``chunk`` rows: f32 logits of the
    pre-scaled q plus the biases, softmax, probabilities in v's dtype."""
    s, d = q.shape[2], q.shape[4]
    # (B, N, S, H, D) -> (B, N, H, S, D)
    qt = prescale(q.movedim(3, 2), d ** -0.5)
    kt = k.movedim(3, 2).float()
    vt = v.movedim(3, 2)
    chunk = min(chunk, s)
    outs = []
    for c0 in range(0, s, chunk):
        logits = qt[:, :, :, c0:c0 + chunk].float() @ kt.transpose(-1, -2)
        if bias1 is not None:
            logits = logits + bias1.float()                       # (B, N, 1, 1, S)
        if bias2 is not None:
            logits = logits + bias2[:, :, :, c0:c0 + chunk].float()   # (B, 1, H, chunk, S)
        probs = torch.softmax(logits, dim=-1)
        # the product accumulates in f32 and rounds once, as XLA's does
        outs.append((probs.to(vt.dtype).float() @ vt.float()).to(vt.dtype))
    return torch.cat(outs, dim=3).movedim(2, 3).to(q.dtype)   # back to (B, N, S, H, D)
