"""Token sampling for the serving frame.

Mirrors ``sample_logits_per_row`` of ``deepspeed_tpu/inference/sampling.py``
with a ``torch.Generator`` in place of a JAX key. Sampled rows cannot match
the JAX package token for token (Philox and threefry draw different bits);
greedy rows are exact.
"""

import torch


def sample_logits_per_row(logits, gen, temps):
    """Row-wise sampling: ``temps`` (B,) f32 rides in the frame carry, so
    rows with different settings share one batch. Rows with temp <= 0 take
    argmax; the rest sample at their own temperature (Gumbel-max, the same
    draw as a categorical). logits: (B, V) -> token ids (B,) int32."""
    greedy_toks = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32).clamp_min(torch.finfo(torch.float32).tiny)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy_toks, sampled)
