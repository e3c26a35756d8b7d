"""Token sampling for the serving frame and for v1 generation.

Mirrors ``sample_logits_per_row`` and ``sample_logits`` of
``deepspeed_tpu/inference/sampling.py`` with a ``torch.Generator`` in place
of a JAX key. Sampled rows cannot match the JAX package token for token
(Philox and threefry draw different bits); greedy rows are exact.
"""

import torch


def _categorical(logits, gen):
    """One draw per row from softmax(logits) by Gumbel-max (the same draw
    as a categorical); -inf entries are never drawn."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32).clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


def sample_logits(logits, gen, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, greedy: bool = False):
    """logits: (B, V) -> token ids (B,) int32. Greedy (or temperature 0)
    takes the first argmax; otherwise the logits are divided by the
    temperature, cut to the ``top_k`` largest (ties with the k-th kept) and
    to the smallest prefix of the sorted distribution whose mass reaches
    ``top_p`` (the token that crosses it kept), and one token is drawn with
    ``gen``."""
    if greedy or temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = logits.sort(dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # every prefix short of top_p (by rounding): cut at the smallest
        # logit, which keeps every token, as JAX's out-of-range gather does
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp_max(logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return _categorical(logits, gen)


def sample_logits_per_row(logits, gen, temps):
    """Row-wise sampling: ``temps`` (B,) f32 rides in the frame carry, so
    rows with different settings share one batch. Rows with temp <= 0 take
    argmax; the rest sample at their own temperature (Gumbel-max, the same
    draw as a categorical). logits: (B, V) -> token ids (B,) int32."""
    greedy_toks = logits.argmax(dim=-1).to(torch.int32)
    sampled = _categorical(logits / temps.clamp_min(1e-6)[:, None], gen)
    return torch.where(temps <= 0.0, greedy_toks, sampled)
