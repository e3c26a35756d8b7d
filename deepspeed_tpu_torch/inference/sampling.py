"""Token sampling for the serving frame and for v1 generation.

Mirrors ``sample_logits_per_row``, ``speculative_verify_per_row`` and
``sample_logits`` of ``deepspeed_tpu/inference/sampling.py`` with a
``torch.Generator`` in place of a JAX key. Sampled rows cannot match the
JAX package token for token (Philox and threefry draw different bits), so
they are held to their law; greedy rows are exact.
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


def speculative_verify_per_row(target_logits, draft_logits, draft_toks, temps, gen=None):
    """Per-row draft verification of the speculative serving frame (JAX
    ``speculative_verify_per_row``): how many drafted tokens survive and the
    token that follows them, on the device.

    target_logits: (B, G + 1, V) the target's logits at the verified
    positions (0: the committed last token; 1..G: the drafts); draft_logits:
    (B, G, V) the draft's proposal logits; draft_toks: (B, G); temps: (B,).
    Returns (n_accept (B,) int32 in [0, G], replacement (B,) int32): the
    count of leading accepted drafts and the token emitted after them (the
    target's continuation on full acceptance, its correction at the first
    rejection otherwise).

    Rows with temp <= 0 accept while the draft equals the target's argmax,
    which makes speculative output identical to greedy decoding. Rows with
    temp > 0 use Leviathan rejection sampling: accept draft j with
    probability min(1, p_t / p_d); at the first rejection draw from the
    normalized residual max(p_t - p_d, 0) (p_t itself past the last draft,
    or where the residual is all zero, as for a self-draft). ``gen`` (a
    ``torch.Generator`` on the logits' device) supplies the uniforms and the
    residual draw; None means every row is greedy and nothing is drawn."""
    g = draft_toks.shape[1]
    tgt_greedy = target_logits.argmax(dim=-1).to(torch.int32)          # (B, G+1)
    match = (draft_toks == tgt_greedy[:, :g]).to(torch.int32)
    # leading-ones count: cumprod zeroes everything after the first mismatch
    greedy_acc = match.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
    greedy_repl = torch.gather(tgt_greedy, 1, greedy_acc[:, None].long())[:, 0]
    if gen is None:
        return greedy_acc, greedy_repl
    t = temps.clamp_min(1e-6)[:, None, None]
    p_t = torch.softmax(target_logits.float() / t, dim=-1)
    p_d = torch.softmax(draft_logits.float() / t, dim=-1)
    idx_q = draft_toks[..., None].long()
    pt_q = torch.gather(p_t[:, :g], -1, idx_q)[..., 0]
    pd_q = torch.gather(p_d, -1, idx_q)[..., 0]
    u = torch.rand(draft_toks.shape, generator=gen, device=draft_toks.device,
                   dtype=torch.float32)
    accept = (u * pd_q <= pt_q).to(torch.int32)        # accept w.p. min(1, pt/pd)
    samp_acc = accept.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
    n_acc = torch.where(temps <= 0.0, greedy_acc, samp_acc)
    # the residual at the first rejected position; past the last draft there
    # is no draft distribution, so p_d pads with zeros and the residual is p_t
    pd_pad = torch.cat([p_d, torch.zeros_like(p_d[:, :1])], dim=1)
    at = n_acc.long()[:, None, None].expand(-1, 1, p_t.shape[-1])
    p_t_at = torch.gather(p_t, 1, at)[:, 0]                             # (B, V)
    p_d_at = torch.gather(pd_pad, 1, at)[:, 0]
    res = (p_t_at - p_d_at).clamp_min(0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0.0, res, p_t_at)
    sampled_repl = _categorical(torch.log(res + 1e-30), gen)
    return n_acc, torch.where(temps <= 0.0, greedy_repl, sampled_repl)
