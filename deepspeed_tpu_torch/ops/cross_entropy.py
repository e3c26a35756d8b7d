"""Fused, vocab-chunked softmax cross-entropy.

Mirrors ``deepspeed_tpu/ops/cross_entropy.py``: the LM loss without
materializing the (N, V) logits. The forward runs the lm-head product,
an online logsumexp and the label gather chunk by chunk over the vocab;
the backward recomputes each chunk's logits to form dlogits on the fly and
feeds the dh / dW products per chunk. Plain torch (the JAX package has no
Pallas kernel here). Logits are rounded to the activation dtype before the
f32 softmax, as the dense path's ``lm_head_logits`` rounds them.
"""

import torch
import torch.nn.functional as F

DEFAULT_CHUNKS = 8


def _chunks(w, n_chunks):
    """(V, E) -> (n_chunks, C, E) with the vocab zero-padded to a multiple
    of n_chunks, and C."""
    v = w.shape[0]
    vp = (v + n_chunks - 1) // n_chunks * n_chunks
    if vp != v:
        w = F.pad(w, (0, 0, 0, vp - v))
    return w.reshape(n_chunks, vp // n_chunks, w.shape[1]), vp // n_chunks


def _chunk_logits(h, w_c, softcap):
    """(N, C) f32 logits of one chunk; with ``softcap`` also d(capped)/d(raw)."""
    logits = (h @ w_c.t()).float()
    if not softcap:
        return logits, None
    capped = softcap * torch.tanh(logits / softcap)
    return capped, 1.0 - torch.square(capped / softcap)


class _ChunkedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, n_chunks, softcap):
        n = h.shape[0]
        v = w.shape[0]
        w_chunks, c = _chunks(w, n_chunks)
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=h.device)
        s = torch.zeros(n, dtype=torch.float32, device=h.device)
        ll = torch.zeros(n, dtype=torch.float32, device=h.device)
        for idx in range(n_chunks):
            logits, _ = _chunk_logits(h, w_chunks[idx], softcap)
            col = idx * c + torch.arange(c, device=h.device)
            logits = logits.masked_fill(col[None, :] >= v, float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
            in_chunk = (labels >= idx * c) & (labels < (idx + 1) * c)
            local = (labels - idx * c).clamp(0, c - 1)
            ll = ll + torch.where(in_chunk, logits.gather(1, local[:, None])[:, 0], 0.0)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.n_chunks, ctx.softcap = n_chunks, softcap
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        n_chunks, softcap = ctx.n_chunks, ctx.softcap
        v = w.shape[0]
        w_chunks, c = _chunks(w, n_chunks)
        gf = g.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = []
        for idx in range(n_chunks):
            logits, dcap = _chunk_logits(h, w_chunks[idx], softcap)
            col = idx * c + torch.arange(c, device=h.device)
            p = torch.exp(logits - lse[:, None]).masked_fill(col[None, :] >= v, 0.0)
            onehot = (col[None, :] == labels[:, None]).float()
            dlogits = (p - onehot) * gf[:, None]
            if softcap:
                dlogits = dlogits * dcap
            dlogits = dlogits.to(h.dtype)
            dh += (dlogits @ w_chunks[idx]).float()
            dw.append((dlogits.t() @ h).float())
        dw = torch.cat(dw)[:v]
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def chunked_softmax_xent(h, w, labels, n_chunks=DEFAULT_CHUNKS, softcap=0.0):
    """Per-token negative log-likelihood without materializing the logits.

    h: (N, E); w: (V, E) (logits = h @ w.T); labels: (N,) int. Returns nll
    (N,) f32, differentiable in h and w. ``softcap``: final-logit tanh cap,
    applied per chunk before the online logsumexp."""
    return _ChunkedSoftmaxXent.apply(h, w, labels.long(), int(n_chunks), float(softcap))


def lm_cross_entropy(h, w, labels, loss_mask=None, n_chunks=DEFAULT_CHUNKS,
                     transpose_w=False, softcap=0.0):
    """Mean cross-entropy over (B, S) tokens from final hidden states.

    h: (B, S, E); w: (V, E) tied embedding (or (E, V) with ``transpose_w``);
    labels: (B, S). Never materializes (B, S, V)."""
    b, s, e = h.shape
    if transpose_w:
        w = w.t()
    nll = chunked_softmax_xent(h.reshape(b * s, e), w, labels.reshape(-1), n_chunks,
                               softcap).reshape(b, s)
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
