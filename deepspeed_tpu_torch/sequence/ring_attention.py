"""Ring attention: context parallelism over the ``seq`` shards.

Mirrors ``deepspeed_tpu/sequence/ring_attention.py``. Each shard holds a
sequence shard of Q/K/V; K/V shards rotate around the ring while
online-softmax statistics (m, l, acc) merge the partial results. Masks come
from global positions, so sliding windows, ALiBi slopes and packed-sequence
segment ids (which rotate with their K/V shard) compose with the causal
ring.

Two bodies, chosen by the JAX eligibility rule (``ring_flash_supported``):
the flash ring (``ring_flash.py``, K13-K15 on the card) for shard sizes that
tile, D in {64, 128, 256} and a static window; the einsum ring
(``_ring_body``) for the rest (a tensor window, other head dims), in
512-query chunks with GQA through grouped einsums, plain torch as it is
plain XLA in JAX. There is no switch between them (JAX reads
``DS_TPU_RING_FLASH``): a test that wants the einsum ring on an eligible
shape calls ``_ring_body``.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import window_mask
from ..utils import groups
from .ring_flash import NEG_INF, RingTransport, ring_flash_body, ring_flash_supported


def _block_attend(q, k, v, scale, q_pos, k_pos, window, seg_q, seg_k, slopes, chunk=512):
    """Partial (unnormalized) attention of local q against one kv block, in
    query chunks, so that the (B, KVH, G, Cq, Sk) f32 scores are the peak
    intermediate. GQA contracts against the raw (B, Sk, KVH, D) K/V.

    Returns (m, l, o_partial): (B, H, Sq), (B, H, Sq), (B, Sq, H, D) f32."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    cq = min(chunk, sq)
    if sq % cq:
        cq = sq   # odd shard sizes: one chunk
    ms, ls, os_ = [], [], []
    for c0 in range(0, sq, cq):
        qc = q[:, c0:c0 + cq].reshape(b, cq, kvh, g, d)
        qp = q_pos[c0:c0 + cq]
        s = torch.einsum("bcngd,bknd->bngck", qc.float(), k.float()) * scale
        rel = qp[:, None] - k_pos[None, :]                                    # (Cq, Sk)
        if slopes is not None:
            s = s + (slopes.reshape(kvh, g)[None, :, :, None, None]
                     * (-rel).float()[None, None, None])
        mask = rel >= 0                                                       # causal
        if window is not None:
            mask = mask & window_mask(qp[:, None], k_pos[None, :], window)
        mask = mask[None, None, None]                                         # (1,1,1,Cq,Sk)
        if seg_q is not None:
            mask = mask & (seg_q[:, c0:c0 + cq][:, None, None, :, None]
                           == seg_k[:, None, None, None, :])
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1)                                                    # (B, KVH, G, Cq)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bngck,bknd->bcngd", p.to(v.dtype), v).float())
    # (B, KVH, G, Sq) -> (B, H, Sq);  (B, Sq, KVH, G, D) -> (B, Sq, H, D)
    m = torch.cat(ms, dim=-1).reshape(b, h, sq)
    l = torch.cat(ls, dim=-1).reshape(b, h, sq)
    o = torch.cat(os_, dim=1).reshape(b, sq, h, d)
    return m, l, o


def _ring_body(q, k, v, seg, transport, scale, window, slopes):
    """The einsum ring over this process's local shards: q (B, S_p, H, D),
    k/v (B, S_p, KVH, D), seg (B, S_p) or None -> (B, S_p, H, D). Each
    block's attention is recomputed in the backward (the JAX
    ``jax.checkpoint`` of the step)."""
    n, local = transport.size, len(transport.ranks)
    b, sp, h, d = q.shape
    sq, sk = sp // local, k.shape[1] // local
    qs = list(q.chunk(local, dim=1))
    segs = [None] * local if seg is None else list(seg.chunk(local, dim=1))
    kv = list(zip(k.chunk(local, dim=1), v.chunk(local, dim=1), segs))
    f32 = dict(dtype=torch.float32, device=q.device)
    m_acc = [torch.full((b, h, sq), NEG_INF, **f32) for _ in range(local)]
    l_acc = [torch.zeros((b, h, sq), **f32) for _ in range(local)]
    o_acc = [torch.zeros((b, sq, h, d), **f32) for _ in range(local)]
    for step in range(n):
        for i, rank in enumerate(transport.ranks):
            k_blk, v_blk, kseg_blk = kv[i]
            src = (rank - step) % n     # the shard that produced this kv block
            q_pos = rank * sq + torch.arange(sq, device=q.device)
            k_pos = src * sk + torch.arange(sk, device=q.device)
            m_b, l_b, o_b = checkpoint(_block_attend, qs[i], k_blk, v_blk, scale, q_pos, k_pos,
                                       window, segs[i], kseg_blk, slopes, use_reentrant=False)
            m_new = torch.maximum(m_acc[i], m_b)
            a_old = torch.exp(m_acc[i] - m_new)
            a_new = torch.exp(m_b - m_new)
            l_acc[i] = l_acc[i] * a_old + l_b * a_new
            o_acc[i] = (o_acc[i] * a_old.transpose(1, 2)[..., None]
                        + o_b * a_new.transpose(1, 2)[..., None])
            m_acc[i] = m_new
        if step < n - 1:
            kv = transport.rotate(kv)
    outs = []
    for o, l in zip(o_acc, l_acc):
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l_safe.transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def ring_attention(q, k, v, *, scale=None, window=None, alibi_slopes=None, segment_ids=None):
    """Causal ring attention over the ``seq`` shards of ``utils.groups``.
    q/k/v: this process's part of the sequence, (B, S_p, H|KVH, D), which
    is the whole sequence when one process holds every shard. Returns
    (B, S_p, H, D).

    window: sliding-window width (an int or a tensor; <= 0 is global);
    alibi_slopes: (H,) per-head slopes; segment_ids: (B, S_p) int, packed
    documents attend within their own segment (the key-side ids rotate
    with their shard)."""
    transport = RingTransport(groups.get_sequence_parallel_world_size(),
                              groups.get_sequence_parallel_group())
    local = len(transport.ranks)
    if q.shape[1] % local or k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention: q {tuple(q.shape)} / k {tuple(k.shape)} do not split "
                         f"into {local} equal local shards")
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    slopes = None if alibi_slopes is None else \
        torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device).contiguous()
    win_static = (None if window is None or (isinstance(window, int) and window <= 0)
                  else window)
    sq_local = q.shape[1] // local
    if ring_flash_supported(sq_local, sq_local, d, win_static):
        return ring_flash_body(q, k, v, segment_ids, transport=transport, scale=scale,
                               window=win_static, slopes=slopes)
    return _ring_body(q, k, v, segment_ids, transport, scale, window, slopes)
