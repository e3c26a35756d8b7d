"""Paged forward execution for ragged inference.

Mirrors ``deepspeed_tpu/inference/v2/model_runner.py`` for the plain
(tp=1, float-KV, non-speculative) serving path. One forward handles a batch
of sequence chunks: prefill chunks (C > 1) and decode steps (C = 1) are the
same code at different chunk widths (Dynamic SplitFuse).

Per layer: project q/k/v, RoPE at absolute positions, then the paged
attention kernel (``ops/paged_attention.py``) reads the pools in place
through the block table, with the chunk's own KV riding beside them. The
pools stay read-only during the layer walk; every layer's chunk KV is
committed by ONE scatter after it, with pad rows routed to trash block 0.
GEMMs are plain ``torch.matmul``.

Weights are cast to the activation dtype at use (``.to(dt)``), as the JAX
forward's ``.astype(dt)`` does, so weights stored in bf16 on the card give
the same values as f32 weights cast per use, at half the memory.

``frame_loop`` runs ``steps`` serving steps as a Python loop in place of
``lax.scan``; its carry tensors are returned, and the pools are updated in
place. Every step is device work only: nothing in the loop reads a value
back to the host, so the card's queue stays full between frame boundaries.
"""

import torch

from ...accelerator import get_device
from ...models import layers as L
from ...models.transformer import CausalLM, walk_layer_plan
from ...ops.paged_attention import paged_ragged_attention
from ..sampling import sample_logits_per_row
from .telemetry import N_STATS


class PagedModelRunner:
    def __init__(self, model: CausalLM, block_size: int, max_blocks_per_seq: int,
                 device=None):
        """``device``: where the runner's constants live and its inputs are
        expected — the current CUDA device by default, which raises without
        a GPU (pass ``device="cpu"`` for the CPU)."""
        if model.cfg.post_norm or model.cfg.mlm_head or not model.cfg.causal:
            raise NotImplementedError(
                "the paged serving runner executes causal pre-norm decoder "
                "blocks only")
        if model.cfg.act_quant_bits:
            raise NotImplementedError(
                "act_quant_bits serving is not ported yet (ROADMAP.md)")
        self.model = model
        self.cfg = model.cfg
        self.block_size = block_size
        self.max_blocks = max_blocks_per_seq
        self.device = get_device(device)
        self._inv_freq = model.inv_freq(self.device)
        self._slopes = (L.alibi_slopes(self.cfg.num_heads, self.device)
                        if self.cfg.position == "alibi" else None)

    def _forward(self, params, ids, positions, block_tables, valid_counts,
                 kpool, vpool):
        """ids/positions: (B, C) int32; block_tables: (B, MB) int32;
        valid_counts: (B,) real (non-pad) tokens in each chunk; kpool/vpool:
        (L, KVH, NB, bs, D). Returns (last-valid-token logits (B, V) f32,
        kpool, vpool) with the chunk's KV committed into the pools."""
        cfg = self.cfg
        bs = self.block_size
        dt = cfg.act_dtype
        b, c = ids.shape
        e, nh, kvh, d = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        emb = params["embed"]
        h = emb["tok"][ids].to(dt)
        if cfg.embed_scale != 1.0:
            h = h * torch.tensor(cfg.embed_scale, dtype=dt, device=h.device)
        if cfg.position == "learned":
            n_pos = emb["pos"].shape[0]
            h = h + emb["pos"][(positions + cfg.position_offset).clamp(0, n_pos - 1)].to(dt)
        if cfg.embedding_norm:   # BLOOM word_embeddings_layernorm
            h = L.apply_norm(emb["emb_norm"], h, cfg)
        # positions < 0 mark padding: their KV goes to trash block 0
        is_pad = positions < 0
        pos_safe = positions.clamp_min(0)
        page = (pos_safe // bs).clamp_max(block_tables.shape[1] - 1).long()
        blk = torch.where(is_pad, 0, torch.gather(block_tables, 1, page))
        off = pos_safe % bs

        windows = self.model._layer_windows()
        uniform_window = None
        if cfg.sliding_window is not None and cfg.local_attention_every is None \
                and cfg.sliding_window < block_tables.shape[1] * bs:
            uniform_window = cfg.sliding_window   # binds within this pool

        def layer(h, lp, xs):
            li, win = xs
            if win is None:
                win = uniform_window
            a_in = L.apply_norm(lp["norm1"], h, cfg)
            x2 = a_in.reshape(b * c, e)
            att = lp["attn"]
            q = (x2 @ att["wq"].to(dt).reshape(e, nh * d)).view(b, c, nh, d)
            k = (x2 @ att["wk"].to(dt).reshape(e, kvh * d)).view(b, c, kvh, d)
            v = (x2 @ att["wv"].to(dt).reshape(e, kvh * d)).view(b, c, kvh, d)
            if cfg.use_bias or cfg.qkv_bias:
                q = q + L.bcast(att["bq"].to(dt), q.dim())
                k = k + L.bcast(att["bk"].to(dt), k.dim())
                v = v + L.bcast(att["bv"].to(dt), v.dim())
            if cfg.qk_norm:
                q = L.apply_qk_norm(att["q_norm"], q, cfg)
                k = L.apply_qk_norm(att["k_norm"], k, cfg)
            if cfg.position == "rope":
                q = L.apply_rope(q, pos_safe, self._inv_freq,
                                 interleaved=cfg.rope_interleaved)
                k = L.apply_rope(k, pos_safe, self._inv_freq,
                                 interleaved=cfg.rope_interleaved)
            k = k.to(kpool.dtype).contiguous()
            v = v.to(vpool.dtype).contiguous()
            out = paged_ragged_attention(
                q.contiguous(), kpool, vpool, block_tables, positions, k, v,
                layer=li, scale=cfg.attn_scale, window=win,
                alibi_slopes=self._slopes, softcap=cfg.attn_softcap)
            y = (out.reshape(b * c, nh * d) @ att["wo"].to(dt).reshape(nh * d, e)).view(b, c, e)
            if "bo" in att:   # presence-keyed: out_bias may differ from use_bias
                y = y + L.bcast(att["bo"].to(dt), y.dim())
            if cfg.sandwich_norm:   # Gemma-2 post-attn output norm
                y = L.apply_norm(lp["norm3"], y, cfg)
            if cfg.parallel_block:   # NeoX/Falcon: attn and mlp share input
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            else:
                h = h + y
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            mlp_out = L.apply_mlp(lp["mlp"], m_in, cfg)
            if cfg.sandwich_norm:
                mlp_out = L.apply_norm(lp["norm4"], mlp_out, cfg)
            h = h + y + mlp_out if cfg.parallel_block else h + mlp_out
            return h, (k, v)

        h, kpool, vpool = self._run_layers(layer, h, params, kpool, vpool,
                                           windows, blk, off)
        h = L.apply_norm(params["final_norm"], h, cfg)
        return self._head(params, h, valid_counts), kpool, vpool

    def _run_layers(self, layer, h, params, kpool, vpool, windows, blk, off):
        """Drive ``layer`` over the stack; the pools stay read-only during
        the walk (read through the layer index), each layer's chunk KV
        comes back as its output, and ONE scatter commits them all."""
        n = self.cfg.num_layers
        wins = windows if windows is not None else [None] * n
        h, kv = walk_layer_plan(params["layers"], n, (range(n), wins), h, layer)
        ck_all = torch.stack([k for k, _ in kv])          # (L, B, C, KVH, D)
        cv_all = torch.stack([v for _, v in kv])
        # (B, C) advanced indices are adjacent: the indexed window is
        # (L, KVH, B, C, D)
        kpool[:, :, blk, off] = ck_all.permute(0, 3, 1, 2, 4)
        vpool[:, :, blk, off] = cv_all.permute(0, 3, 1, 2, 4)
        return h, kpool, vpool

    def _head(self, params, h, valid_counts):
        """Last-valid-token logits (B, V) f32 from normed hidden states."""
        cfg = self.cfg
        dt = cfg.act_dtype
        last_idx = (valid_counts - 1).clamp_min(0).long()
        h_last = h[torch.arange(h.shape[0], device=h.device), last_idx]   # (B, E)
        emb = params["embed"]
        if cfg.tie_embeddings:
            logits = h_last @ emb["tok"].to(dt).t()
        else:
            logits = h_last @ emb["lm_head"].to(dt)
        if "lm_head_bias" in emb:
            logits = logits + L.bcast(emb["lm_head_bias"].to(logits.dtype), logits.dim())
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits.float()

    def run(self, params, ids, positions, block_tables, valid_counts, kpool, vpool):
        """One ragged forward (the JAX ``run(chunk, ...)`` entry point)."""
        return self._forward(params, ids, positions, block_tables,
                             valid_counts, kpool, vpool)

    def frame_loop(self, params, prompts, prompt_lens, limits, eos_ids, temps,
                   tables, cached, produced, last_tok, done, poison, nonfinite,
                   stats, rng, kpool, vpool, *, width, steps, greedy):
        """One K-step serving FRAME (see the JAX ``frame_loop``): all
        per-slot state is carry-in/carry-out, so the host touches the loop
        only at frame boundaries. Returns (tokens (steps, B), emit
        (steps, B), cached, produced, last_tok, done, poison, nonfinite,
        stats, rng, kpool, vpool); ``rng`` is a ``torch.Generator`` advanced
        in place by sampled steps."""
        body = _serving_scan_body(self._forward, params, prompts, prompt_lens,
                                  limits, eos_ids, temps, tables, width, greedy)
        carry = (cached, produced, last_tok, done, poison, nonfinite, stats,
                 rng, kpool, vpool)
        toks, emits = [], []
        for _ in range(steps):
            carry, (t, em) = body(carry)
            toks.append(t)
            emits.append(em)
        return (torch.stack(toks), torch.stack(emits)) + carry


def _serving_scan_body(fwd, params, prompts, prompt_lens, limits, eos_ids,
                       temps, tables, width, greedy):
    """One serving step over the carry (cached, produced, last_tok, done,
    poison, nonfinite, stats, rng, kpool, vpool). A row with
    ``cached < prompt_lens`` prefills up to ``width`` prompt tokens; a row
    past its prompt with ``produced < limits`` decodes one token; ``done``
    rows and rows at their limit freeze (width 0, positions -1, writes to
    the trash block). Emits (token or -1, emit mask) per step and adds the
    step's counters to ``stats``."""

    def body(carry):
        (cached, produced, last_tok, done, poison, nonfinite, stats, rng,
         kpool, vpool) = carry
        prefilling, active, w, ids, positions = _wide_plan(
            prompts, prompt_lens, limits, width, cached, produced, last_tok,
            done)
        logits, kpool, vpool = fwd(params, ids, positions, tables, w, kpool, vpool)
        logits = _inject_poison(logits, poison)
        if greedy:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        else:
            nxt = sample_logits_per_row(logits, rng, temps)
        emit, last_tok, done = _wide_emit(active, prefilling, cached, w,
                                          prompt_lens, eos_ids, nxt, last_tok,
                                          done)
        emit, done, nonfinite, _bad = _finite_check(logits, active, emit, done,
                                                    nonfinite)
        stats = stats + _stat_delta(
            emitted=emit, active=active,
            prefill_toks=torch.where(prefilling, w, 0),
            eos=emit & (nxt == eos_ids),
            target_fwd=active & ~prefilling)
        return ((cached + w, produced + emit.to(torch.int32), last_tok, done,
                 poison, nonfinite, stats, rng, kpool, vpool),
                (torch.where(emit, nxt, -1), emit))

    return body


def _inject_poison(logits, poison):
    """Rows whose ``poison`` flag is set get NaN logits (the fault-injection
    hook of the finite check; all-False outside fault tests)."""
    return logits.masked_fill(poison.reshape((-1,) + (1,) * (logits.dim() - 1)),
                              float("nan"))


def _finite_check(logits, active, emit, done, nonfinite):
    """An active row whose logits hold a non-finite value stops emitting
    this step, freezes, and latches ``nonfinite`` for the host to read at
    the frame boundary. Returns (emit, done, nonfinite, bad)."""
    bad = active & ~torch.isfinite(logits).flatten(1).all(dim=1)
    emit = emit & ~(bad if emit.dim() == 1 else bad[:, None])
    return emit, done | bad, nonfinite | bad, bad


def _stat_delta(emitted=None, active=None, prefill_toks=None, eos=None,
                target_fwd=None, drafted=None, accepted=None):
    """One step's (N_STATS,) counter increment; each keyword is a mask or
    int tensor to sum, or None for zero (layout: ``telemetry.STAT_*``)."""
    vals = [emitted, active, prefill_toks, eos, target_fwd, drafted, accepted]
    dev = next(v.device for v in vals if v is not None)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    out = [z if v is None else v.to(torch.int32).sum(dtype=torch.int32) for v in vals]
    assert len(out) == N_STATS
    return torch.stack(out)


def _wide_plan(prompts, prompt_lens, limits, width, cached, produced,
               last_tok, done):
    """Who prefills, who decodes, who freezes, and the chunk each consumes.
    Returns (prefilling, active, w, ids, positions); frozen rows get w=0 and
    positions -1. ``DeviceSlotTable.absorb`` replays exactly this
    arithmetic on the host mirrors."""
    offs = torch.arange(width, dtype=torch.int32, device=cached.device)
    prefilling = cached < prompt_lens
    active = ~done & (prefilling | (produced < limits))
    w = torch.where(active,
                    torch.where(prefilling, (prompt_lens - cached).clamp_max(width), 1),
                    0).to(torch.int32)
    idx = (cached[:, None] + offs[None, :]).clamp(0, prompts.shape[1] - 1).long()
    ids = torch.where(prefilling[:, None], torch.gather(prompts, 1, idx),
                      torch.where(offs[None, :] == 0, last_tok[:, None], 0))
    mask = offs[None, :] < w[:, None]
    positions = torch.where(mask, cached[:, None] + offs[None, :], -1)
    return prefilling, active, w, ids.to(torch.int32), positions.to(torch.int32)


def _wide_emit(active, prefilling, cached, w, prompt_lens, eos_ids, nxt,
               last_tok, done):
    """Rows completing their prefill and decode rows emit ``nxt``; EOS
    freezes the row."""
    completes = active & prefilling & (cached + w == prompt_lens)
    emit = completes | (~prefilling & active)
    last_tok = torch.where(emit, nxt, last_tok)
    done = done | (emit & (nxt == eos_ids))
    return emit, last_tok, done
