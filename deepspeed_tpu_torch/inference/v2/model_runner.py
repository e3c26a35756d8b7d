"""Paged forward execution for ragged inference.

Mirrors ``deepspeed_tpu/inference/v2/model_runner.py``. One forward
handles a batch of sequence chunks: prefill chunks (C > 1) and decode steps
(C = 1) are the same code at different chunk widths (Dynamic SplitFuse).

Tensor parallelism (``set_tp``, a ``tp.TPContext``): the params and pools
are this rank's shards, the forward runs the local heads (H / tp query,
KVH / tp kv heads, on K1 or the int8 gather route alike) and issues the
collectives of JAX's tp branches: a masked lookup and all-reduce for the
vocab-split embedding, an all-reduce after the attention and MLP output
projections (their biases added once, after it) and an all-gather of the
vocab-split logits, so every rank sees the same logits. Every rank runs the
same steps in the same order, and the collectives sit inside the captured
step graphs.

Per layer: project q/k/v, RoPE at absolute positions, then attention with
the chunk's own KV riding beside the pools. Float pools are read in place
by the paged attention kernel (``ops/paged_attention.py``) through the
block table; int8 pools (``kv_dtype="int8"``) are gathered, dequantized
and attended by ``_paged_attention``, as JAX routes them. The pools stay
read-only during the layer walk; every layer's chunk KV is committed by
ONE scatter after it, with pad rows routed to trash block 0. GEMMs are
plain ``torch.matmul``; int8 weight leaves are dequantized at use
(``layers.dq``).

Weights are cast to the activation dtype at use (``.to(dt)``), as the JAX
forward's ``.astype(dt)`` does, so weights stored in bf16 on the card give
the same values as f32 weights cast per use, at half the memory.

``frame_loop``, ``decode_loop`` and ``mixed_loop`` run their steps as a
Python loop in place of ``lax.scan``; the carry tensors are returned, and
the pools are updated in place. Every step is device work only: nothing in
a loop reads a value back to the host. ``frame_loop_spec`` and
``mixed_loop_spec`` are the speculative programs: a draft model's forward
(another runner's ``_forward`` over its own pools, which share the block
tables) proposes gamma tokens a step and ONE target forward over gamma + 1
positions verifies them (``_spec_scan_body``).

Step graphs (``cuda_graphs.py``), the default on the card: each program's
step runs over static buffers that it updates in place, captured into a
CUDA graph once per key and replayed, as the JAX programs are compiled once
per shape bucket with their state donated. Keys: ("run", B, C, MB);
("loop", B, MB, greedy); ("frame" or "mixed", width, greedy, repair, B,
prompt width, table width); ("spec_frame" or "spec_mixed", the same, gamma,
the draft runner's tag). ``repair`` (``nonfinite_policy="repair"``) selects
a non-finite row back to its pre-step carry, so it names its own graph.
The serving slot state (``DeviceSlotTable``) and the ``mixed_loop`` state
share one set of static buffers per (B, prompt width, table width); a slot
table served here holds those buffers as its tensors.
Sampled steps are never captured: they run eagerly on the same buffers, by
the rule "any live temperature > 0" (``greedy=False``). The functional
loops stay: they are the CPU's path and the card's with
``cuda_graphs=False``.

``steps_begun`` counts the serving steps a runner has started (a replay,
an eager step or a functional step): the engine retries a failed frame only
when none of its steps began, since each one updates the slot state and the
pools in place.
"""

import itertools
import types
import weakref

import torch

from ...accelerator import get_device
from ...models import layers as L
from ...models.transformer import CausalLM, walk_layer_plan
from ...ops.paged_attention import paged_ragged_attention
from ...ops.attention import window_mask
from ..cuda_graphs import StepGraphs, StepRows
from ..sampling import sample_logits, sample_logits_per_row, speculative_verify_per_row
from .kv_cache import dequantize_kv_lanes, quantize_kv_lanes
from .ragged_manager import SLOT_CARRY, SLOT_STATE, SPEC_CARRY, slot_state
from .telemetry import N_STATS, zero_stats


_RUNNER_IDS = itertools.count()


class PagedModelRunner:
    def __init__(self, model: CausalLM, block_size: int, max_blocks_per_seq: int,
                 device=None, cuda_graphs=None):
        """``device``: where the runner's constants live and its inputs are
        expected — the current CUDA device by default, which raises without
        a GPU (pass ``device="cpu"`` for the CPU). ``cuda_graphs``: None
        runs the step graphs on a CUDA device and the functional loops on
        the CPU; False runs the functional loops on the card too; True on
        the CPU runs the static-buffer steps eagerly (nothing to capture)."""
        if model.cfg.post_norm or model.cfg.mlm_head or not model.cfg.causal:
            raise NotImplementedError(
                "the paged serving runner executes causal pre-norm decoder "
                "blocks only")
        if model.cfg.act_quant_bits:
            raise NotImplementedError(
                "act_quant_bits serving is not ported yet (ROADMAP.md)")
        self.model = model
        self.cfg = model.cfg
        # names this runner in the keys of speculative steps it drafts for
        self.tag = f"runner{next(_RUNNER_IDS)}:L{model.cfg.num_layers}xE{model.cfg.hidden_size}"
        self.block_size = block_size
        self.max_blocks = max_blocks_per_seq
        self.device = get_device(device)
        self._inv_freq = model.inv_freq(self.device)
        self._slopes = (L.alibi_slopes(self.cfg.num_heads, self.device)
                        if self.cfg.position == "alibi" else None)
        # a constant, so that no step copies a host scalar to the card
        self._embed_scale = (torch.tensor(self.cfg.embed_scale, dtype=self.cfg.act_dtype,
                                          device=self.device)
                             if self.cfg.embed_scale != 1.0 else None)
        use = self.device.type == "cuda" if cuda_graphs is None else bool(cuda_graphs)
        self.graphs = StepGraphs(self.device) if use else None
        self.tp = None          # a tp.TPContext under tensor parallelism (set_tp)
        self._slot_sets = {}    # (B, prompt width, table width) -> static slot buffers
        self._run_sets = {}     # run key -> static inputs and logits
        self._loop_sets = {}    # (B, MB) -> static decode_loop state
        self.steps_begun = 0    # serving steps started, functional or in place

    def set_tp(self, tp_ctx) -> None:
        """Bind a ``tp.TPContext`` (engine set-up, before any step runs):
        the forward then runs this rank's heads with ALiBi slopes of those
        heads. Graphs captured before are dropped."""
        self.tp = tp_ctx
        if self._slopes is not None:
            h = self.cfg.num_heads // tp_ctx.degree
            self._slopes = L.alibi_slopes(self.cfg.num_heads, self.device)[
                tp_ctx.rank * h:(tp_ctx.rank + 1) * h].contiguous()
        if self.graphs is not None:
            self.graphs.reset()
            self.graphs.agree_keys = tp_ctx.agree

    def _forward(self, params, ids, positions, block_tables, valid_counts,
                 kpool, vpool, *, all_logits=False, tp=None):
        """ids/positions: (B, C) int32; block_tables: (B, MB) int32;
        valid_counts: (B,) real (non-pad) tokens in each chunk; kpool/vpool:
        (L, KVH, NB, bs, lanes). Returns (last-valid-token logits (B, V)
        f32, kpool, vpool) with the chunk's KV committed into the pools, or
        the logits at EVERY chunk position (B, C, V) with ``all_logits``
        (the speculative verify scores all gamma + 1 positions at once).

        Float pools are read in place by the paged attention kernel (K1).
        Int8 pools (``kv_dtype="int8"``) hold packed rows the kernel does
        not decode: the layer gathers its pages through the block table,
        dequantizes them and attends with ``_paged_attention``, the JAX
        runner's own route for int8 pools (``model_runner.py:186-212``),
        not a fallback; the chunk's KV leaves the layer quantized
        (``quantize_kv_lanes``), so the commit scatter is dtype-blind.

        ``tp``: the tensor-parallel context the forward runs under, the
        runner's (``set_tp``) by default; None at tp = 1, which issues no
        collective. Under tp the params and pools are this rank's shards
        and the collectives of JAX's tp branches run here
        (``model_runner.py:103-113``, ``:146-150``, ``:221-226``, ``:241``,
        ``:317-318``)."""
        cfg = self.cfg
        tp = self.tp if tp is None else tp
        bs = self.block_size
        dt = cfg.act_dtype
        b, c = ids.shape
        e, nh, kvh, d = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        emb = params["embed"]
        if tp is not None:
            nh, kvh = nh // tp.degree, kvh // tp.degree
        if tp is not None and tp.vocab_sharded:
            # vocab-parallel lookup: this rank holds rows [r V / tp, (r + 1)
            # V / tp); other ids read 0 here and the all-reduce picks the one
            # rank holding each token's row
            vs = emb["tok"].shape[0]
            lo = tp.rank * vs
            mine = (ids >= lo) & (ids < lo + vs)
            h = emb["tok"][(ids - lo).clamp(0, vs - 1)].to(dt)
            h = tp.coll.psum_embed(torch.where(mine[..., None], h, torch.zeros_like(h)))
        else:
            h = emb["tok"][ids].to(dt)
        if self._embed_scale is not None:
            h = h * self._embed_scale
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
        quantized_kv = kpool.dtype == torch.int8
        # first chunk position per row: pool slots >= this are stale (the
        # chunk's KV flows beside the pool, committed after the layer walk)
        chunk_start = (torch.where(is_pad, 1 << 30, positions).amin(dim=1)
                       if quantized_kv else None)

        # one set of rotary sines and cosines serves every layer's q and k
        sin_cos = (L.rope_sin_cos(pos_safe, self._inv_freq)
                   if cfg.position == "rope" else None)

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
            q = (x2 @ L.dq(att["wq"], dt).reshape(e, nh * d)).view(b, c, nh, d)
            k = (x2 @ L.dq(att["wk"], dt).reshape(e, kvh * d)).view(b, c, kvh, d)
            v = (x2 @ L.dq(att["wv"], dt).reshape(e, kvh * d)).view(b, c, kvh, d)
            if cfg.use_bias or cfg.qkv_bias:
                q = q + L.bcast(att["bq"].to(dt), q.dim())
                k = k + L.bcast(att["bk"].to(dt), k.dim())
                v = v + L.bcast(att["bv"].to(dt), v.dim())
            if cfg.qk_norm:
                q = L.apply_qk_norm(att["q_norm"], q, cfg)
                k = L.apply_qk_norm(att["k_norm"], k, cfg)
            if cfg.position == "rope":
                q = L.apply_rope(q, pos_safe, self._inv_freq,
                                 interleaved=cfg.rope_interleaved, sin_cos=sin_cos)
                k = L.apply_rope(k, pos_safe, self._inv_freq,
                                 interleaved=cfg.rope_interleaved, sin_cos=sin_cos)
            if quantized_kv:
                kpages, vpages = (_gather_pages(pool, li, block_tables, dt)
                                  for pool in (kpool, vpool))
                out = _paged_attention(q, kpages, vpages, positions, cfg, window=win,
                                       chunk_k=k, chunk_v=v, chunk_start=chunk_start,
                                       alibi_slopes=self._slopes)
                k, v = quantize_kv_lanes(k), quantize_kv_lanes(v)
            else:
                k = k.to(kpool.dtype).contiguous()
                v = v.to(vpool.dtype).contiguous()
                out = paged_ragged_attention(
                    q.contiguous(), kpool, vpool, block_tables, positions, k, v,
                    layer=li, scale=cfg.attn_scale, window=win,
                    alibi_slopes=self._slopes, softcap=cfg.attn_softcap)
            y = (out.reshape(b * c, nh * d) @ L.dq(att["wo"], dt).reshape(nh * d, e)).view(b, c, e)
            if tp is not None:
                # row-parallel: the product covers this rank's heads; the
                # bias goes in once, after the all-reduce
                y = tp.coll.psum_attn(y)
            if "bo" in att:   # presence-keyed: out_bias may differ from use_bias
                y = y + L.bcast(att["bo"].to(dt), y.dim())
            if cfg.sandwich_norm:   # Gemma-2 post-attn output norm
                y = L.apply_norm(lp["norm3"], y, cfg)
            if cfg.parallel_block:   # NeoX/Falcon: attn and mlp share input
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            else:
                h = h + y
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            mlp_out = L.apply_mlp(lp["mlp"], m_in, cfg,
                                  reduce=tp.coll.psum_mlp if tp is not None else None)
            if cfg.sandwich_norm:
                mlp_out = L.apply_norm(lp["norm4"], mlp_out, cfg)
            h = h + y + mlp_out if cfg.parallel_block else h + mlp_out
            return h, (k, v)

        h, kpool, vpool = self._run_layers(layer, h, params, kpool, vpool,
                                           windows, blk, off)
        h = L.apply_norm(params["final_norm"], h, cfg)
        return self._head(params, h, valid_counts, all_logits, tp), kpool, vpool

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

    def _head(self, params, h, valid_counts, all_logits=False, tp=None):
        """Last-valid-token logits (B, V) f32 from normed hidden states, or
        the logits at every position (B, C, V) with ``all_logits``. Under a
        vocab-split ``tp`` the product is this rank's V / tp columns; bias
        and softcap apply to them, and one all-gather assembles the vocab."""
        cfg = self.cfg
        dt = cfg.act_dtype
        if all_logits:
            h_last = h                                               # (B, C, E)
        else:
            last_idx = (valid_counts - 1).clamp_min(0).long()
            h_last = h[torch.arange(h.shape[0], device=h.device), last_idx]   # (B, E)
        emb = params["embed"]
        if cfg.tie_embeddings:
            logits = h_last @ emb["tok"].to(dt).t()
        else:
            logits = h_last @ L.dq(emb["lm_head"], dt)
        if "lm_head_bias" in emb:
            logits = logits + L.bcast(emb["lm_head_bias"].to(logits.dtype), logits.dim())
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        if tp is not None and tp.vocab_sharded:
            logits = tp.coll.gather_logits(logits)
        return logits.float()

    def run(self, params, ids, positions, block_tables, valid_counts, kpool, vpool):
        """One ragged forward (the JAX ``run(chunk, ...)`` entry point).
        With step graphs the inputs are copied into the static buffers of
        key ("run", B, C, MB) and its step replayed; the logits come back as
        a tensor of their own either way."""
        if self.graphs is None:
            return self._forward(params, ids, positions, block_tables,
                                 valid_counts, kpool, vpool)
        b, c = ids.shape
        key = ("run", b, c, block_tables.shape[1])
        st = self._run_sets.get(key)
        if st is None:
            zi = self._zeros_i32
            st = self._run_sets[key] = types.SimpleNamespace(
                ids=zi(b, c), positions=zi(b, c), tables=zi(b, key[3]), valid=zi(b),
                logits=torch.zeros((b, self.cfg.vocab_size), dtype=torch.float32,
                                   device=self.device))
        for buf, t in ((st.ids, ids), (st.positions, positions),
                       (st.tables, block_tables), (st.valid, valid_counts)):
            buf.copy_(t)
        self.graphs.bind(params, kpool, vpool)

        def step():
            st.logits.copy_(self._forward(params, st.ids, st.positions, st.tables,
                                          st.valid, kpool, vpool)[0])

        self.graphs.run(key, step)
        return st.logits.clone(), kpool, vpool

    def _zeros_i32(self, *shape):
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _decode_next(self, params, ids, lens, tables, kpool, vpool, rng,
                     temperature, greedy):
        """One ``decode_loop`` step: row i feeds ``ids[i]`` at position
        ``lens[i]``; returns the next token of each row (B,) int32."""
        logits, _, _ = self._forward(params, ids[:, None], lens[:, None], tables,
                                     torch.ones_like(lens), kpool, vpool)
        if greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        return sample_logits(logits, rng, temperature=float(temperature))

    def decode_loop(self, params, last_ids, seq_lens, block_tables, kpool, vpool,
                    rng, temperature, *, steps, greedy):
        """``steps`` greedy or sampled tokens per row over fixed block tables
        (the JAX ``decode_loop``): row i feeds ``last_ids[i]`` at position
        ``seq_lens[i]``, then each token it draws. The tables must already
        cover ``seq_lens + steps`` slots. ``rng``: a ``torch.Generator`` on
        the runner's device (sampled rows). Returns (tokens (steps, B) int32,
        kpool, vpool)."""
        b = last_ids.shape[0]
        if self.graphs is None:
            ids, lens, toks = last_ids, seq_lens, []
            for _ in range(steps):
                ids = self._decode_next(params, ids, lens, block_tables, kpool, vpool,
                                        rng, temperature, greedy)
                lens = lens + 1
                toks.append(ids)
            return _stack_rows(toks, b, torch.int32, last_ids.device), kpool, vpool
        mb = block_tables.shape[1]
        st = self._loop_sets.get((b, mb))
        if st is None:
            st = self._loop_sets[(b, mb)] = types.SimpleNamespace(
                ids=self._zeros_i32(b), lens=self._zeros_i32(b), tables=self._zeros_i32(b, mb),
                rows=StepRows(b, (torch.int32,), self.device))
        st.ids.copy_(last_ids)
        st.lens.copy_(seq_lens)
        st.tables.copy_(block_tables)
        self.graphs.bind(params, kpool, vpool)
        key = ("loop", b, mb, greedy)

        def one():
            nxt = self._decode_next(params, st.ids, st.lens, st.tables, kpool, vpool,
                                    rng, temperature, greedy)
            st.rows.write(nxt)
            st.ids.copy_(nxt)
            st.lens.add_(1)

        (toks,) = st.rows.loop(steps, lambda: self.graphs.run(key, one, capture=greedy))
        return toks, kpool, vpool

    def mixed_loop(self, params, prompts, prompt_lens, new_limits, kpool, vpool,
                   block_tables, rng, temperature, *, chunk, wide_steps,
                   narrow_steps, greedy):
        """Dynamic SplitFuse over a static workload (the JAX ``mixed_loop``
        without its tp branch): ``wide_steps`` steps at width ``chunk``,
        then ``narrow_steps`` at width 1, both ``_serving_scan_body`` over
        one carry. Rows carry no EOS and share one temperature; a row at its
        ``new_limits`` freezes. prompts: (B, P_max) padded prompt ids.
        Returns (tokens, emit (wide_steps + narrow_steps, B), kpool,
        vpool)."""
        toks, emit = self._mixed(params, prompts, prompt_lens, new_limits, kpool, vpool,
                                 block_tables, rng, temperature, chunk, wide_steps,
                                 narrow_steps, greedy)
        return toks, emit, kpool, vpool

    def mixed_loop_spec(self, draft_runner, params, draft_params, prompts, prompt_lens,
                        new_limits, kpool, vpool, dkpool, dvpool, block_tables, rng,
                        temperature, *, chunk, wide_steps, narrow_steps, greedy, gamma):
        """``mixed_loop`` with speculation (the JAX ``mixed_loop_spec``
        without its tp branch): the wide steps prefill both models, the
        narrow steps are draft/verify steps; rows freeze at their limits, so
        ``narrow_steps`` stays the no-acceptance budget and early finishers
        coast. ``draft_runner`` supplies the draft's forward over its pools
        ``dkpool``/``dvpool``, which share the block tables. Returns
        (tokens, emit (wide_steps + narrow_steps, B, gamma + 1), kpool,
        vpool, dkpool, dvpool)."""
        toks, emit = self._mixed(params, prompts, prompt_lens, new_limits, kpool, vpool,
                                 block_tables, rng, temperature, chunk, wide_steps,
                                 narrow_steps, greedy,
                                 (draft_runner, draft_params, dkpool, dvpool, gamma))
        return toks, emit, kpool, vpool, dkpool, dvpool

    def _mixed(self, params, prompts, prompt_lens, new_limits, kpool, vpool, block_tables,
               rng, temperature, chunk, wide_steps, narrow_steps, greedy, spec=None):
        """The steps of ``mixed_loop`` (``spec``: those of
        ``mixed_loop_spec``, as ``_slot_steps`` takes it). Returns (tokens,
        emit)."""
        b = prompts.shape[0]
        dev = prompts.device
        no_eos = torch.full((b,), -1, dtype=torch.int32, device=dev)
        temps = torch.full((b,), float(temperature), dtype=torch.float32, device=dev)
        passes = ((chunk, wide_steps), (1, narrow_steps))
        if self.graphs is None:
            zero = torch.zeros((b,), dtype=torch.int32, device=dev)
            no = torch.zeros((b,), dtype=torch.bool, device=dev)
            fresh = dict(cached=zero, produced=zero, last_tok=zero, penult=zero, done=no,
                         poison=no, nonfinite=no, stats=zero_stats(dev))
            carry = tuple(fresh[n] for n in (SPEC_CARRY if spec else SLOT_CARRY)) + (
                rng, kpool, vpool) + (tuple(spec[2:4]) if spec else ())
            draft = (spec[0]._forward, spec[1], spec[4]) if spec else None
            parts = []
            for width, n in passes:
                body = _serving_scan_body(self._forward, params, prompts, prompt_lens,
                                          new_limits, no_eos, temps, block_tables,
                                          width, greedy, draft=draft)
                toks, emit, carry = _run_steps(body, carry, n, spec[4] if spec else None)
                parts.append((toks, emit))
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        st = self._claim_slots((b, prompts.shape[1], block_tables.shape[1]))
        for name, t in (("prompts", prompts), ("prompt_lens", prompt_lens),
                        ("limits", new_limits), ("eos_ids", no_eos), ("temps", temps),
                        ("tables", block_tables)):
            getattr(st, name).copy_(t)
        for name in SPEC_CARRY:
            getattr(st, name).zero_()
        self.graphs.bind(params, kpool, vpool, *((spec[1],) + spec[2:4] if spec else ()))
        program = "spec_mixed" if spec else "mixed"
        parts = [self._slot_steps(st, params, kpool, vpool, rng, program, width, n, greedy, spec)
                 for width, n in passes]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def frame_loop(self, params, prompts, prompt_lens, limits, eos_ids, temps,
                   tables, cached, produced, last_tok, done, poison, nonfinite,
                   stats, rng, kpool, vpool, *, width, steps, greedy, repair=False):
        """One K-step serving FRAME (see the JAX ``frame_loop``): all
        per-slot state is carry-in/carry-out, so the host touches the loop
        only at frame boundaries. ``repair`` rolls a non-finite row back to
        its pre-step carry. Returns (tokens (steps, B), emit (steps, B),
        cached, produced, last_tok, done, poison, nonfinite, stats, rng,
        kpool, vpool); ``rng`` is a ``torch.Generator`` advanced in place by
        sampled steps."""
        body = _serving_scan_body(self._forward, params, prompts, prompt_lens,
                                  limits, eos_ids, temps, tables, width, greedy,
                                  repair=repair)
        toks, emit, carry = _run_steps(self._counted(body),
                                       (cached, produced, last_tok, done, poison,
                                        nonfinite, stats, rng, kpool, vpool), steps)
        return (toks, emit) + carry

    def frame_loop_spec(self, draft_runner, params, draft_params, prompts, prompt_lens,
                        limits, eos_ids, temps, tables, cached, produced, last_tok,
                        penult, done, poison, nonfinite, stats, rng, kpool, vpool,
                        dkpool, dvpool, *, width, steps, greedy, gamma, repair=False):
        """Speculative K-step serving frame (the JAX ``frame_loop_spec``
        without its tp branch): ``frame_loop`` with the draft riding the
        carry. Wide frames run the target step unchanged while the draft
        ingests the same chunks into its pools (``dkpool``/``dvpool``, which
        share the block tables); width-1 frames run gamma draft proposals
        and ONE gamma + 1 wide target verify a step, with per-row acceptance
        and rollback on the carry. ``penult`` is the token at position
        ``cached - 1``. Returns (tokens (steps, B, gamma + 1), emit (same),
        cached, produced, last_tok, penult, done, poison, nonfinite, stats,
        rng, kpool, vpool, dkpool, dvpool)."""
        body = _serving_scan_body(self._forward, params, prompts, prompt_lens, limits,
                                  eos_ids, temps, tables, width, greedy,
                                  draft=(draft_runner._forward, draft_params, gamma),
                                  repair=repair)
        toks, emit, carry = _run_steps(self._counted(body),
                                       (cached, produced, last_tok, penult, done, poison,
                                        nonfinite, stats, rng, kpool, vpool, dkpool, dvpool),
                                       steps, gamma)
        return (toks, emit) + carry

    def _counted(self, body):
        """``body`` counting each step it starts in ``steps_begun``."""
        def step(carry):
            self.steps_begun += 1
            return body(carry)
        return step

    def frame_in_place(self, slots, params, kv, *, width, steps, greedy, draft=None,
                       repair=False):
        """One serving frame on the static buffers of ``slots``' shape (the
        step-graph form of ``frame_loop`` and, with ``draft=(draft_runner,
        draft_params, draft_kv, gamma)``, of ``frame_loop_spec``): the slot
        table's tensors become those buffers, with their values, and are
        updated in place; so are the pools (the draft's too). ``repair``
        runs the rollback steps, under keys of their own. Returns (tokens,
        emit), each (steps, B), or (steps, B, gamma + 1) with a draft."""
        shape = (slots.n_slots, slots.prompts.shape[1], slots.tables.shape[1])
        st = self._claim_slots(shape, slots)
        if draft is None:
            self.graphs.bind(params, kv.k, kv.v)
            return self._slot_steps(st, params, kv.k, kv.v, slots.rng, "frame", width,
                                    steps, greedy, repair=repair)
        draft_runner, draft_params, draft_kv, gamma = draft
        self.graphs.bind(params, kv.k, kv.v, draft_params, draft_kv.k, draft_kv.v)
        return self._slot_steps(st, params, kv.k, kv.v, slots.rng, "spec_frame", width,
                                steps, greedy,
                                (draft_runner, draft_params, draft_kv.k, draft_kv.v, gamma),
                                repair=repair)

    def _claim_slots(self, shape, slots=None):
        """The static slot buffers of ``shape`` (B, prompt width, table
        width). A slot table that held them before gets copies of whatever
        it still shares with them; ``slots``, if given, then holds them:
        its values are copied in and its tensors are the buffers."""
        st = self._slot_sets.get(shape)
        if st is None:
            st = self._slot_sets[shape] = types.SimpleNamespace(
                shape=shape, owner=None, rows={}, **slot_state(*shape, self.device))
        if slots is not None and all(getattr(slots, n) is getattr(st, n) for n in SLOT_STATE):
            return st
        owner = st.owner() if st.owner is not None else None
        if owner is not None:
            for name in SLOT_STATE:
                if getattr(owner, name) is getattr(st, name):
                    setattr(owner, name, getattr(st, name).clone())
        st.owner = None
        if slots is not None:
            for name in SLOT_STATE:
                getattr(st, name).copy_(getattr(slots, name))
                setattr(slots, name, getattr(st, name))
            st.owner = weakref.ref(slots)
        return st

    def _slot_steps(self, st, params, kpool, vpool, rng, program, width, steps, greedy,
                    spec=None, repair=False):
        """``steps`` serving steps of program ``program`` on the static slot
        buffers ``st``, each writing its carry back in place. ``spec``
        (draft_runner, draft_params, dkpool, dvpool, gamma) makes them
        speculative steps, whose key adds gamma and the draft runner's tag;
        ``repair`` the rollback steps, a key of their own. Returns (tokens,
        emit), each (steps, B), or (steps, B, gamma + 1)."""
        key = (program, width, greedy, repair) + st.shape
        names, draft, tail, row = SLOT_CARRY, None, (rng, kpool, vpool), (st.shape[0],)
        if spec is not None:
            draft_runner, draft_params, dkpool, dvpool, gamma = spec
            key += (gamma, draft_runner.tag)
            names, draft = SPEC_CARRY, (draft_runner._forward, draft_params, gamma)
            tail, row = tail + (dkpool, dvpool), row + (gamma + 1,)
        rows = st.rows.get(row)
        if rows is None:
            rows = st.rows[row] = StepRows(row, (torch.int32, torch.bool), self.device)

        def one():
            body = _serving_scan_body(self._forward, params, st.prompts, st.prompt_lens,
                                      st.limits, st.eos_ids, st.temps, st.tables,
                                      width, greedy, draft=draft, repair=repair)
            carry, (tok, emit) = body(tuple(getattr(st, n) for n in names) + tail)
            for name, new in zip(names, carry):
                getattr(st, name).copy_(new)
            rows.write(tok, emit)

        def step():
            self.steps_begun += 1
            self.graphs.run(key, one, capture=greedy)

        return rows.loop(steps, step)


def _stack_rows(rows, b, dtype, device):
    """(steps, B) from a list of (B,) rows; (0, B) for none."""
    if rows:
        return torch.stack(rows)
    return torch.zeros((0, b), dtype=dtype, device=device)


def _run_steps(body, carry, steps, gamma=None):
    """``steps`` steps of a serving step ``body`` from ``carry``: (tokens,
    emit), each (steps, B) or, for a speculative body (``gamma``),
    (steps, B, gamma + 1), and the last carry."""
    toks, emits = [], []
    for _ in range(steps):
        carry, (t, em) = body(carry)
        toks.append(t)
        emits.append(em)
    if not toks:
        row = (0, carry[0].shape[0]) + (() if gamma is None else (gamma + 1,))
        dev = carry[0].device
        return (torch.zeros(row, dtype=torch.int32, device=dev),
                torch.zeros(row, dtype=torch.bool, device=dev), carry)
    return torch.stack(toks), torch.stack(emits), carry


def _serving_scan_body(fwd, params, prompts, prompt_lens, limits, eos_ids,
                       temps, tables, width, greedy, draft=None, repair=False):
    """One serving step over the carry (cached, produced, last_tok, done,
    poison, nonfinite, stats, rng, kpool, vpool). A row with
    ``cached < prompt_lens`` prefills up to ``width`` prompt tokens; a row
    past its prompt with ``produced < limits`` decodes one token; ``done``
    rows and rows at their limit freeze (width 0, positions -1, writes to
    the trash block). Emits (token or -1, emit mask) per step and adds the
    step's counters to ``stats``. ``draft=(draft_fwd, draft_params,
    gamma)`` makes it the speculative step (``_spec_scan_body``).

    ``repair=True`` (``nonfinite_policy="repair"``): a row whose logits go
    non-finite is not frozen; its carry selects back to the pre-step values
    (the step never happened for that row; the KV it wrote lies at or above
    the unchanged watermark, as rejected speculation does, and the retry
    overwrites it). The ``nonfinite`` latch still reports to the host,
    which escalates a persistent fault to quarantine."""
    if draft is not None:
        return _spec_scan_body(fwd, params, prompts, prompt_lens, limits, eos_ids,
                               temps, tables, width, greedy, *draft, repair=repair)

    def body(carry):
        (cached, produced, last_tok, done, poison, nonfinite, stats, rng,
         kpool, vpool) = carry
        prev_last, prev_done = last_tok, done
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
        emit, done, nonfinite, bad = _finite_check(logits, active, emit, done,
                                                   nonfinite)
        if repair:
            # no progress for a bad row this step: un-freeze, un-advance
            # (its emit is already cleared)
            last_tok = torch.where(bad, prev_last, last_tok)
            done = torch.where(bad, prev_done, done)
            w = torch.where(bad, 0, w)
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


def _spec_scan_body(fwd, params, prompts, prompt_lens, limits, eos_ids, temps, tables,
                    width, greedy, draft_fwd, draft_params, gamma, repair=False):
    """The speculative serving step (JAX ``_spec_scan_body``), with the
    repair selects of ``_serving_scan_body`` in its wide and verify steps.
    Carry: (cached, produced, last_tok, penult, done,
    poison, nonfinite, stats, rng, kpool, vpool, dkpool, dvpool); emissions
    are (B, gamma + 1). The finite check watches the target's verify
    logits.

    Invariants at every step boundary, per row: target KV is committed for
    positions [0, cached), and pool slots at or beyond ``cached`` may hold
    rejected speculation (dead until overwritten; the attention masks them
    by the chunk's first position); ``last_tok`` sits at position
    ``cached`` and is in no cache yet; ``penult`` is the token at
    ``cached - 1``; the draft's KV is valid for [0, cached - 1] at least
    (its width-2 first step re-feeds ``penult`` and ``last_tok``, which
    restores the slot a fully accepted step leaves it missing)."""
    k_out = gamma + 1

    if width > 1:
        def wide(carry):
            (cached, produced, last_tok, penult, done, poison, nonfinite, stats, rng,
             kpool, vpool, dkpool, dvpool) = carry
            prev_last, prev_done = last_tok, done
            b = cached.shape[0]
            prefilling, active, w, ids, positions = _wide_plan(
                prompts, prompt_lens, limits, width, cached, produced, last_tok, done)
            logits, kpool, vpool = fwd(params, ids, positions, tables, w, kpool, vpool)
            logits = _inject_poison(logits, poison)
            # the draft ingests the same chunk: prefill rows stream the
            # prompt into its pools, decode rows keep it on the committed prefix
            _, dkpool, dvpool = draft_fwd(draft_params, ids, positions, tables, w,
                                          dkpool, dvpool)
            if greedy:
                nxt = logits.argmax(dim=-1).to(torch.int32)
            else:
                nxt = sample_logits_per_row(logits, rng, temps)
            # the token at position cached + w - 1, read before _wide_emit
            # moves last_tok: the last prompt token of a row completing its
            # prefill, the consumed last_tok of a decode row
            tail = torch.gather(prompts, 1, (prompt_lens - 1).clamp_min(0)[:, None].long())[:, 0]
            new_penult = torch.where(prefilling, tail, last_tok)
            emit, last_tok, done = _wide_emit(active, prefilling, cached, w, prompt_lens,
                                              eos_ids, nxt, last_tok, done)
            emit, done, nonfinite, bad = _finite_check(logits, active, emit, done, nonfinite)
            if repair:
                # pre-step rollback; the cleared emit keeps penult and
                # produced as they were
                last_tok = torch.where(bad, prev_last, last_tok)
                done = torch.where(bad, prev_done, done)
                w = torch.where(bad, 0, w)
            penult = torch.where(emit, new_penult, penult)
            dev = cached.device
            toks_k = torch.cat([torch.where(emit, nxt, -1)[:, None].to(torch.int32),
                                torch.full((b, k_out - 1), -1, dtype=torch.int32, device=dev)], 1)
            emit_k = torch.cat([emit[:, None],
                                torch.zeros((b, k_out - 1), dtype=torch.bool, device=dev)], 1)
            # TARGET_FWD stays 0 on wide speculative steps: the speculative
            # accounting counts verify forwards only
            stats = stats + _stat_delta(
                emitted=emit, active=active, prefill_toks=torch.where(prefilling, w, 0),
                eos=emit & (nxt == eos_ids))
            return ((cached + w, produced + emit.to(torch.int32), last_tok, penult, done,
                     poison, nonfinite, stats, rng, kpool, vpool, dkpool, dvpool),
                    (toks_k, emit_k))

        return wide

    def body(carry):
        (cached, produced, last_tok, penult, done, poison, nonfinite, stats, rng,
         kpool, vpool, dkpool, dvpool) = carry
        prev_last, prev_penult, prev_done = last_tok, penult, done
        koffs = torch.arange(k_out, dtype=torch.int32, device=cached.device)
        # speculative frames run only when no slot prefills; a prefilling
        # row here would freeze
        active = ~done & (cached >= prompt_lens) & (produced < limits)
        # positions past the row's reservation (prompt + budget + 1) go to
        # the trash block: a clamped table gather would write rejected
        # speculation into the row's live last page. Their logits are never
        # emitted (index k needs produced + k < limits).
        cap = prompt_lens + limits

        def pos_of(p):
            return torch.where(active[:, None] & (p >= 0) & (p <= cap[:, None]), p,
                               -1).to(torch.int32)

        def propose(logits):
            if greedy:
                return logits.argmax(dim=-1).to(torch.int32)
            return sample_logits_per_row(logits, rng, temps)

        # draft phase: gamma proposals; the first re-feeds penult + last_tok
        av = active.to(torch.int32)
        ids0 = torch.stack([penult, last_tok], dim=1)
        pos0 = pos_of(torch.stack([cached - 1, cached], dim=1))
        dlog, dkpool, dvpool = draft_fwd(draft_params, ids0, pos0, tables, 2 * av,
                                         dkpool, dvpool)
        q, dlogits = [propose(dlog)], [dlog]
        for j in range(1, gamma):
            dlog, dkpool, dvpool = draft_fwd(draft_params, q[-1][:, None],
                                             pos_of((cached + j)[:, None]), tables, av,
                                             dkpool, dvpool)
            dlogits.append(dlog)
            q.append(propose(dlog))
        q = torch.stack(q, dim=1)                          # (B, G)
        dlogits = torch.stack(dlogits, dim=1)              # (B, G, V)

        # verify: ONE target forward over the last token and the G drafts
        ids_v = torch.cat([last_tok[:, None], q], dim=1)
        pos_v = pos_of(cached[:, None] + koffs[None, :])
        tlogits, kpool, vpool = fwd(params, ids_v, pos_v, tables, k_out * av, kpool, vpool,
                                    all_logits=True)
        tlogits = _inject_poison(tlogits, poison)
        n_acc, repl = speculative_verify_per_row(tlogits, dlogits, q, temps,
                                                 gen=None if greedy else rng)

        # accept and roll back: selects on the carry
        q_pad = torch.cat([q, q[:, -1:]], dim=1)          # (B, G + 1)
        e = torch.where(koffs[None, :] < n_acc[:, None], q_pad, repl[:, None])
        is_eos = e == eos_ids[:, None]
        eos_before = is_eos.to(torch.int32).cumsum(dim=1) - is_eos.to(torch.int32)
        emit = (active[:, None] & (koffs[None, :] <= n_acc[:, None])
                & (produced[:, None] + koffs[None, :] < limits[:, None]) & (eos_before == 0))
        emit, done, nonfinite, bad = _finite_check(tlogits, active, emit, done, nonfinite)
        m = emit.to(torch.int32).sum(dim=1, dtype=torch.int32)
        seq_toks = torch.cat([last_tok[:, None], e], dim=1)
        new_last = torch.gather(seq_toks, 1, m[:, None].long())[:, 0]
        new_penult = torch.gather(seq_toks, 1, (m - 1).clamp_min(0)[:, None].long())[:, 0]
        last_tok = torch.where(active, new_last, last_tok)
        penult = torch.where(active, new_penult, penult)
        done = done | (emit & is_eos).any(dim=1)
        if repair:
            # pre-step rollback; m is already 0 for a bad row (its emit
            # columns were cleared), so cached and produced stand still
            last_tok = torch.where(bad, prev_last, last_tok)
            penult = torch.where(bad, prev_penult, penult)
            done = torch.where(bad, prev_done, done)
        # verify forwards are the active rows; accepted drafts the emit
        # columns past the first
        stats = stats + _stat_delta(
            emitted=emit, active=active, eos=emit & is_eos, target_fwd=active,
            drafted=gamma * av, accepted=emit[:, 1:])
        return ((cached + m, produced + m, last_tok, penult, done, poison, nonfinite, stats,
                 rng, kpool, vpool, dkpool, dvpool),
                (torch.where(emit, e, -1), emit))

    return body


def _gather_pages(pool, layer, block_tables, dtype):
    """Layer ``layer``'s pages of an int8 pool through the block table,
    dequantized: (B, MB * bs, KVH, D) in ``dtype`` (JAX
    ``model_runner.py:195-205``)."""
    kvh, lanes = pool.shape[1], pool.shape[-1]
    b = block_tables.shape[0]
    pages = pool[layer][:, block_tables.long()]        # (KVH, B, MB, bs, lanes)
    pages = pages.reshape(kvh, b, -1, lanes).permute(1, 2, 0, 3)
    return dequantize_kv_lanes(pages, dtype)


def _paged_attention(q, kpages, vpages, positions, cfg, window=None, chunk_k=None,
                     chunk_v=None, chunk_start=None, alibi_slopes=None):
    """Masked softmax attention over gathered pages (JAX
    ``model_runner._paged_attention``). q: (B, C, H, D); kpages/vpages:
    (B, S_pad, KVH, D); positions: (B, C) absolute slot of each query (-1 =
    pad); a query at slot p sees slots <= p. ``chunk_k``/``chunk_v``:
    (B, C, KVH, D) the chunk's own KV, at key positions ``positions``; pool
    slots at or beyond ``chunk_start`` (B,) are stale and masked.
    ``window``: sliding-window width (<= 0 or None: global). Scores and
    softmax in f32, probabilities cast to q's dtype before P.V. Query head
    j reads kv head j // (H / KVH), as JAX's repeat does, without the
    repeat: the G query heads of a kv head form one batch of the products."""
    b, c, h, d = q.shape
    s_pad = kpages.shape[1]
    k_pos = torch.arange(s_pad, dtype=torch.int32, device=q.device)[None, :].expand(b, s_pad)
    if chunk_k is not None:
        kpages = torch.cat([kpages, chunk_k.to(kpages.dtype)], dim=1)
        vpages = torch.cat([vpages, chunk_v.to(vpages.dtype)], dim=1)
        k_pos = torch.cat([torch.where(k_pos < chunk_start[:, None], k_pos, -1),
                           torch.where(positions >= 0, positions, -1)], dim=1)
    kvh = kpages.shape[2]
    g = h // kvh
    scale = cfg.attn_scale if cfg.attn_scale is not None else d ** -0.5
    logits = torch.einsum("bckgd,bskd->bkgcs", q.reshape(b, c, kvh, g, d).float(),
                          kpages.float()).reshape(b, h, c, -1) * scale
    if alibi_slopes is not None:
        logits = logits + (alibi_slopes[None, :, None, None]
                           * (k_pos[:, None, None, :].float()
                              - positions.clamp_min(0)[:, None, :, None].float()))
    if cfg.attn_softcap:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    kp = k_pos[:, None, :]                               # (B, 1, S_total)
    mask = (kp >= 0) & (kp <= positions[:, :, None])     # pad keys and rows dead
    if window is not None:
        mask = mask & window_mask(positions[:, :, None], kp, window)
    logits = logits.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", probs.reshape(b, kvh, g, c, -1),
                       vpages.to(q.dtype))
    return out.reshape(b, c, h, d)
