"""Causal transformer LM: the serving and training model of the port.

Mirrors ``deepspeed_tpu/models/transformer.py`` for what the paged serving
path and the training path need: ``CausalLM`` with ``init`` (a plain dict
of tensors keyed like the JAX params tree, layer leaves stacked along a
leading layer axis), ``abstract_params``, ``_layer_windows``, the
homogeneous branch of ``walk_layer_plan`` (a Python loop in place of
``lax.scan``), the training forward and loss (``embed_fwd``, ``_layer_fn``,
``hidden_states``, ``head_loss``, ``apply``, ``loss``), the KV-cache decode
of the v1 inference engine (``init_cache``, ``apply_decode``), the loss
helpers ``lm_head_logits`` / ``masked_token_nll`` / ``logit_buffer_bytes``,
and ``build_model``. Heterogeneous (grouped) layer plans, MoE layers,
``act_quant_bits`` and the BERT-style encoders are not ported yet (ROADMAP.md
section A, item 2).

The training forward keeps the parameters f32 and stacked (L, ...). Each
stacked leaf that JAX casts with ``.astype(dt)`` is cast to the activation
dtype once per forward, then split into per-layer views with one
``torch.unbind`` per leaf: the backward of ``unbind`` stacks the layer
gradients into one (L, ...) tensor, where indexing ``leaf[i]`` per layer
would write a full (L, ...) zero tensor per layer. The backward of the
cast yields f32 gradients, as JAX's ``astype`` does. Norm leaves stay in
their stored dtype (``apply_norm`` reads them in f32).
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..accelerator import get_device
from ..ops.cross_entropy import lm_cross_entropy
from . import layers as L
from .config import TransformerConfig, get_config


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked layer tree: the same dict with every leaf
    indexed on its leading (layer) axis, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def training_layer_views(layers_params, num_layers: int, dt):
    """Per-layer param trees for the training forward: every stacked leaf
    outside a norm group cast to ``dt`` once, then unbound along the layer
    axis (see the module docstring)."""
    def split(tree, in_norm=False):
        out = {}
        for k, v in tree.items():
            norm = in_norm or "norm" in k
            if isinstance(v, dict):
                out[k] = split(v, norm)
            else:
                out[k] = (v if norm else v.to(dt)).unbind(0)
        return out

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    views = split(layers_params)
    return [pick(views, i) for i in range(num_layers)]


def lm_head_logits(h, w, transpose, dt, bias=None, softcap=0.0):
    """logits = h @ (w if transpose else w.T) (+ bias): (B, S, E) -> (B, S, V).

    ``softcap``: final-logit softcapping (cap * tanh(logits / cap))."""
    w = w.to(dt)
    logits = h @ (w if transpose else w.t())
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def masked_token_nll(logits, labels, loss_mask=None):
    """Mean f32 cross-entropy over (B, S) tokens; ``loss_mask`` weights (or
    drops) positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logits
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)


def logit_buffer_bytes(n_tokens, cfg):
    """Size of the (B, S, V) logits the dense loss would materialize: the
    chunked cross-entropy's engagement test."""
    return n_tokens * cfg.vocab_size * (2 if cfg.act_dtype != torch.float32 else 4)


def walk_layer_plan(layers_params, num_layers: int, xs, carry, body):
    """Drive ``body(carry, lp, xs_t) -> (carry, y)`` over a homogeneous
    layer stack in order. ``xs`` is a tuple of per-layer sequences (length
    ``num_layers``); returns (carry, [y per layer])."""
    ys = []
    for i in range(num_layers):
        carry, y = body(carry, layer_slice(layers_params, i),
                        tuple(x[i] for x in xs))
        ys.append(y)
    return carry, ys


class CausalLM:
    """Decoder-only LM covering the dense GPT-2 / Llama families."""

    def __init__(self, cfg: TransformerConfig):
        if cfg.is_moe or cfg.layer_types is not None:
            raise NotImplementedError(
                "MoE and heterogeneous layer stacks are not ported yet "
                "(ROADMAP.md section A, item 2)")
        self.cfg = cfg
        self._slopes = {}   # ALiBi slopes by device

    def alibi_slopes(self, device):
        """The (H,) ALiBi slopes on ``device``, made once per device, so that
        no decode step copies them to the card (a CUDA graph cannot)."""
        device = torch.device(device)
        if device not in self._slopes:
            self._slopes[device] = L.alibi_slopes(self.cfg.num_heads, device)
        return self._slopes[device]

    def inv_freq(self, device=None):
        """RoPE inverse frequencies (d/2,) f32, or None without rotary."""
        if self.cfg.position != "rope":
            return None
        return L.rope_frequencies(self.cfg, device)

    # -- init --

    def _init_layer(self, gen, dtype, device):
        cfg = self.cfg
        params = {"attn": L.init_attention(gen, cfg, dtype, device),
                  "mlp": L.init_mlp(gen, cfg, dtype, device),
                  "norm1": L.init_norm(cfg, dtype, device),
                  "norm2": L.init_norm(cfg, dtype, device)}
        if cfg.sandwich_norm:   # Gemma-2 post-attn / post-ffw output norms
            for nm in ("norm3", "norm4"):
                params[nm] = L.init_norm(cfg, dtype, device)
        return params

    def init(self, gen=None, *, device=None, dtype=None, cut=None):
        """Random parameters: ``{"embed", "layers", "final_norm"}`` with each
        layer leaf stacked to (L, ...). ``gen`` is a ``torch.Generator`` on
        ``device`` (seeded 0 when omitted); ``device`` defaults to the
        current CUDA device and raises without a GPU (``get_device``);
        ``dtype`` is the storage dtype (default the config's
        ``param_dtype``). Layers are drawn one at a time into preallocated
        stacks, so the peak is one layer over the final size. ``cut(path,
        leaf)`` (ZeRO stage 3) keeps a part of each drawn leaf, a layer
        leaf without its layer dim: every leaf is drawn whole, in the same
        order, so the kept parts are those of the uncut draw."""
        cfg = self.cfg
        device = get_device(device)
        dtype = cfg.p_dtype if dtype is None else dtype
        if gen is None and device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(0)
        keep = (lambda tree, root: tree) if cut is None else (
            lambda tree, root: _map_paths(cut, tree, (root,)))
        emb = keep(L.init_embeddings(gen, cfg, dtype, device), "embed")
        stacked = None
        for i in range(cfg.num_layers):
            layer = keep(self._init_layer(gen, dtype, device), "layers")
            if stacked is None:
                stacked = _map(lambda t: torch.empty(
                    (cfg.num_layers,) + tuple(t.shape), dtype=t.dtype,
                    device=t.device), layer)
            _zip_copy(stacked, layer, i)
        return {"embed": emb, "layers": stacked,
                "final_norm": keep(L.init_norm(cfg, dtype, device), "final_norm")}

    def abstract_params(self, dtype=None):
        """The params tree on the meta device: shapes and dtypes, no memory."""
        return self.init(device="meta", dtype=dtype)

    def logical_axes(self):
        """The logical-axis names of every leaf of ``init``'s tree (JAX
        ``CausalLM.logical_axes``): tuples mirroring the params, stacked
        layer leaves with a leading "layers" axis. Serving quantization
        finds the contracted axes of each matmul weight by these names."""
        def axes(tree, path):
            return {k: axes(v, path + (k,)) if isinstance(v, dict) else _leaf_axes(path + (k,), v)
                    for k, v in tree.items()}

        return axes(self.abstract_params(), ())

    # -- training forward and loss --

    def embed_fwd(self, embed_params, input_ids, positions=None):
        """Token (+ learned position) embedding lookup: (B, S) -> (B, S, E)."""
        cfg = self.cfg
        dt = cfg.act_dtype
        input_ids = input_ids.long()
        h = embed_params["tok"].to(dt)[input_ids]
        if cfg.embed_scale != 1.0:   # Gemma: sqrt(E), cast like HF's normalizer
            h = h * torch.tensor(cfg.embed_scale, dtype=dt)
        if cfg.position == "learned":
            if positions is None:
                positions = torch.arange(input_ids.shape[1], device=h.device).expand(
                    input_ids.shape)
            h = h + embed_params["pos"].to(dt)[positions.long() + cfg.position_offset]
        if cfg.embedding_norm:   # BLOOM post-embedding layernorm
            h = L.apply_norm(embed_params["emb_norm"], h, cfg)
        return h

    def _layer_fn(self, lp, h, positions, segment_ids, inv_freq, window=None):
        """One pre-norm decoder layer: (B, S, E) -> (B, S, E)."""
        cfg = self.cfg
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        attn_out = L.apply_attention(lp["attn"], a_in, cfg, positions=positions,
                                     inv_freq=inv_freq, segment_ids=segment_ids,
                                     window=window)
        if cfg.sandwich_norm:   # Gemma-2: norm the sublayer OUTPUT pre-residual
            attn_out = L.apply_norm(lp["norm3"], attn_out, cfg)
        if cfg.parallel_block:
            # NeoX/Falcon parallel residual: attn and mlp both read the
            # pre-attention stream; one residual add
            m_in = L.apply_norm(lp["norm2"], h, cfg)
        else:
            h = h + attn_out
            m_in = L.apply_norm(lp["norm2"], h, cfg)
        mlp_out = L.apply_mlp(lp["mlp"], m_in, cfg)
        if cfg.sandwich_norm:
            mlp_out = L.apply_norm(lp["norm4"], mlp_out, cfg)
        if cfg.parallel_block:
            return h + attn_out + mlp_out
        return h + mlp_out

    def hidden_states(self, params, input_ids, *, positions=None, segment_ids=None,
                      gather=None):
        """Embed + layer stack + final norm: (B, S) -> (B, S, E).

        ``cfg.remat``: "none", or "full" (each layer recomputed in the
        backward through ``torch.utils.checkpoint``). ``gather`` (ZeRO stage
        3, ``runtime/zero/partition.py`` ``LayerGather``): ``params`` holds
        the whole embedding and final norm (``gather.outer``) and the layer
        shards; each layer's weights are gathered inside its layer function,
        so the recomputation under "full" gathers them again."""
        cfg = self.cfg
        if cfg.act_quant_bits or cfg.post_norm:
            raise NotImplementedError(
                "act_quant_bits and post-norm blocks are not ported yet "
                "(ROADMAP.md section A, item 2)")
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(
                f"remat policy {cfg.remat!r} is not ported (the port has 'none' and "
                "'full'; ROADMAP.md section A, item 16)")
        h = self.embed_fwd(params["embed"], input_ids, positions)
        if positions is not None:
            positions = positions.long()
        inv_freq = self.inv_freq(h.device)
        windows = self._layer_windows() or [None] * cfg.num_layers
        if gather is None:
            layer = training_layer_views(params["layers"], cfg.num_layers,
                                         cfg.act_dtype).__getitem__
        else:
            layer = gather.layer
        for i, win in enumerate(windows):
            if cfg.remat == "full":
                h = checkpoint(self._layer_at, layer, i, h, positions, segment_ids, inv_freq, win,
                               use_reentrant=False)
            else:
                h = self._layer_at(layer, i, h, positions, segment_ids, inv_freq, win)
        return L.apply_norm(params["final_norm"], h, cfg)

    def _layer_at(self, layer, i, h, positions, segment_ids, inv_freq, window):
        """Layer ``i`` on the weights ``layer(i)`` returns: the unbound views,
        or (ZeRO stage 3) the weights gathered whole, inside the layer
        function so that the recomputation gathers them again."""
        return self._layer_fn(layer(i), h, positions, segment_ids, inv_freq, window)

    def _lm_head_weight(self, params):
        """(w, transpose): logits = h @ (w.T if not transpose else w)."""
        if self.cfg.tie_embeddings:
            return params["embed"]["tok"], False
        return params["embed"]["lm_head"], True

    def _chunked_loss(self, n_tokens):
        cfg = self.cfg
        return (cfg.loss_chunks > 0 and cfg.vocab_size >= 4096
                and logit_buffer_bytes(n_tokens, cfg) > cfg.loss_chunk_threshold_bytes)

    def head_loss(self, head_params, h, labels, loss_mask=None):
        """Final norm + lm head + cross-entropy from hidden states.
        ``head_params``: {"embed": ..., "final_norm": ...}."""
        cfg = self.cfg
        h = L.apply_norm(head_params["final_norm"], h, cfg)
        w, transpose = self._lm_head_weight(head_params)
        if self._chunked_loss(labels.numel()):
            return lm_cross_entropy(h, w.to(h.dtype), labels, loss_mask=loss_mask,
                                    n_chunks=cfg.loss_chunks, transpose_w=transpose,
                                    softcap=cfg.logit_softcap)
        logits = lm_head_logits(h, w, transpose, cfg.act_dtype, softcap=cfg.logit_softcap)
        return masked_token_nll(logits, labels, loss_mask)

    def apply(self, params, input_ids, *, positions=None, segment_ids=None, gather=None):
        """input_ids: (B, S) -> logits (B, S, V). ``gather``: ZeRO stage 3's
        parameter gathers (``hidden_states``)."""
        if gather is not None:
            params = gather.outer(params)
        h = self.hidden_states(params, input_ids, positions=positions,
                               segment_ids=segment_ids, gather=gather)
        w, transpose = self._lm_head_weight(params)
        return lm_head_logits(h, w, transpose, self.cfg.act_dtype,
                              bias=params["embed"].get("lm_head_bias"),
                              softcap=self.cfg.logit_softcap)

    def loss(self, params, batch, gather=None):
        """batch: dict(input_ids (B, S), labels (B, S), optional loss_mask,
        positions, segment_ids). f32 cross-entropy; past
        ``loss_chunk_threshold_bytes`` of logits the vocab-chunked fused loss
        takes over and the (B, S, V) logits never exist. ``gather``: ZeRO
        stage 3's parameter gathers (``hidden_states``)."""
        cfg = self.cfg
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if self._chunked_loss(batch["input_ids"].numel()):
            if gather is not None:
                params = gather.outer(params)
            h = self.hidden_states(params, batch["input_ids"],
                                   positions=batch.get("positions"),
                                   segment_ids=batch.get("segment_ids"), gather=gather)
            w, transpose = self._lm_head_weight(params)
            return lm_cross_entropy(h, w.to(h.dtype), labels, loss_mask=mask,
                                    n_chunks=cfg.loss_chunks, transpose_w=transpose,
                                    softcap=cfg.logit_softcap)
        logits = self.apply(params, batch["input_ids"], positions=batch.get("positions"),
                            segment_ids=batch.get("segment_ids"), gather=gather)
        return masked_token_nll(logits, labels, mask)

    # -- decode (KV cache) --

    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        """Stacked KV cache: {"k", "v"}, each (L, B, S_max, KVH, D) zeros in
        ``dtype`` (default the activation dtype) on ``device`` (default the
        current CUDA device, raising without a GPU)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.kv_heads, cfg.dims_per_head)
        kw = dict(dtype=dtype or cfg.act_dtype, device=get_device(device))
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    def apply_decode(self, params, input_ids, cache, cache_len, *, last_only=False):
        """Incremental forward: input_ids (B, S_new) at cache slots
        ``cache_len + i``; returns (logits, cache). A Python loop over the
        layers in place of the JAX ``lax.scan``; each layer writes its new
        keys and values into ``cache`` IN PLACE (the returned cache is the
        same dict of tensors). ``last_only`` computes the LM head on the last
        position only, (B, 1, V), which is all that generation reads."""
        cfg = self.cfg
        if cfg.act_quant_bits or cfg.post_norm:
            raise NotImplementedError(
                "act_quant_bits and post-norm blocks are not ported yet "
                "(ROADMAP.md section A, item 2)")
        s = input_ids.shape[1]
        dev = cache["k"].device
        positions = cache_len.to(dev).long()[:, None] + torch.arange(s, device=dev)[None, :]
        h = self.embed_fwd(params["embed"], input_ids.to(dev), positions)
        attn_bias = None
        if cfg.position == "alibi":
            attn_bias = L.alibi_bias(cfg.num_heads, positions,
                                     torch.arange(cache["k"].shape[2], device=dev),
                                     slopes=self.alibi_slopes(dev))
        inv_freq = self.inv_freq(dev)
        # one set of rotary sines and cosines serves every layer
        sin_cos = L.rope_sin_cos(positions, inv_freq) if cfg.position == "rope" else None
        cache_len = cache_len.to(dev)
        windows = self._layer_windows() or [None] * cfg.num_layers
        for li, win in enumerate(windows):
            lp = layer_slice(params["layers"], li)
            a_in = L.apply_norm(lp["norm1"], h, cfg)
            attn_out, _ = L.apply_attention(lp["attn"], a_in, cfg, positions=positions,
                                            inv_freq=inv_freq,
                                            kv_cache=(cache["k"][li], cache["v"][li]),
                                            cache_len=cache_len, attn_bias=attn_bias,
                                            window=win, sin_cos=sin_cos)
            if cfg.sandwich_norm:
                attn_out = L.apply_norm(lp["norm3"], attn_out, cfg)
            if cfg.parallel_block:
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            else:
                h = h + attn_out
                m_in = L.apply_norm(lp["norm2"], h, cfg)
            mlp_out = L.apply_mlp(lp["mlp"], m_in, cfg)
            if cfg.sandwich_norm:
                mlp_out = L.apply_norm(lp["norm4"], mlp_out, cfg)
            h = h + attn_out + mlp_out if cfg.parallel_block else h + mlp_out
        if last_only:
            h = h[:, -1:]
        h = L.apply_norm(params["final_norm"], h, cfg)
        w, transpose = self._lm_head_weight(params)
        logits = lm_head_logits(h, w, transpose, cfg.act_dtype,
                                bias=params["embed"].get("lm_head_bias"),
                                softcap=cfg.logit_softcap)
        return logits, cache

    def _layer_windows(self):
        """Per-layer window list for mixed local/global patterns
        (``local_attention_every``, explicit ``window_pattern``), or None
        when layers are homogeneous (a uniform window flows through
        ``cfg.sliding_window``)."""
        cfg = self.cfg
        if cfg.window_pattern is not None:
            return [int(w) for w in cfg.window_pattern]
        if cfg.sliding_window is None or not cfg.local_attention_every:
            return None
        n = cfg.local_attention_every
        return [cfg.sliding_window if i % n == n - 1 else 0
                for i in range(cfg.num_layers)]


# logical axes by leaf name (JAX ``layers.init_*``'s axes trees); norm
# scales and biases are ("embed",), q/k norm leaves "unmodeled" per dim
_AXES = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"), "wo_attn": ("heads", "head_dim", "embed"),
         "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
         "bv": ("kv_heads", "head_dim"), "bo": ("embed",),
         "wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wi": ("embed", "mlp"),
         "wo_mlp": ("mlp", "embed"), "bi": ("mlp",),
         "tok": ("vocab", "embed"), "pos": ("unmodeled", "embed"),
         "type": ("unmodeled", "embed"), "lm_head": ("embed", "vocab"),
         "lm_head_bias": ("vocab",), "scale": ("embed",), "bias": ("embed",)}


def _leaf_axes(path, leaf):
    """Axis names of the leaf at ``path`` (keys from the root)."""
    name = path[-1]
    if any(k in ("q_norm", "k_norm") for k in path):
        ax = ("unmodeled",) * (leaf.dim() - (path[0] == "layers"))
    elif name == "wo":
        ax = _AXES["wo_attn" if path[-2] == "attn" else "wo_mlp"]
    else:
        ax = _AXES[name]
    return ("layers",) + ax if path[0] == "layers" else ax


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _map_paths(fn, tree, path):
    """``fn(path, leaf)`` over a tree, ``path`` the keys from the root."""
    return {k: _map_paths(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def _zip_copy(stacked, layer, i):
    for k, v in layer.items():
        if isinstance(v, dict):
            _zip_copy(stacked[k], v, i)
        elif v.device.type != "meta":
            stacked[k][i].copy_(v)


def build_model(name_or_cfg, **overrides) -> CausalLM:
    if isinstance(name_or_cfg, str):
        cfg = get_config(name_or_cfg, **overrides)
    elif isinstance(name_or_cfg, TransformerConfig):
        cfg = name_or_cfg.replace(**overrides) if overrides else name_or_cfg
    else:
        raise TypeError(
            f"build_model expects preset name or TransformerConfig, got {type(name_or_cfg)}")
    if cfg.mlm_head or not cfg.causal:
        raise NotImplementedError(
            "BERT-style encoders are not ported yet (ROADMAP.md, section A)")
    return CausalLM(cfg)
