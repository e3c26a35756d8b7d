"""Causal transformer LM: the serving model of the port.

Mirrors ``deepspeed_tpu/models/transformer.py`` for what the paged serving
path needs: ``CausalLM`` with ``init`` (a plain dict of tensors keyed like
the JAX params tree, layer leaves stacked along a leading layer axis),
``abstract_params``, ``_layer_windows``, the homogeneous branch of
``walk_layer_plan`` (a Python loop in place of ``lax.scan``) and
``build_model``. Heterogeneous (grouped) layer plans, MoE layers and the
BERT-style encoders are not ported yet (see ROADMAP.md).
"""

import torch

from ..accelerator import get_device
from . import layers as L
from .config import TransformerConfig, get_config


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked layer tree: the same dict with every leaf
    indexed on its leading (layer) axis, as views."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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
                "(ROADMAP.md, section A)")
        self.cfg = cfg

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

    def init(self, gen=None, *, device=None, dtype=None):
        """Random parameters: ``{"embed", "layers", "final_norm"}`` with each
        layer leaf stacked to (L, ...). ``gen`` is a ``torch.Generator`` on
        ``device`` (seeded 0 when omitted); ``device`` defaults to the
        current CUDA device and raises without a GPU (``get_device``);
        ``dtype`` is the storage dtype (default the config's
        ``param_dtype``). Layers are drawn one at a time into preallocated
        stacks, so the peak is one layer over the final size."""
        cfg = self.cfg
        device = get_device(device)
        dtype = cfg.p_dtype if dtype is None else dtype
        if gen is None and device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(0)
        emb = L.init_embeddings(gen, cfg, dtype, device)
        stacked = None
        for i in range(cfg.num_layers):
            layer = self._init_layer(gen, dtype, device)
            if stacked is None:
                stacked = _map(lambda t: torch.empty(
                    (cfg.num_layers,) + tuple(t.shape), dtype=t.dtype,
                    device=t.device), layer)
            _zip_copy(stacked, layer, i)
        return {"embed": emb, "layers": stacked,
                "final_norm": L.init_norm(cfg, dtype, device)}

    def abstract_params(self, dtype=None):
        """The params tree on the meta device: shapes and dtypes, no memory."""
        return self.init(device="meta", dtype=dtype)

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


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


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
