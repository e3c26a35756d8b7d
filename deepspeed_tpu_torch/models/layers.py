"""Transformer layer primitives: plain functions over dicts of tensors.

Mirrors the dense subset of ``deepspeed_tpu/models/layers.py`` that the
serving, training and v1 inference paths run: norms, rotary embeddings,
ALiBi slopes and bias, q/k norms, ``apply_attention`` (training and
KV-cache branches) with ``_scatter_cache``, the MLP, and the
initializers of the attention, MLP, norm and embedding
leaves (same leaf names, shapes and distributions: normal(0.02), output
projections scaled by 1/sqrt(2L), the untied LM head by E^-0.5), drawn from
a ``torch.Generator``. Sharding axes are not carried: the port's slice
serves on one device.
"""

import math

import torch
import torch.nn.functional as F

from ..ops.attention import decode_attention, multihead_attention
from .config import TransformerConfig

# ---- init helpers -------------------------------------------------------


def _normal(gen, shape, dtype, stddev, device):
    """normal(0, stddev) drawn in f32 and cast, as the JAX initializer does.
    On the meta device only the shape and dtype are made
    (``CausalLM.abstract_params``)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * stddev).to(dtype)


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def bcast(w, ndim: int):
    """Left-pad ``w`` with size-1 axes to rank ``ndim`` (explicit
    trailing-dim broadcasting, as the JAX forward writes it)."""
    return w.reshape((1,) * (ndim - w.dim()) + tuple(w.shape))


# ---- norms --------------------------------------------------------------


def init_norm(cfg: TransformerConfig, dtype, device):
    params = {"scale": _ones((cfg.hidden_size,), dtype, device)}
    if cfg.norm == "layernorm":
        params["bias"] = _zeros((cfg.hidden_size,), dtype, device)
    return params


def apply_norm(params, x, cfg: TransformerConfig):
    """RMSNorm or LayerNorm over the last axis in f32, cast back to x's
    dtype. The fused torch norms compute the JAX formula
    ((x - mean) * rsqrt(var + eps) * scale + bias) and save only their
    input and row statistics for the backward."""
    x32 = x.float()
    shape = (x.shape[-1],)
    if cfg.norm == "rmsnorm":
        y = F.rms_norm(x32, shape, params["scale"].float(), cfg.norm_eps)
    else:
        y = F.layer_norm(x32, shape, params["scale"].float(), params["bias"].float(),
                         cfg.norm_eps)
    return y.to(x.dtype)


# ---- rotary embeddings --------------------------------------------------


def rope_frequencies(cfg: TransformerConfig, device=None):
    d = int(cfg.dims_per_head * cfg.rotary_pct)  # partial rotary (GPT-NeoX)
    d -= d % 2
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (cfg.rope_theta ** exps)        # (d/2,)


def rope_sin_cos(positions, inv_freq):
    """The sines and cosines of rotary angles: positions (B, S) int ->
    (sin, cos), each (B, S, 1, rd/2) f32."""
    angles = positions[..., None].float() * inv_freq[None, None, :]  # (B, S, rd/2)
    return torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]


def apply_rope(x, positions, inv_freq, *, interleaved=False, sin_cos=None):
    """x: (B, S, H, D); positions: (B, S) int.

    ``inv_freq`` has rd/2 entries where rd <= D is the rotary span (partial
    rotary); dims past rd pass through untouched. ``interleaved`` uses the
    (x0,x1),(x2,x3)... pair layout (GPT-J/NeoX) instead of split halves.
    ``sin_cos``: ``rope_sin_cos(positions, inv_freq)``, made once for every
    layer of a step by a caller that has it."""
    rd = 2 * inv_freq.shape[0]
    rot = x[..., :rd].float()
    sin, cos = sin_cos if sin_cos is not None else rope_sin_cos(positions, inv_freq)
    if interleaved:
        x1 = rot[..., 0::2]
        x2 = rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(rot.shape)
    else:
        x1, x2 = rot.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < x.shape[-1]:
        out = torch.cat([out, x[..., rd:].float()], dim=-1)
    return out.to(x.dtype)


# ---- ALiBi --------------------------------------------------------------


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.; the layout HF BLOOM uses): a
    geometric sequence from 2^(-8/n) for a power-of-two head count, else the
    closest power of two's sequence extended with the odd-indexed slopes of
    the doubled one."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        base = 2 ** math.floor(math.log2(num_heads))
        s = pow2_slopes(base) + pow2_slopes(2 * base)[0::2][: num_heads - base]
    return torch.tensor(s, dtype=torch.float32, device=device)


def alibi_bias(num_heads: int, q_pos, k_pos, slopes=None) -> torch.Tensor:
    """Additive attention bias slope_h * (k - q): (..., H, Sq, Sk) f32.

    q_pos: (Sq,) or (B, Sq); k_pos: (Sk,); ``slopes``: the (H,) slopes on
    k_pos's device, made here when omitted. The relative form differs from
    HF's per-key-position form by a per-row constant, which softmax
    cancels."""
    if slopes is None:
        slopes = alibi_slopes(num_heads, k_pos.device)                   # (H,)
    rel = (k_pos[None, :] - q_pos[..., :, None]).float()                  # (..., Sq, Sk)
    return slopes[:, None, None] * rel[..., None, :, :]


# ---- attention ----------------------------------------------------------


def init_attention(gen, cfg: TransformerConfig, dtype, device):
    e, h, kvh, d = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    std = 0.02
    params = {
        "wq": _normal(gen, (e, h, d), dtype, std, device),
        "wk": _normal(gen, (e, kvh, d), dtype, std, device),
        "wv": _normal(gen, (e, kvh, d), dtype, std, device),
        "wo": _normal(gen, (h, d, e), dtype, std / math.sqrt(2 * cfg.num_layers), device),
    }
    if cfg.use_bias or cfg.qkv_bias:
        params.update(bq=_zeros((h, d), dtype, device),
                      bk=_zeros((kvh, d), dtype, device),
                      bv=_zeros((kvh, d), dtype, device))
    out_bias = cfg.use_bias if cfg.out_bias is None else cfg.out_bias
    if out_bias:
        params["bo"] = _zeros((e,), dtype, device)
    if cfg.qk_norm:
        q_shape, k_shape = {
            "full": ((h * d,), (kvh * d,)),
            "head_dim": ((d,), (d,)),
            "per_head": ((h, d), (kvh, d)),
        }[cfg.qk_norm]
        for nm, shape in (("q_norm", q_shape), ("k_norm", k_shape)):
            grp = {"scale": _ones(shape, dtype, device)}
            if cfg.norm == "layernorm" and cfg.qk_norm_bias:
                grp["bias"] = _zeros(shape, dtype, device)
            params[nm] = grp
    return params


def apply_qk_norm(norm_params, x, cfg: TransformerConfig):
    """Normalize q or k heads: x (B, S, H, D). "full" normalizes the
    flattened per-token (H*D) vector; "head_dim"/"per_head" each head's D
    dims (the weight is shared or per head)."""
    b, s, h, d = x.shape
    x32 = x.float()
    if cfg.qk_norm == "full":
        x32 = x32.reshape(b, s, h * d)
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    y = y * bcast(norm_params["scale"].float(), y.dim())
    if "bias" in norm_params:
        y = y + bcast(norm_params["bias"].float(), y.dim())
    return y.reshape(b, s, h, d).to(x.dtype)


def apply_attention(params, x, cfg: TransformerConfig, *, positions=None, inv_freq=None,
                    segment_ids=None, window=None, kv_cache=None, cache_len=None,
                    attn_bias=None, sin_cos=None):
    """The JAX ``apply_attention``: x (B, S, E). q/k/v projections, biases,
    q/k norm and RoPE, attention, and the output projection. ``window``:
    this layer's sliding window (int, or a tensor; <= 0 is global); None
    takes a uniform ``cfg.sliding_window``.

    Training (``kv_cache`` None) returns y (B, S, E): ``multihead_attention``
    (the flash kernels on the card where eligible; an ALiBi model passes its
    slopes down). Decode (``kv_cache`` = (k, v), each (B, S_max, KVH, D))
    writes the S new keys and values at slots ``cache_len + i`` and returns
    ``(y, (k, v))`` through ``decode_attention`` (the fused decode kernel
    where eligible). The cache is updated IN PLACE and the same tensors are
    returned, where JAX returns a new cache. ``attn_bias``: a precomputed
    (B, H, S, S_max) ALiBi bias, built here when an ALiBi model passes
    none. ``sin_cos``: the rotary sines and cosines of ``positions``
    (``rope_sin_cos``), when the caller made them once for every layer."""
    if window is None and cfg.sliding_window is not None and cfg.local_attention_every is None:
        window = cfg.sliding_window   # uniform window (Mistral)
    dt = cfg.act_dtype
    b, s, e = x.shape
    h, kvh, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    q = _mm(x, params["wq"].to(dt).reshape(e, h * d)).view(b, s, h, d)
    k = _mm(x, params["wk"].to(dt).reshape(e, kvh * d)).view(b, s, kvh, d)
    v = _mm(x, params["wv"].to(dt).reshape(e, kvh * d)).view(b, s, kvh, d)
    if cfg.use_bias or cfg.qkv_bias:
        q = q + bcast(params["bq"].to(dt), q.dim())
        k = k + bcast(params["bk"].to(dt), k.dim())
        v = v + bcast(params["bv"].to(dt), v.dim())
    if cfg.qk_norm:
        q = apply_qk_norm(params["q_norm"], q, cfg)
        k = apply_qk_norm(params["k_norm"], k, cfg)
    if cfg.position == "rope":
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q = apply_rope(q, positions, inv_freq, interleaved=cfg.rope_interleaved,
                       sin_cos=sin_cos)
        k = apply_rope(k, positions, inv_freq, interleaved=cfg.rope_interleaved,
                       sin_cos=sin_cos)
    if kv_cache is not None:
        ck, cv = kv_cache
        idx = cache_len.long()[:, None] + torch.arange(s, device=x.device)[None, :]   # (B, S)
        _scatter_cache(ck, k, idx)
        _scatter_cache(cv, v, idx)
        bias = attn_bias
        if cfg.position == "alibi" and bias is None:
            bias = alibi_bias(cfg.num_heads, idx, torch.arange(ck.shape[1], device=x.device))
        out = decode_attention(q, ck, cv, cache_len + s, bias=bias, window=window,
                               scale=cfg.attn_scale, softcap=cfg.attn_softcap)
    else:
        slopes = alibi_slopes(cfg.num_heads, x.device) if cfg.position == "alibi" else None
        out = multihead_attention(q, k, v, causal=cfg.causal, segment_ids=segment_ids,
                                  alibi_slopes=slopes, window=window,
                                  impl=None if cfg.attn_impl == "auto" else cfg.attn_impl,
                                  scale=cfg.attn_scale, softcap=cfg.attn_softcap)
    y = _mm(out.reshape(b, s, h * d), params["wo"].to(dt).reshape(h * d, e))
    if "bo" in params:
        y = y + bcast(params["bo"].to(dt), y.dim())
    return y if kv_cache is None else (y, (ck, cv))


def _scatter_cache(cache, new, idx):
    """cache: (B, S_max, H, D); new: (B, S, H, D); idx: (B, S) slots.
    Writes ``new`` at ``cache[b, idx[b, s]]`` in place and returns cache."""
    bidx = torch.arange(cache.shape[0], device=cache.device)[:, None].expand_as(idx)
    cache[bidx, idx] = new.to(cache.dtype)
    return cache


# ---- MLP ----------------------------------------------------------------


def init_mlp(gen, cfg: TransformerConfig, dtype, device):
    e, f = cfg.hidden_size, cfg.ffn_size
    std = 0.02
    wo_std = std / math.sqrt(2 * cfg.num_layers)
    if cfg.activation in ("swiglu", "geglu"):
        params = {"wi_gate": _normal(gen, (e, f), dtype, std, device),
                  "wi_up": _normal(gen, (e, f), dtype, std, device),
                  "wo": _normal(gen, (f, e), dtype, wo_std, device)}
    else:
        params = {"wi": _normal(gen, (e, f), dtype, std, device),
                  "wo": _normal(gen, (f, e), dtype, wo_std, device)}
    mlp_bias = cfg.use_bias if cfg.mlp_bias is None else cfg.mlp_bias
    if mlp_bias:
        params.update(bi=_zeros((f,), dtype, device), bo=_zeros((e,), dtype, device))
    return params


def _mm(x, w):
    """(..., K) @ (K, N) as one 2-D GEMM."""
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])


def apply_mlp(params, x, cfg: TransformerConfig):
    dt = cfg.act_dtype
    mlp_bias = cfg.use_bias if cfg.mlp_bias is None else cfg.mlp_bias
    if cfg.activation in ("swiglu", "geglu"):
        g = _mm(x, params["wi_gate"].to(dt))
        u = _mm(x, params["wi_up"].to(dt))
        gate = (F.gelu(g, approximate="tanh") if cfg.activation == "geglu"
                else F.silu(g))
        h = gate * u
    else:
        h = _mm(x, params["wi"].to(dt))
        if mlp_bias:
            h = h + bcast(params["bi"].to(dt), h.dim())
        if cfg.activation == "relu":
            h = F.relu(h)
        else:  # "gelu" = tanh approximation (gelu_new); "gelu_exact" = erf
            h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    y = _mm(h, params["wo"].to(dt))
    if mlp_bias:
        y = y + bcast(params["bo"].to(dt), y.dim())
    return y


# ---- embeddings ---------------------------------------------------------


def init_embeddings(gen, cfg: TransformerConfig, dtype, device):
    params = {"tok": _normal(gen, (cfg.vocab_size, cfg.hidden_size), dtype, 0.02, device)}
    if cfg.position == "learned":
        params["pos"] = _normal(gen, (cfg.max_seq_len, cfg.hidden_size), dtype, 0.02, device)
    if cfg.type_vocab_size:
        params["type"] = _normal(gen, (cfg.type_vocab_size, cfg.hidden_size), dtype,
                                 0.02, device)
    if cfg.embedding_norm:
        params["emb_norm"] = init_norm(cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (cfg.hidden_size, cfg.vocab_size), dtype,
                                    cfg.hidden_size ** -0.5, device)
        if cfg.lm_head_bias:
            params["lm_head_bias"] = _zeros((cfg.vocab_size,), dtype, device)
    return params
