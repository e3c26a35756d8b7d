"""Serving-side weight quantization: int8 per-channel storage for the big
matmuls, dequantized at use.

Mirrors ``deepspeed_tpu/inference/v2/model_implementations/quantize.py``:
each targeted weight leaf is replaced by ``{"q": int8, "s": f32}`` with one
absmax scale per OUTPUT channel (the contracted axes collapse to keepdims
size-1 dims), and ``models.layers.dq`` rebuilds the float operand at use.
The bytes are the JAX function's: rounding half to even, clipping to
+-127, scale 0 for an all-zero channel.

What gets quantized (and along which contraction):

====================  ==========================  =====================
leaf                  logical axes                contracted (reduced)
====================  ==========================  =====================
attn wq/wk/wv         (embed, heads|kvh, hd)      embed
attn wo               (heads, head_dim, embed)    heads, head_dim
mlp wi/wi_gate/wi_up  (embed, mlp)                embed
mlp wo                (mlp, embed)                mlp
embed lm_head         (embed, vocab)              embed
====================  ==========================  =====================

Everything else (embeddings, norms, biases, q/k norms, a tied lm_head,
which is the embedding, and MoE expert stacks, found by their ``router``
key) stays as it is. Contracted positions are found by NAME in the model's
``logical_axes()`` tree, so the stacked leading "layers" axis keeps one
scale per layer. A stacked leaf is quantized one layer at a time (the
reduction never spans the layer axis), so the f32 temporaries are one
layer's, not the whole stack's (7.5 GB for llama3-8b's ``wi_gate``).
Under tensor parallelism the full tree is quantized with its spec tree
(``parallel/sharding.py`` ``inference_tp_specs``: a leaf's split dim or
None), so every rank's shard carries the scales of the whole weight: the
int8 ``q`` keeps the weight's dim, the keepdims scale drops it when it is
a contracted dim (wo and the MLP output projection), as JAX's
``_scale_spec`` nulls it.
"""

from typing import Any, Optional, Tuple

import torch

# (parent key, leaf key) -> logical axis names reduced by the matmul
_CONTRACTED = {
    ("attn", "wq"): ("embed",),
    ("attn", "wk"): ("embed",),
    ("attn", "wv"): ("embed",),
    ("attn", "wo"): ("heads", "head_dim"),
    ("mlp", "wi"): ("embed",),
    ("mlp", "wi_gate"): ("embed",),
    ("mlp", "wi_up"): ("embed",),
    ("mlp", "wo"): ("mlp",),
    ("embed", "lm_head"): ("embed",),
}

def _quantize_slab(w, red_dims: Tuple[int, ...]):
    """(q int8, s f32) of one slab: absmax over ``red_dims`` (keepdims)
    divided by 127 and x / s rounded half to even, each division by a
    tensor on w's device (the card multiplies by the reciprocal of a
    Python number)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=red_dims, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)
    live = s > 0
    q = torch.where(live, torch.round(w32 / torch.where(live, s, torch.ones_like(s))),
                    torch.zeros_like(w32))
    return q.clamp(-127, 127).to(torch.int8), s


def _quantize_leaf(w, red_dims: Tuple[int, ...]):
    """Symmetric absmax int8 over ``red_dims`` (keepdims): one scale per
    output channel (JAX ``_quantize_leaf``). All-zero channels get scale 0
    and dequantize to 0. When axis 0 is not reduced (a stacked layer
    axis), slices along it are quantized one at a time into the result."""
    if w.dim() < 2 or 0 in red_dims:
        q, s = _quantize_slab(w, red_dims)
        return {"q": q, "s": s}
    sub = tuple(d - 1 for d in red_dims)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty([1 if d in red_dims else n for d, n in enumerate(w.shape)],
                    dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quantize_slab(w[i], sub)
    return {"q": q, "s": s}


def quantize_params(params, logical_axes, specs=None, weight_dtype: str = "int8", *,
                    inplace: bool = False) -> Tuple[Any, Optional[Any]]:
    """Quantize the serving param tree (JAX ``quantize_params``).

    ``logical_axes``: the model's ``logical_axes()`` tree (mirrors params;
    leaves are tuples of axis names). ``specs``: the tensor-parallel spec
    tree (each leaf's split dim or None), or None at tp = 1. Returns
    ``(qparams, qspecs)``, ``qspecs`` None iff ``specs`` was None; a
    quantized leaf's spec is ``{"q": dim, "s": dim, or None when dim is
    contracted}``. ``inplace=True`` replaces the leaves in ``params``
    itself, so each float leaf is dropped as soon as its int8 form replaces
    it (the engine quantizes the tree it owns this way)."""
    if weight_dtype != "int8":
        raise ValueError(
            f"weight_dtype must be 'int8', got {weight_dtype!r} "
            "(fp8 is a collective wire format, not a storage format — "
            "see tp_collective_payload)")
    def walk(p, ax, sp, parent):
        if "router" in p:   # MoE expert stack: no dequant hook, skip
            return p, sp
        out = p if inplace else {}
        out_s = None if sp is None else {}
        for k in list(p):
            v = p[k]
            sk = None if sp is None else sp[k]
            if isinstance(v, dict):
                out[k], sub = walk(v, ax[k], sk, k)
                if sp is not None:
                    out_s[k] = sub
                continue
            names = _CONTRACTED.get((parent, k))
            red = () if names is None else tuple(
                i for i, a in enumerate(ax[k]) if a in names)
            if sp is not None:
                out_s[k] = sk
            if not red or len(red) != len(names):
                out[k] = v          # not a target, or an unexpected layout
                continue
            out[k] = _quantize_leaf(v, red)
            if sp is not None:
                out_s[k] = {"q": sk, "s": None if sk in red else sk}
            del v
        return out, out_s

    return walk(params, logical_axes, specs, "")


def quantized_param_bytes(params) -> Tuple[int, int]:
    """(bytes of the int8 leaves, bytes of the whole tree) of the resident
    params (JAX ``quantized_param_bytes``)."""
    q_bytes = total = 0

    def walk(node):
        nonlocal q_bytes, total
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
                continue
            b = v.numel() * v.element_size()
            total += b
            if v.dtype == torch.int8:
                q_bytes += b

    walk(params)
    return q_bytes, total
