"""Architecture checks for v2 serving.

Mirrors ``validate_tp_serving`` of
``deepspeed_tpu/inference/v2/model_implementations/archs.py``, with its
messages. The rest of that file (the per-arch checkpoint containers) is not
ported yet (ROADMAP.md section A, item 13).
"""

from ....models.config import TransformerConfig


def validate_tp_serving(cfg: TransformerConfig, tp: int, role: str = "target") -> None:
    """Fail loudly if this architecture cannot run tensor-parallel serving at
    degree ``tp``. Attention heads, kv heads (and their paged pools) and the
    MLP intermediate dim must divide by ``tp``: a tensor left whole on every
    rank would be counted ``tp`` times by the per-layer all-reduces. Vocab
    alone may fall back (embedding and LM head whole on every rank when
    ``vocab_size % tp != 0``), which costs memory, not correctness. Checked
    at engine construction and at draft attach (``role`` names the model)."""
    if tp <= 1:
        return
    probs = []
    if cfg.is_moe:
        probs.append("MoE layers (expert parallelism is a different axis; "
                     "serve MoE models single-chip or add expert sharding)")
    if cfg.num_heads % tp:
        probs.append(f"num_heads={cfg.num_heads} not divisible by tp={tp}")
    if cfg.kv_heads % tp:
        probs.append(f"kv_heads={cfg.kv_heads} not divisible by tp={tp} "
                     "(the paged KV pools shard head-wise)")
    if cfg.ffn_size % tp:
        probs.append(f"ffn_size={cfg.ffn_size} not divisible by tp={tp}")
    if cfg.qk_norm in ("full", "per_head"):
        probs.append(f"qk_norm={cfg.qk_norm!r} norm weights span the head "
                     "dim that TP shards (use 'head_dim'-shared QK norms, "
                     "or serve single-chip)")
    if probs:
        raise NotImplementedError(
            f"tensor-parallel serving (tp={tp}) unsupported for the {role} "
            "model: " + "; ".join(probs))
