"""Model configurations and preset registry.

Mirrors ``deepspeed_tpu/models/config.py``: ``TransformerConfig`` has the
same fields and defaults, and ``PRESETS`` the same entries field for field
(the port keeps its own copy; it imports nothing of the JAX package).
``act_dtype``/``p_dtype`` return torch dtypes.
"""

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None → MHA
    head_dim: Optional[int] = None      # None → hidden_size // num_heads
    intermediate_size: Optional[int] = None  # None → 4x (gelu) / 8/3x rounded (swiglu)
    max_seq_len: int = 4096
    # "swiglu"/"geglu" are gated (silu / tanh-gelu gate); rest are plain MLPs
    activation: str = "swiglu"          # "swiglu" | "geglu" | "gelu" | "gelu_exact" | "relu"
    norm: str = "rmsnorm"               # "rmsnorm" | "layernorm"
    position: str = "rope"              # "rope" | "learned" | "alibi"
    position_offset: int = 0            # learned-position index offset (OPT: 2)
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0             # fraction of head_dim rotated (GPT-NeoX)
    rope_interleaved: bool = False      # GPT-NeoX/GPT-J (cos,sin per pair) layout
    parallel_block: bool = False        # h + attn(ln1 h) + mlp(ln2 h) (NeoX/Falcon)
    norm_eps: float = 1e-5
    embedding_norm: bool = False        # layernorm right after token embed (BLOOM/BERT)
    embed_scale: float = 1.0            # token-embedding multiplier (Gemma: sqrt(E))
    post_norm: bool = False             # norm AFTER residual add (BERT) vs pre-LN
    type_vocab_size: int = 0            # token-type (segment) embeddings (BERT)
    mlm_head: bool = False              # BERT MLM head: dense+gelu+LN+decoder bias
    tie_embeddings: bool = False
    lm_head_bias: bool = False          # biased untied LM head (GPT-J, Phi)
    use_bias: bool = False
    qkv_bias: bool = False              # bias on q/k/v only (Qwen2)
    mlp_bias: Optional[bool] = None     # None → use_bias (GPT-J: mlp-only biases)
    out_bias: Optional[bool] = None     # attention out-proj bias override (GPT-Neo)
    causal: bool = True
    # sliding-window attention: query attends keys in (q-window, q] (Mistral).
    # local_attention_every=N makes every Nth layer (1-indexed remainder 0...
    # i.e. layers with index % N == N-1) windowed and the rest global
    # (GPT-Neo alternates global/local); None with sliding_window set means
    # ALL layers are windowed.
    sliding_window: Optional[int] = None
    local_attention_every: Optional[int] = None
    # explicit per-layer window sizes (len == num_layers, 0 = global) for
    # patterns local_attention_every can't express (Gemma-2 windows the
    # EVEN-indexed layers). Takes precedence over local_attention_every.
    window_pattern: Optional[tuple] = None
    # q/k normalization before rope (HF refs: MPT attn_config.qk_ln,
    # StableLM qk_layernorm, Phi qk_layernorm):
    #   "full":     one norm over the flattened (H*D) q / (KVH*D) k vectors
    #   "head_dim": one (D,) norm shared by all heads
    #   "per_head": separate (H, D) weights per head
    # The norm family follows cfg.norm (all current variants: layernorm).
    qk_norm: Optional[str] = None
    qk_norm_bias: bool = True           # StableLM's per-head LNs are bias-free
    # Gemma-2 block structure: extra norms on each sublayer OUTPUT before
    # the residual add (norm1=input, norm3=post-attn, norm2=pre-ffw,
    # norm4=post-ffw)
    sandwich_norm: bool = False
    attn_softcap: float = 0.0           # tanh softcap on attention logits (Gemma-2)
    logit_softcap: float = 0.0          # tanh softcap on final LM logits (Gemma-2)
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim) (Gemma-2
                                        # query_pre_attn_scalar ** -0.5)
    # per-layer structure tags for heterogeneous stacks ("dense" | "moe";
    # len == num_layers). None = homogeneous (every layer is MoE iff
    # num_experts > 0). Qwen2-MoE's mlp_only_layers / decoder_sparse_step
    # interleave dense-MLP layers into a routed-expert stack.
    layer_types: Optional[tuple] = None
    # MoE (Mixtral-style; 0 experts → dense)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_norm_topk: bool = True          # renormalize top-k gates (Mixtral yes, Qwen2-MoE no)
    moe_shared_expert_size: int = 0     # always-on shared expert width (Qwen2-MoE)
    # "einsum": capacity-bounded one-hot dispatch (GShard/EP all-to-all);
    # "grouped": dropless sort-by-expert + ragged_dot (megablox pattern,
    # expert axis unsharded only)
    moe_impl: str = "einsum"
    # routed-expert FFN width when it differs from the dense-MLP width
    # (Qwen2-MoE: moe_intermediate_size vs intermediate_size); None → ffn_size
    moe_intermediate_size: Optional[int] = None
    # numerics
    dtype: str = "bfloat16"             # activation dtype
    param_dtype: str = "float32"        # stored parameter dtype
    # attention implementation: "auto" | "reference" | "flash" | "ring"
    attn_impl: str = "auto"
    # remat policy for scan-over-layers ("none"|"full"|"dots")
    remat: str = "none"
    # partition saved activations: checkpoint-boundary residuals stored with
    # their SEQUENCE dim sharded over the tensor axis, gathered on use
    # (reference partition_activations, checkpointing.py:486)
    partition_activations: bool = False
    # QAT activation fake-quant bits (compression QuantAct analog): each
    # layer's attention/MLP inputs round-trip an int grid with an STE
    # backward; 0 disables
    act_quant_bits: int = 0
    # vocab-chunked fused cross-entropy (ops/cross_entropy.py): number of
    # lm-head chunks; 0 disables. Engaged when the (B, S, V) logits would
    # exceed loss_chunk_threshold_bytes — the fused path trades one extra
    # lm-head matmul for never materializing the logits.
    loss_chunks: int = 8
    loss_chunk_threshold_bytes: int = 1 << 30

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.activation in ("swiglu", "geglu"):
            return ((int(self.hidden_size * 8 / 3) + 255) // 256) * 256
        return 4 * self.hidden_size

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def moe_ffn_size(self) -> int:
        return self.moe_intermediate_size or self.ffn_size

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_type(self, i: int) -> str:
        if self.layer_types is not None:
            return self.layer_types[i]
        return "moe" if self.is_moe else "dense"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---- preset registry (sizes from the public model cards) ----

PRESETS = {
    # GPT-2 family (learned positions, gelu, layernorm, tied embeddings, biases)
    "gpt2-small": TransformerConfig(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
                                    max_seq_len=1024, activation="gelu", norm="layernorm", position="learned",
                                    tie_embeddings=True, use_bias=True),
    "gpt2-medium": TransformerConfig(vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16,
                                     max_seq_len=1024, activation="gelu", norm="layernorm", position="learned",
                                     tie_embeddings=True, use_bias=True),
    "gpt2-xl": TransformerConfig(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25,
                                 max_seq_len=1024, activation="gelu", norm="layernorm", position="learned",
                                 tie_embeddings=True, use_bias=True),
    # Llama-2 family
    "llama2-7b": TransformerConfig(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                                   intermediate_size=11008, max_seq_len=4096),
    "llama2-13b": TransformerConfig(vocab_size=32000, hidden_size=5120, num_layers=40, num_heads=40,
                                    intermediate_size=13824, max_seq_len=4096),
    "llama2-70b": TransformerConfig(vocab_size=32000, hidden_size=8192, num_layers=80, num_heads=64,
                                    num_kv_heads=8, intermediate_size=28672, max_seq_len=4096),
    "llama3-8b": TransformerConfig(vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
                                   num_kv_heads=8, intermediate_size=14336, max_seq_len=8192,
                                   rope_theta=500000.0),
    # Mixtral MoE
    "mixtral-8x7b": TransformerConfig(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                                      num_kv_heads=8, intermediate_size=14336, max_seq_len=32768,
                                      rope_theta=1e6, num_experts=8, num_experts_per_tok=2),
    # BLOOM family (ALiBi positions, embedding layernorm, gelu, biases)
    "bloom-560m": TransformerConfig(vocab_size=250880, hidden_size=1024, num_layers=24, num_heads=16,
                                    max_seq_len=2048, activation="gelu", norm="layernorm",
                                    position="alibi", embedding_norm=True, tie_embeddings=True,
                                    use_bias=True),
    "bloom-7b1": TransformerConfig(vocab_size=250880, hidden_size=4096, num_layers=30, num_heads=32,
                                   max_seq_len=2048, activation="gelu", norm="layernorm",
                                   position="alibi", embedding_norm=True, tie_embeddings=True,
                                   use_bias=True),
    # Falcon-7B (multi-query attention, parallel block, one shared norm)
    "falcon-7b": TransformerConfig(vocab_size=65024, hidden_size=4544, num_layers=32, num_heads=71,
                                   num_kv_heads=1, intermediate_size=18176, max_seq_len=2048,
                                   activation="gelu_exact", norm="layernorm", parallel_block=True,
                                   tie_embeddings=True),
    # GPT-J-6B (interleaved partial rotary, parallel block, MLP-only biases)
    "gptj-6b": TransformerConfig(vocab_size=50400, hidden_size=4096, num_layers=28, num_heads=16,
                                 intermediate_size=16384, max_seq_len=2048, activation="gelu",
                                 norm="layernorm", rotary_pct=64 / 256, rope_interleaved=True,
                                 parallel_block=True, mlp_bias=True),
    # GPT-NeoX-20B / Pythia family (partial rotary, parallel residual)
    "gpt-neox-20b": TransformerConfig(vocab_size=50432, hidden_size=6144, num_layers=44, num_heads=64,
                                      intermediate_size=24576, max_seq_len=2048,
                                      activation="gelu_exact", norm="layernorm", rotary_pct=0.25,
                                      parallel_block=True, use_bias=True),
    # MPT-7B (ALiBi, bias-free, exact gelu)
    "mpt-7b": TransformerConfig(vocab_size=50368, hidden_size=4096, num_layers=32, num_heads=32,
                                intermediate_size=16384, max_seq_len=2048, activation="gelu_exact",
                                norm="layernorm", position="alibi", tie_embeddings=True),
    # Gemma-7B (GeGLU, sqrt(E)-scaled embeddings, wide head_dim)
    "gemma-7b": TransformerConfig(vocab_size=256000, hidden_size=3072, num_layers=28, num_heads=16,
                                  head_dim=256, intermediate_size=24576, max_seq_len=8192,
                                  activation="geglu", embed_scale=3072.0 ** 0.5,
                                  tie_embeddings=True, norm_eps=1e-6),
    # Qwen2-7B (GQA + qkv biases)
    "qwen2-7b": TransformerConfig(vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
                                  num_kv_heads=4, intermediate_size=18944, max_seq_len=32768,
                                  rope_theta=1e6, qkv_bias=True, norm_eps=1e-6),
    # Phi-2 (parallel block sharing one layernorm, partial rotary, biases)
    "phi-2": TransformerConfig(vocab_size=51200, hidden_size=2560, num_layers=32, num_heads=32,
                               intermediate_size=10240, max_seq_len=2048, activation="gelu",
                               norm="layernorm", position="rope", rotary_pct=0.4,
                               parallel_block=True, use_bias=True),
    # Mistral-7B (GQA + sliding-window attention)
    "mistral-7b": TransformerConfig(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                                    num_kv_heads=8, intermediate_size=14336, max_seq_len=32768,
                                    sliding_window=4096),
    # BERT family (post-norm encoder, MLM head; acceptance config 2 trains
    # bert-large under ZeRO-1/2)
    "bert-base": TransformerConfig(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                                   intermediate_size=3072, max_seq_len=512, type_vocab_size=2,
                                   activation="gelu_exact", norm="layernorm", position="learned",
                                   post_norm=True, causal=False, embedding_norm=True,
                                   mlm_head=True, use_bias=True, tie_embeddings=True,
                                   norm_eps=1e-12),
    "bert-large": TransformerConfig(vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
                                    intermediate_size=4096, max_seq_len=512, type_vocab_size=2,
                                    activation="gelu_exact", norm="layernorm", position="learned",
                                    post_norm=True, causal=False, embedding_norm=True,
                                    mlm_head=True, use_bias=True, tie_embeddings=True,
                                    norm_eps=1e-12),
    # tiny variants for tests / CI
    "tiny": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                              intermediate_size=128, max_seq_len=128, param_dtype="float32",
                              dtype="float32"),
    "tiny-gpt2": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                                   intermediate_size=256, max_seq_len=128, activation="gelu",
                                   norm="layernorm", position="learned", tie_embeddings=True,
                                   use_bias=True, dtype="float32"),
    "tiny-moe": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                                  intermediate_size=128, max_seq_len=128, num_experts=4,
                                  num_experts_per_tok=2, dtype="float32"),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown model preset {name!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
