"""Inference engine (v1).

Mirrors ``deepspeed_tpu/inference/engine.py`` (InferenceEngine): the model
is normalised by ``module_inject.as_inference_model``, its parameters are
random (seed 0) or given, and ``generate`` runs one prefill through
``CausalLM.apply_decode`` over a contiguous (L, B, S_max, KVH, D) cache and
then one decode step per new token. The JAX decode loop is a compiled
``lax.scan``; here it is an eager Python loop with no host read inside it.
Single-token decode over a cache of 8192 slots or more runs the fused decode
kernel on the card (``ops/attention.py`` ``decode_attention``).

The engine runs on one device: ``device=None`` means the current CUDA
device (raising without a GPU); ``device="cpu"`` runs the plain path.
``enable_cuda_graph`` and ``quant`` are parsed and not read, as in JAX
(weight-only quantization is the separate ``inference.quantization`` API).
"""

from typing import Optional

import numpy as np
import torch

from ..accelerator import get_device
from ..utils.tree import tree_map
from .config import DeepSpeedInferenceConfig
from .sampling import sample_logits

NOT_PORTED_TP = ("tensor-parallel inference (tp_size > 1) is not ported yet: "
                 "ROADMAP.md section A, item 11")


def _dtype_name(dtype) -> str:
    """The config's dtype as a preset dtype name: "torch." prefixes and
    "half" are rewritten as JAX does; a torch.dtype is taken by name."""
    return str(dtype).replace("torch.", "").replace("half", "float16")


class InferenceEngine:
    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, device=None):
        """``params``: port tensors (for example a JAX tree converted by
        ``module_inject.from_jax.params_from_numpy``), moved to ``device``
        with their dtypes kept; without them the weights are drawn from a
        generator seeded 0 and stored in the inference dtype."""
        from ..module_inject import as_inference_model
        self._config = config or DeepSpeedInferenceConfig()
        if self._config.tp_size_effective > 1:
            raise NotImplementedError(NOT_PORTED_TP)
        self.device = get_device(device)
        self.model, converted = as_inference_model(model, self._config)
        if params is not None:
            converted = params

        dt = _dtype_name(self._config.dtype)
        if self.model.cfg.dtype != dt and dt in ("float16", "bfloat16", "float32"):
            self.model.cfg = self.model.cfg.replace(dtype=dt)

        if converted is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self.module_params = self.model.init(gen, device=self.device,
                                                 dtype=self.model.cfg.act_dtype)
        else:
            self.module_params = tree_map(lambda t: t.to(self.device), converted)

    # -- reference-parity surface --

    def _ids(self, input_ids):
        return torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                               else input_ids, dtype=torch.int32).to(self.device)

    @torch.no_grad()
    def forward(self, input_ids, *args, **kwargs):
        """input_ids (B, S) -> logits (B, S, V) through ``CausalLM.apply``."""
        return self.model.apply(self.module_params, self._ids(input_ids))

    __call__ = forward

    def module_state_dict(self):
        """The parameter tree as CPU tensors."""
        return tree_map(lambda t: t.cpu(), self.module_params)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id: Optional[int] = None,
                 seed: int = 0, return_dict: bool = False, **kwargs):
        """Batch generation: one prefill, then ``max_new_tokens - 1`` decode
        steps over a cache of ``S_prompt + max_new_tokens`` slots.

        input_ids: (B, S_prompt), prompts of one length (no padding in v1;
        the ragged v2 engine serves mixed lengths). Returns (B, S_prompt +
        max_new_tokens) int32 on the engine's device, or a dict with
        ``sequences`` and ``new_tokens``. With ``eos_token_id`` a row that
        emits it keeps emitting it; the first new token is not checked, as
        in JAX. Sampling (temperature > 0) draws from a generator seeded
        ``seed``: its tokens cannot match JAX's."""
        cfg = self.model.cfg
        if not cfg.causal or cfg.mlm_head:
            raise NotImplementedError(
                "generate() is autoregressive; BERT-style encoders are "
                "served with forward() (fill-mask / embedding workloads)")
        ids = self._ids(input_ids)
        b, s_prompt = ids.shape
        cache = self.model.init_cache(b, s_prompt + max_new_tokens, device=self.device)
        greedy = temperature == 0.0
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def sample(logits):
            return sample_logits(logits[:, -1].float(), gen, temperature=temperature,
                                 top_k=top_k, top_p=top_p, greedy=greedy)

        cache_len = torch.zeros((b,), dtype=torch.int32, device=self.device)
        logits, cache = self.model.apply_decode(self.module_params, ids, cache, cache_len,
                                                last_only=True)
        cache_len = cache_len + s_prompt
        tok = sample(logits)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        toks = []
        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.apply_decode(self.module_params, tok[:, None], cache,
                                                    cache_len, last_only=True)
            nxt = sample(logits)
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done = done | (nxt == eos_token_id)
            toks.append(tok)
            tok, cache_len = nxt, cache_len + 1
        out_new = torch.stack(toks + [tok], dim=1)                     # (B, max_new)
        full = torch.cat([ids, out_new], dim=1)
        if return_dict:
            return {"sequences": full, "new_tokens": out_new}
        return full

    @property
    def config(self):
        return self._config
