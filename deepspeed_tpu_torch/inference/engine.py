"""Inference engine (v1).

Mirrors ``deepspeed_tpu/inference/engine.py`` (InferenceEngine): the model
is normalised by ``module_inject.as_inference_model``, its parameters are
random (seed 0) or given, and ``generate`` runs one prefill through
``CausalLM.apply_decode`` over a contiguous (L, B, S_max, KVH, D) cache and
then one decode step per new token. The JAX decode loop is a compiled
``lax.scan``. On the card the port captures the decode step into a CUDA
graph once per key (B, S_max, greedy, EOS set or not) and replays it once
a token (``cuda_graphs.py``); the cache and the loop's state are static
buffers that the step updates in place, kept between calls of one shape.
Sampled steps run eagerly on the same buffers (the rule: temperature > 0).
On the CPU, or with ``cuda_graphs=False``, the decode loop is an eager
Python loop with no host read inside it. Single-token decode over a cache
of 8192 slots or more runs the fused decode kernel on the card
(``ops/attention.py`` ``decode_attention``).

The engine runs on one device: ``device=None`` means the current CUDA
device (raising without a GPU); ``device="cpu"`` runs the plain path.
``enable_cuda_graph`` and ``quant`` are parsed and not read, as in JAX
(graphs follow ``cuda_graphs``; weight-only quantization is the separate
``inference.quantization`` API).
"""

import types
from typing import Optional

import numpy as np
import torch

from ..accelerator import get_device
from ..utils.tree import tree_map
from .config import DeepSpeedInferenceConfig
from .cuda_graphs import StepGraphs, StepRows
from .sampling import sample_logits

NOT_PORTED_TP = ("tensor-parallel inference (tp_size > 1) is not ported yet: "
                 "ROADMAP.md section A, item 11")


def _dtype_name(dtype) -> str:
    """The config's dtype as a preset dtype name: "torch." prefixes and
    "half" are rewritten as JAX does; a torch.dtype is taken by name."""
    return str(dtype).replace("torch.", "").replace("half", "float16")


class InferenceEngine:
    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, device=None, cuda_graphs=None):
        """``params``: port tensors (for example a JAX tree converted by
        ``module_inject.from_jax.params_from_numpy``), moved to ``device``
        with their dtypes kept; without them the weights are drawn from a
        generator seeded 0 and stored in the inference dtype.
        ``cuda_graphs``: None replays the decode step from CUDA graphs on a
        CUDA device and runs the eager loop on the CPU; False runs the eager
        loop on the card too; True on the CPU runs the static-buffer step
        eagerly (nothing to capture)."""
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
        use = self.device.type == "cuda" if cuda_graphs is None else bool(cuda_graphs)
        self.graphs = StepGraphs(self.device) if use else None
        self._decode_set = None    # the static cache and loop state of one (B, S_max)

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
        s_max = s_prompt + max_new_tokens
        greedy = temperature == 0.0
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def sample(logits):
            return sample_logits(logits[:, -1].float(), gen, temperature=temperature,
                                 top_k=top_k, top_p=top_p, greedy=greedy)

        if self.graphs is None:
            cache = self.model.init_cache(b, s_max, device=self.device)
        else:
            st = self._decode_buffers(b, s_max)
            cache = st.cache
        cache_len = torch.zeros((b,), dtype=torch.int32, device=self.device)
        logits, cache = self.model.apply_decode(self.module_params, ids, cache, cache_len,
                                                last_only=True)
        tok = sample(logits)
        if self.graphs is None:
            cache_len = cache_len + s_prompt
            done = torch.zeros((b,), dtype=torch.bool, device=self.device)
            toks = []
            for _ in range(max_new_tokens - 1):
                nxt, done = self._decode_step(tok, cache, cache_len, done, eos_token_id,
                                              sample)
                toks.append(tok)
                tok, cache_len = nxt, cache_len + 1
            out_new = torch.stack(toks + [tok], dim=1)                 # (B, max_new)
        else:
            out_new = self._graph_decode(st, tok, s_prompt, max_new_tokens - 1, sample,
                                         greedy, eos_token_id)
        full = torch.cat([ids, out_new], dim=1)
        if return_dict:
            return {"sequences": full, "new_tokens": out_new}
        return full

    def _decode_step(self, tok, cache, cache_len, done, eos, sample):
        """One decode step: feed ``tok`` (B,) at slots ``cache_len``; returns
        (the next tokens, done). A row that emitted ``eos`` (an int or a
        0-dim tensor; None: no EOS) keeps emitting it."""
        logits, _ = self.model.apply_decode(self.module_params, tok[:, None], cache,
                                            cache_len, last_only=True)
        nxt = sample(logits)
        if eos is not None:
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
        return nxt, done

    def _decode_buffers(self, b, s_max):
        """The static cache and decode state of (B, S_max), zeroed. One set
        is kept: another shape replaces it, and its graphs go with it."""
        st = self._decode_set
        if st is not None and st.shape == (b, s_max):
            for t in st.cache.values():
                t.zero_()
            return st
        self._decode_set = None        # the old cache goes before the new one is made
        self.graphs.reset()
        zi = torch.zeros((b,), dtype=torch.int32, device=self.device)
        st = self._decode_set = types.SimpleNamespace(
            shape=(b, s_max), cache=self.model.init_cache(b, s_max, device=self.device),
            tok=zi, cache_len=zi.clone(),
            done=torch.zeros((b,), dtype=torch.bool, device=self.device),
            eos=torch.zeros((), dtype=torch.int32, device=self.device),
            rows=StepRows(b, (torch.int32,), self.device))
        return st

    def _graph_decode(self, st, tok, s_prompt, steps, sample, greedy, eos_token_id):
        """``steps`` decode steps on the static buffers ``st`` after the
        prefill's token ``tok``, one replay of key ("decode", B, S_max,
        greedy, EOS set) each. Returns the new tokens (B, steps + 1)."""
        st.tok.copy_(tok)
        st.cache_len.fill_(s_prompt)
        st.done.zero_()
        eos = None
        if eos_token_id is not None:
            st.eos.fill_(eos_token_id)
            eos = st.eos
        self.graphs.bind(self.module_params, st.cache["k"], st.cache["v"])
        key = ("decode",) + st.shape + (greedy, eos is not None)

        def one():
            nxt, done = self._decode_step(st.tok, st.cache, st.cache_len, st.done, eos, sample)
            st.rows.write(nxt)
            st.tok.copy_(nxt)
            st.cache_len.add_(1)
            st.done.copy_(done)

        (new,) = st.rows.loop(steps, lambda: self.graphs.run(key, one, capture=greedy))
        return torch.cat([tok[:, None], new.t()], dim=1)

    @property
    def config(self):
        return self._config
