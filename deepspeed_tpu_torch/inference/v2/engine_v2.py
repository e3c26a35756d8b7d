"""Continuous-batching inference engine (FastGen analog).

Mirrors ``deepspeed_tpu/inference/v2/engine_v2.py`` for the single-device
paths: the step API (``put``, ``step``, ``query``, ``flush``,
``can_schedule``), ``generate`` (SplitFuse prefill through ``step``, then
one ``decode_loop``), ``generate_compiled`` (one ``mixed_loop``, or
``mixed_loop_spec`` with a draft) and the FIFO ``serve()``, over paged KV
(``kv_cache.py``), sequence tracking (``ragged_manager.py``) and the
runner's programs (``model_runner.py``). Quantized serving: int8 weight
leaves (``weight_dtype="int8"``, ``model_implementations/quantize.py``)
and int8 KV pages (``kv_dtype="int8"``). Speculative decoding:
``attach_draft`` gives a draft model its own pools over the target's block
tables, and ``serve()`` / ``generate_compiled()`` run draft/verify steps.
On the card every program runs from CUDA graphs, one captured step a shape
key, unless the engine is built with ``cuda_graphs=False``; sampled steps
run eagerly (``model_runner.py``). ``RaggedInferenceEngineConfig`` keeps
every field and default of the JAX config; the fields of paths not ported
yet (tensor parallelism, the KV hierarchy, disaggregated roles, the repair
policy) raise ``NotImplementedError`` when set, as do ``serve(scheduler=,
faults=, resume_from=, yield_boundaries=True)``, dict arrivals,
``serve_stats`` and ``cancel_request`` (ROADMAP.md lists them). The
telemetry, trace, retry and watchdog fields are accepted and not acted
on: ``ServingTelemetry`` and the fault machinery are not ported yet.
"""

import collections
import dataclasses
import logging
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import get_device
from ...models.transformer import CausalLM, build_model
from ...module_inject import as_inference_model
from ..sampling import sample_logits
from .kv_cache import BlockedKVCache
from .model_implementations.quantize import quantize_params
from .model_runner import PagedModelRunner
from .ragged_manager import DeviceSlotTable, DSStateManager
from .telemetry import STAT_NAMES

logger = logging.getLogger(__name__)

_ROADMAP = "not ported to deepspeed_tpu_torch yet (ROADMAP.md, section A)"
_TELEMETRY = ("reads ServingTelemetry and the request ledger, which are not ported "
              "to deepspeed_tpu_torch yet (ROADMAP.md section A, item 6)")


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    """Same fields and defaults as the JAX ``RaggedInferenceEngineConfig``
    (see its comments for each field's meaning)."""
    max_ragged_batch_size: int = 64
    max_ragged_sequence_count: int = 2048
    kv_block_size: int = 128
    num_kv_blocks: Optional[int] = None
    expected_context: Optional[int] = None
    expected_concurrency: Optional[int] = None
    prefill_chunk_size: int = 128
    max_tokens_per_step: int = 512
    max_tracked_sequences: int = 2048
    frame_steps: int = 8
    adaptive_frame_steps: bool = False
    frame_steps_ewma_alpha: float = 0.25
    speculate_gamma: int = 2
    telemetry: bool = True
    telemetry_trace: bool = False
    max_frame_retries: int = 2
    frame_retry_backoff_s: float = 0.02
    watchdog_frame_ms: Optional[float] = None
    fault_log_max: int = 256
    nonfinite_policy: str = "quarantine"
    nonfinite_repair_limit: int = 2
    tp: int = 1
    tp_quantized_collectives: bool = False
    tp_collective_payload: str = "int8"
    tp_overlap_collectives: bool = False
    tp_debug_replica_check: bool = False
    prefix_cache: bool = False
    prefix_cache_max_blocks: Optional[int] = None
    kv_swap_dir: Optional[str] = None
    kv_swap_preempt: bool = True
    kv_swap_async: bool = True
    role: str = "unified"
    tier_prefix_share: bool = True
    handoff_pipeline: bool = True
    dtype: str = "bfloat16"
    weight_dtype: Optional[str] = None
    kv_dtype: Optional[str] = None


def _check_config(c: RaggedInferenceEngineConfig) -> None:
    """JAX's checks of the quantized-serving fields, with its messages,
    then the fields of paths not ported yet."""
    if c.weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype={c.weight_dtype!r}: expected None or 'int8'")
    if c.kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype={c.kv_dtype!r}: expected None or 'int8'")
    if c.tp_collective_payload not in ("int8", "fp8"):
        raise ValueError(f"tp_collective_payload={c.tp_collective_payload!r}: "
                         "expected 'int8' or 'fp8'")
    unported = {
        "tp": c.tp > 1, "prefix_cache": c.prefix_cache,
        "kv_swap_dir": bool(c.kv_swap_dir),
        "role": c.role != "unified",
        "nonfinite_policy": c.nonfinite_policy != "quarantine",
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"RaggedInferenceEngineConfig.{name}={getattr(c, name)!r}: {_ROADMAP}")


class InferenceEngineV2:
    def __init__(self, model, config: Optional[RaggedInferenceEngineConfig] = None,
                 params=None, max_seq_len: Optional[int] = None, device=None,
                 cuda_graphs=None, draft_model=None, draft_params=None):
        """``model``: a ``CausalLM`` (or a preset name / config for
        ``build_model``); ``params``: a params dict (random weights from
        seed 0 when omitted, stored in the serving dtype), float or with
        int8 leaves from ``quantize_params``; ``device``: where the engine
        runs — the current CUDA device by default, which raises when there
        is no GPU; ``cuda_graphs``: the runner's (None: graphs on the card,
        the functional loops on the CPU; False: eager on the card too);
        ``draft_model`` / ``draft_params``: attach a draft at once
        (``attach_draft``)."""
        self._config = config or RaggedInferenceEngineConfig()
        c = self._config
        _check_config(c)
        self.device = get_device(device)
        self.model = model if isinstance(model, CausalLM) else build_model(model)
        if self.model.cfg.dtype != c.dtype:
            self.model.cfg = self.model.cfg.replace(dtype=c.dtype)
        cfg = self.model.cfg
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self.params = self.model.init(gen, device=self.device, dtype=cfg.act_dtype)
        else:
            self.params = _to_device(params, self.device)
        if c.weight_dtype and not _is_quantized(self.params):
            # the engine owns this tree: each float leaf goes as soon as its
            # int8 form replaces it
            self.params, _ = quantize_params(self.params, self.model.logical_axes(),
                                             weight_dtype=c.weight_dtype, inplace=True)

        bs = c.kv_block_size
        max_blocks_per_seq = (self.max_seq_len + bs - 1) // bs
        exp_ctx = min(c.expected_context or self.max_seq_len, self.max_seq_len)
        per_seq = (exp_ctx + 1 + bs - 1) // bs      # +1 lookahead slot
        conc = min(c.expected_concurrency or c.max_ragged_batch_size,
                   c.max_ragged_batch_size)
        num_blocks = c.num_kv_blocks or (conc * per_seq + 1)
        self.kv = BlockedKVCache(cfg.num_layers, cfg.kv_heads, cfg.dims_per_head,
                                 num_blocks=num_blocks, block_size=bs,
                                 dtype=cfg.act_dtype, device=self.device,
                                 kv_dtype=c.kv_dtype)
        # block 0 is the trash block for padded writes: never allocate it
        self.kv.reserve_trash_block()
        self.state = DSStateManager(self.kv, c.max_tracked_sequences)
        self.runner = PagedModelRunner(self.model, bs, max_blocks_per_seq, self.device,
                                       cuda_graphs=cuda_graphs)
        self.max_blocks_per_seq = max_blocks_per_seq
        # host stream the per-serve frame generators are seeded from
        self._rng = torch.Generator().manual_seed(0)
        # the sampled tokens of step(), generate() and generate_compiled()
        self._sample_rng = torch.Generator(device=self.device).manual_seed(0)
        # abnormal retirements (non-finite rows), newest last
        self.fault_log: collections.deque = collections.deque(maxlen=c.fault_log_max)
        # the in-frame counters of the last serve() run, by STAT_NAMES
        self.serve_counters: Dict[str, int] = {}
        self.draft_model = self.draft_params = self.draft_runner = self.draft_kv = None
        if draft_model is not None:
            self.attach_draft(draft_model, draft_params)
        logger.info(f"InferenceEngineV2: blocks={num_blocks}x{bs} "
                    f"chunk={c.prefill_chunk_size} device={self.device}")

    def attach_draft(self, draft_model, draft_params=None) -> None:
        """Attach a small draft model for speculative decoding (JAX
        ``attach_draft`` without its tp branch). ``draft_model``: a port
        ``CausalLM``, a preset name or a config. The draft gets its OWN
        paged pools with the target's block count, block size and
        ``kv_dtype``, addressed by the SAME per-slot block tables, so
        admission reserves blocks once for both. ``draft_params=None`` draws
        fresh weights from seed 1; pass the target's params for a self-draft
        (the 100 %-acceptance bound). The draft is quantized under the
        target's ``weight_dtype``. A re-attach drops the speculative graphs
        captured over the previous draft."""
        c = self._config
        self.draft_model, converted = as_inference_model(draft_model, None)
        if draft_params is not None:
            converted = draft_params
        if self.draft_model.cfg.dtype != c.dtype:
            self.draft_model.cfg = self.draft_model.cfg.replace(dtype=c.dtype)
        dcfg = self.draft_model.cfg
        if dcfg.vocab_size != self.model.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size={dcfg.vocab_size} must match the target's "
                f"{self.model.cfg.vocab_size} — verification compares token "
                "ids and distributions position-wise")
        if c.prefill_chunk_size < 2:
            raise ValueError(
                "speculative serving needs prefill_chunk_size >= 2: width-1 "
                "frames are reinterpreted as draft/verify steps")
        if dcfg.max_seq_len < self.max_seq_len:
            if dcfg.position == "learned":
                raise ValueError(
                    f"draft max_seq_len={dcfg.max_seq_len} < engine serving "
                    f"length {self.max_seq_len}: the draft's learned position "
                    "table cannot cover the contexts it must draft for")
            logger.warning(
                f"draft max_seq_len={dcfg.max_seq_len} < engine serving "
                f"length {self.max_seq_len}; proposals beyond the draft's "
                "trained context will likely be rejected (throughput, not "
                "correctness, degrades)")
        if converted is None:
            gen = torch.Generator(device=self.device).manual_seed(1)
            self.draft_params = self.draft_model.init(gen, device=self.device,
                                                      dtype=dcfg.act_dtype)
        else:
            self.draft_params = _to_device(converted, self.device)
        if c.weight_dtype and not _is_quantized(self.draft_params):
            # a self-draft shares the target's float leaves: quantize a
            # copy of the tree, never the caller's
            self.draft_params, _ = quantize_params(
                self.draft_params, self.draft_model.logical_axes(),
                weight_dtype=c.weight_dtype, inplace=converted is None)
        self.draft_kv = BlockedKVCache(dcfg.num_layers, dcfg.kv_heads, dcfg.dims_per_head,
                                       num_blocks=self.kv.num_blocks,
                                       block_size=c.kv_block_size, dtype=dcfg.act_dtype,
                                       device=self.device, kv_dtype=c.kv_dtype)
        # the draft's forward runs inside the target runner's programs; its
        # own runner captures nothing
        self.draft_runner = PagedModelRunner(self.draft_model, c.kv_block_size,
                                             self.max_blocks_per_seq, self.device,
                                             cuda_graphs=False)
        if self.runner.graphs is not None:
            self.runner.graphs.evict("spec_frame", "spec_mixed")
        logger.info(f"InferenceEngineV2: draft attached (layers={dcfg.num_layers} "
                    f"gamma={c.speculate_gamma})")

    def _speculation(self, speculate, gamma, hint="") -> Tuple[bool, int]:
        """(speculate, gamma) of a serve() or generate_compiled() call, with
        JAX's checks and messages: speculation is on by default with a draft
        attached."""
        if speculate is None:
            speculate = self.draft_model is not None
        if speculate and self.draft_model is None:
            raise ValueError("speculate=True but no draft model is attached" + hint)
        gamma = int(gamma if gamma is not None else self._config.speculate_gamma)
        if speculate and gamma < 1:
            raise ValueError(f"speculate needs gamma >= 1, got {gamma}")
        return bool(speculate), gamma

    # ------------------------------------------------------------------
    # admission control, ingest and the Dynamic SplitFuse step
    # ------------------------------------------------------------------

    @property
    def serve_stats(self) -> Dict:
        """The serving telemetry view of the JAX engine (not ported)."""
        raise NotImplementedError(f"serve_stats {_TELEMETRY}")

    def cancel_request(self, uid: int) -> bool:
        """Cancel an in-flight request through the ledger (not ported)."""
        raise NotImplementedError(f"cancel_request {_TELEMETRY}")

    def can_schedule(self, uids: List[int], lengths: List[int]) -> bool:
        """Would these new sequences fit (blocks + tracking)?"""
        blocks_needed = sum(self.kv.blocks_for(n + 1) for n in lengths)
        if blocks_needed > self.kv.free_blocks:
            return False
        return len(self.state.seqs) + len(uids) <= self._config.max_tracked_sequences

    def query(self, uid: int) -> Tuple[int, List[int]]:
        """(#tokens still pending prefill, generated tokens so far)."""
        seq = self.state.seqs.get(uid)
        if seq is None:
            return (0, [])
        return (len(seq.pending), list(seq.generated))

    def put(self, batch_uids: List[int], batch_tokens: List[np.ndarray]) -> None:
        """Register prompt tokens for the given sequence uids."""
        for uid, toks in zip(batch_uids, batch_tokens):
            toks = np.asarray(toks).reshape(-1).tolist()
            seq = self.state.get_or_create_sequence(uid)
            if not self.state.ensure_capacity(seq, seq.seen_tokens + len(toks) + 1):
                raise RuntimeError(f"uid={uid}: KV pool exhausted "
                                   f"({self.kv.free_blocks} blocks free)")
            seq.pending.extend(toks)
            seq.done = False

    def flush(self, uids: List[int]) -> None:
        for uid in uids:
            self.state.flush_sequence(uid)

    def _schedule(self) -> Tuple[List, List]:
        """Pick (prefill_seqs, decode_seqs) under the token budget: decode
        tokens first (one each), the rest of the budget in prefill chunks."""
        c = self._config
        budget = c.max_tokens_per_step
        decode = [s for s in self.state.seqs.values()
                  if not s.in_prefill and not s.done and s.seen_tokens > 0]
        decode = decode[:min(len(decode), c.max_ragged_batch_size, budget)]
        budget -= len(decode)
        prefill = []
        for s in self.state.seqs.values():
            if s.in_prefill and budget >= min(len(s.pending), c.prefill_chunk_size):
                prefill.append(s)
                budget -= min(len(s.pending), c.prefill_chunk_size)
                if len(prefill) + len(decode) >= c.max_ragged_batch_size or budget <= 0:
                    break
        return prefill, decode

    def _tensor(self, x):
        return torch.from_numpy(x).to(self.device)

    def _run_batch(self, seqs, chunk: int, take: Dict[int, int],
                   greedy=True, temperature=0.0):
        """Run one padded (B, chunk) forward over paged KV for ``seqs``.
        The batch is padded to the next power of two, so the runner's keys
        stay O(log) in the live batch size; pad rows take positions -1 (the
        trash block takes their writes, the mask their reads) and their
        tokens are never read."""
        b = len(seqs)
        bp = BlockedKVCache.bucket_width(b, max(b, self._config.max_ragged_batch_size))
        ids = np.zeros((bp, chunk), np.int32)
        positions = np.full((bp, chunk), -1, np.int32)
        valid = np.zeros((bp,), np.int32)
        tables = np.zeros((bp, self.max_blocks_per_seq), np.int32)
        for i, s in enumerate(seqs):
            n = take[s.uid]
            toks = s.pending[:n] if s.in_prefill else s.generated[-1:]
            ids[i, :n] = toks
            positions[i, :n] = s.seen_tokens + np.arange(n)
            valid[i] = n
            tables[i] = self.state.block_table(s, self.max_blocks_per_seq)
        logits, self.kv.k, self.kv.v = self.runner.run(
            self.params, *(self._tensor(x) for x in (ids, positions, tables, valid)),
            self.kv.k, self.kv.v)
        toks = sample_logits(logits, self._sample_rng, greedy=greedy,
                             temperature=temperature).cpu().numpy()
        out = {}
        for i, s in enumerate(seqs):
            n = take[s.uid]
            if s.in_prefill:
                s.pending = s.pending[n:]
                s.seen_tokens += n
                if not s.pending:          # prompt fully consumed: first token
                    s.generated.append(int(toks[i]))
                    out[s.uid] = int(toks[i])
            else:
                s.seen_tokens += n
                s.generated.append(int(toks[i]))
                out[s.uid] = int(toks[i])
        return out

    def step(self, temperature: float = 0.0) -> Dict[int, int]:
        """One SplitFuse iteration: {uid: newly generated token}."""
        prefill, decode = self._schedule()
        produced: Dict[int, int] = {}
        c = self._config
        if prefill:
            take = {s.uid: min(len(s.pending), c.prefill_chunk_size) for s in prefill}
            for s in prefill:   # capacity for the chunk + next token
                self.state.ensure_capacity(s, s.seen_tokens + take[s.uid] + 1)
            produced.update(self._run_batch(prefill, c.prefill_chunk_size, take,
                                            greedy=temperature == 0.0,
                                            temperature=temperature))
        if decode:
            ok = [s for s in decode if self.state.ensure_capacity(s, s.seen_tokens + 2)]
            if ok:
                produced.update(self._run_batch(ok, 1, {s.uid: 1 for s in ok},
                                                greedy=temperature == 0.0,
                                                temperature=temperature))
        return produced

    # ------------------------------------------------------------------
    # batch generation
    # ------------------------------------------------------------------

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 32,
                 temperature: float = 0.0, eos_token_id: Optional[int] = None):
        """Batch generation: SplitFuse prefill through ``step()``, then ONE
        ``decode_loop`` (one graph replayed a step on the card), with no
        host round-trip between tokens. EOS cuts each output on the host
        after the loop; the loop runs the whole budget."""
        uids = list(range(len(prompts)))
        self.put(uids, prompts)
        while any(self.state.seqs[u].in_prefill for u in uids):
            self.step(temperature=temperature)
        remaining = max_new_tokens - 1
        if remaining > 0:
            seqs = [self.state.seqs[u] for u in uids]
            if not all(self.state.ensure_capacity(s, s.seen_tokens + remaining + 1)
                       for s in seqs):
                # the pool cannot cover the loop's budget up front: release
                # what the all() above reserved beyond each row's next write
                # and degrade to step(), which allocates per step
                for s in seqs:
                    keep = self.kv.blocks_for(s.seen_tokens + 1)
                    if len(s.blocks) > keep:
                        self.kv.allocator.free(s.blocks[keep:])
                        del s.blocks[keep:]
                logger.warning(
                    "KV pool cannot cover the decode loop's budget "
                    f"({self.kv.free_blocks} blocks free); degrading to the "
                    "chunked step() loop for the remainder")
                self._stepwise_decode(seqs, max_new_tokens, temperature)
                return self._finalize(uids, max_new_tokens, eos_token_id)
            last_ids = np.asarray([s.generated[-1] for s in seqs], np.int32)
            lens = np.asarray([s.seen_tokens for s in seqs], np.int32)
            toks, self.kv.k, self.kv.v = self.runner.decode_loop(
                self.params, self._tensor(last_ids), self._tensor(lens),
                self._tensor(self._block_tables(seqs)), self.kv.k, self.kv.v,
                self._sample_rng, temperature, steps=remaining,
                greedy=temperature == 0.0)
            toks = toks.cpu().numpy()                      # (steps, B)
            for i, s in enumerate(seqs):
                s.generated.extend(int(t) for t in toks[:, i])
                s.seen_tokens += remaining
                s.done = True
        return self._finalize(uids, max_new_tokens, eos_token_id)

    def _stepwise_decode(self, seqs, max_new_tokens: int, temperature: float):
        """Drive step() until every sequence reaches ``max_new_tokens`` or
        the pool stops yielding progress (partial generations returned).
        Finished rows release their blocks at once: in this path the pool
        is too small, and a done row's pages let a straggler go on."""
        while True:
            for s in seqs:
                if len(s.generated) >= max_new_tokens and not s.done:
                    s.done = True
                    if s.blocks:
                        self.kv.allocator.free(s.blocks)
                        s.blocks = []
            if all(s.done for s in seqs):
                return
            if not self.step(temperature=temperature):
                logger.warning("KV pool exhausted mid-decode; returning partial "
                               f"generations ({self.kv.free_blocks} blocks free)")
                return

    def _finalize(self, uids, max_new_tokens: int, eos_token_id):
        outs = []
        for u in uids:
            g = self.state.seqs[u].generated[:max_new_tokens]
            if eos_token_id is not None and eos_token_id in g:
                g = g[: g.index(eos_token_id) + 1]
            outs.append(np.asarray(g))
        self.flush(uids)
        return outs

    def _block_tables(self, seqs) -> np.ndarray:
        """Block tables as wide as the pages this call can touch, padded to
        a power of two (the key's table width)."""
        need = max(len(s.blocks) for s in seqs)
        mb = BlockedKVCache.bucket_width(need, self.max_blocks_per_seq)
        return np.stack([self.state.block_table(s, mb) for s in seqs])

    def generate_compiled(self, prompts: List[np.ndarray], max_new_tokens: int = 32,
                          temperature: float = 0.0, eos_token_id: Optional[int] = None,
                          speculate: Optional[bool] = None, gamma: Optional[int] = None):
        """SplitFuse generation as ONE program (``mixed_loop``): chunked
        prefill, staggered prefill-to-decode transitions and decode, with no
        host round-trip between steps. Same outputs as ``generate`` for
        static workloads. With a draft attached (or ``speculate=True``) the
        narrow steps are draft/verify steps (``mixed_loop_spec``, ``gamma``
        drafts a step): the same greedy outputs, fewer target forwards per
        token."""
        speculate, gamma = self._speculation(speculate, gamma)
        c = self._config
        uids = list(range(len(prompts)))
        self.put(uids, prompts)
        seqs = [self.state.seqs[u] for u in uids]
        for s in seqs:
            if not self.state.ensure_capacity(s, len(s.pending) + max_new_tokens + 1):
                raise RuntimeError("KV pool exhausted for compiled mixed loop")
        b = len(seqs)
        plens = np.asarray([len(s.pending) for s in seqs], np.int32)
        pmax = int(plens.max())
        prompts_p = np.zeros((b, pmax), np.int32)
        for i, s in enumerate(seqs):
            prompts_p[i, :plens[i]] = s.pending
        chunk = c.prefill_chunk_size
        args = (self._tensor(prompts_p), self._tensor(plens),
                self._tensor(np.full((b,), max_new_tokens, np.int32)))
        loop = dict(chunk=chunk, wide_steps=-(-pmax // chunk),
                    narrow_steps=max(0, max_new_tokens - 1), greedy=temperature == 0.0)
        tables = self._tensor(self._block_tables(seqs))
        if speculate:
            (toks, emit, self.kv.k, self.kv.v, self.draft_kv.k,
             self.draft_kv.v) = self.runner.mixed_loop_spec(
                self.draft_runner, self.params, self.draft_params, *args, self.kv.k,
                self.kv.v, self.draft_kv.k, self.draft_kv.v, tables, self._sample_rng,
                temperature, gamma=gamma, **loop)
        else:
            toks, emit, self.kv.k, self.kv.v = self.runner.mixed_loop(
                self.params, *args, self.kv.k, self.kv.v, tables, self._sample_rng,
                temperature, **loop)
        toks = toks.cpu().numpy()
        emit = emit.cpu().numpy()
        outs = []
        for i, s in enumerate(seqs):
            # speculative emissions are (steps, gamma + 1) a row: read in order
            g = [int(t) for t, e in zip(toks[:, i].reshape(-1), emit[:, i].reshape(-1))
                 if e][:max_new_tokens]
            if eos_token_id is not None and eos_token_id in g:
                g = g[: g.index(eos_token_id) + 1]
            s.pending = []
            s.generated.extend(g)
            s.seen_tokens = int(plens[i]) + max_new_tokens
            s.done = True
            outs.append(np.asarray(g))
        self.flush(uids)
        return outs

    # ------------------------------------------------------------------
    # frame-based persistent serving loop (dynamic arrivals)
    # ------------------------------------------------------------------

    @staticmethod
    def _norm_arrival(item, max_new_tokens, temperature, eos_token_id):
        """Normalize a tuple arrival ``(uid, tokens[, max_new_tokens[,
        temperature[, eos_id]]])`` to ``(uid, tokens, limit, temp, eos)``;
        None in an optional field means the serve() default (eos_id=-1
        disables EOS for one row)."""
        if isinstance(item, dict):
            raise NotImplementedError(f"dict arrivals (scheduler metadata): {_ROADMAP}")
        uid, toks = item[0], item[1]
        limit = item[2] if len(item) > 2 and item[2] is not None else max_new_tokens
        temp = item[3] if len(item) > 3 and item[3] is not None else temperature
        eos = item[4] if len(item) > 4 and item[4] is not None else eos_token_id
        return uid, np.asarray(toks, np.int32).reshape(-1), int(limit), float(temp), eos

    def serve(self, arrivals: Iterable, *, max_new_tokens: int = 32,
              temperature: float = 0.0, eos_token_id: Optional[int] = None,
              frame_steps: Optional[int] = None,
              frame_slots: Optional[int] = None,
              speculate: Optional[bool] = None, gamma: Optional[int] = None,
              rng=None, scheduler=None, faults=None, resume_from=None,
              yield_boundaries: bool = False):
        """Continuous batching with dynamic arrivals.

        Generator: yields ``(uid, generated_tokens)`` as sequences finish.
        ``arrivals`` is an iterator polled once per frame boundary; each
        ``next()`` returns the tuple arrivals since the last poll (possibly
        an empty list) and raises StopIteration when no more will come.

        Decoding runs as K-step frames over a fixed set of slots whose
        state stays on the device between frames; the host touches the
        loop only at frame boundaries: admit arrivals into free slots (KV
        reserved up front for prompt + budget; admission defers arrivals
        the pool can't hold, FIFO), retire finished rows (EOS is detected
        in-frame; the host replays the emit mask), and grow the pow2 shape
        buckets. ``rng`` (an int seed or a ``torch.Generator`` on the
        engine's device) makes sampled rows reproducible. With a draft
        attached (or ``speculate=True``) the width-1 frames are draft/verify
        frames of ``gamma`` drafts a step (default
        ``config.speculate_gamma``); greedy rows give the tokens of plain
        decoding.
        """
        unported = {"scheduler": scheduler is not None, "faults": faults is not None,
                    "resume_from": resume_from is not None,
                    "yield_boundaries": yield_boundaries}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"serve({name}=...): {_ROADMAP}")
        speculate, gamma = self._speculation(
            speculate, gamma, " (pass draft_model= at construction or call attach_draft())")
        c = self._config
        steps = frame_steps or c.frame_steps
        adaptive = c.adaptive_frame_steps and frame_steps is None
        n_slots = frame_slots or c.max_ragged_batch_size
        if isinstance(rng, torch.Generator):
            frame_rng = rng
        else:
            seed = int(rng) if rng is not None else int(
                torch.randint(0, 2 ** 62, (1,), generator=self._rng))
            frame_rng = torch.Generator(device=self.device).manual_seed(seed)
        slots = DeviceSlotTable(n_slots, prompt_width=c.prefill_chunk_size,
                                table_width=1, rng=frame_rng, device=self.device)
        self.serve_counters = dict.fromkeys(STAT_NAMES, 0)
        draft = ((self.draft_runner, self.draft_params, self.draft_kv, gamma)
                 if speculate else None)
        return self._serve_guarded(slots, iter(arrivals), steps, max_new_tokens,
                                   temperature, eos_token_id, adaptive, draft)

    def _serve_guarded(self, slots, arrivals, steps, max_new_tokens,
                       temperature, eos_token_id, adaptive, draft):
        pending = collections.deque()
        try:
            yield from self._serve_loop(slots, arrivals, pending, steps,
                                        max_new_tokens, temperature,
                                        eos_token_id, adaptive, draft)
        finally:
            # abandonment (break / close() / error) must not strand state:
            # release every slot-held and every deferred sequence
            for uid in list(slots.slot_of_uid):
                self.state.flush_sequence(uid)
            for item in pending:
                self.state.flush_sequence(item[0])

    @staticmethod
    def _pick_frame_steps(ewma: float, max_steps: int, saturated: bool) -> int:
        """Adaptive frame length: the pow2 bucket that admits about one
        expected arrival per frame; a saturated table or a drained arrival
        stream gets the full ``max_steps``."""
        if saturated or ewma < 0.125:
            return max_steps
        target = max(1.0, max_steps / (1.0 + ewma))
        return min(BlockedKVCache.floor_pow2(target), max_steps)

    def _validate_arrival(self, uid, toks, limit, in_flight: bool) -> int:
        """Enqueue-time validation; returns the (possibly clamped) budget."""
        if uid < 0:
            raise ValueError(f"uid={uid}: serve() uids must be >= 0 (-1 is "
                             "the free-slot sentinel)")
        if in_flight:
            raise ValueError(f"uid={uid} is already live in the slot table — "
                             "serve() uids must be unique among in-flight requests")
        if uid in self.state.seqs:
            raise ValueError(f"uid={uid} is already tracked by the engine — "
                             "flush it before serving, or it would inherit "
                             "the old descriptor's tokens")
        if len(toks) + 2 > self.max_seq_len:
            raise ValueError(f"uid={uid}: prompt of {len(toks)} tokens can "
                             f"never fit max_seq_len={self.max_seq_len}")
        if len(toks) + limit + 1 > self.max_seq_len:
            clamped = self.max_seq_len - len(toks) - 1
            logger.warning(f"uid={uid}: prompt ({len(toks)}) + budget ({limit}) "
                           f"+ 1 exceeds max_seq_len={self.max_seq_len}; "
                           f"clamping budget to {clamped}")
            limit = clamped
        return limit

    def _admit_capacity(self, seq, toks, limit: int) -> bool:
        """Reserve KV blocks for prompt + budget + one lookahead slot."""
        return self.state.ensure_capacity(seq, len(toks) + limit + 1)

    def _handle_nonfinite(self, slots, flags, frame: int) -> None:
        """Quarantine rows whose logits went non-finite in the last frame
        (``flags``: the frame's finite-check latch): evict, free their
        blocks, and log them (they are not yielded); the batch never dies
        for one row."""
        for uid in slots.nonfinite_uids(flags):
            seq = self.state.seqs.get(uid)
            partial = list(seq.generated) if seq is not None else []
            slots.evict(uid)
            self.state.flush_sequence(uid)
            self.fault_log.append({"uid": uid, "kind": "poison_row", "frame": frame,
                                   "tokens_emitted": len(partial)})
            logger.warning(f"serve(): uid={uid} quarantined at frame {frame}: "
                           "non-finite logits")

    def _serve_loop(self, slots, arrivals, pending, steps, max_new_tokens,
                    temperature, eos_token_id, adaptive, draft):
        c = self._config
        alpha = c.frame_steps_ewma_alpha
        ewma = 0.0
        exhausted = False
        boundary = -1
        while True:
            boundary += 1
            if exhausted:
                batch = None
                ewma = (1.0 - alpha) * ewma
            else:
                try:
                    batch = next(arrivals)
                except StopIteration:
                    exhausted = True
                    batch = None
                ewma = alpha * len(batch or []) + (1.0 - alpha) * ewma
                # validate at enqueue, before any KV is reserved this round
                for item in (batch or []):
                    uid, toks, limit, temp, eos = self._norm_arrival(
                        item, max_new_tokens, temperature, eos_token_id)
                    limit = self._validate_arrival(
                        uid, toks, limit,
                        in_flight=uid in slots.slot_of_uid or
                        any(p[0] == uid for p in pending))
                    pending.append((uid, toks, limit, temp, eos))
            # ---- admission control (FIFO; blocks reserved up front, so
            # block tables never grow mid-flight) ----
            admits = []
            while pending and len(admits) < slots.free_slots():
                uid, toks, limit, temp, eos = pending[0]
                seq = self.state.get_or_create_sequence(uid)
                if not self._admit_capacity(seq, toks, limit):
                    if slots.live_count() == 0 and not admits:
                        raise RuntimeError(
                            f"uid={uid}: prompt + budget can never fit the "
                            f"KV pool ({self.kv.free_blocks} blocks free "
                            "with no live sequences)")
                    break        # wait for retirements to free blocks
                pending.popleft()
                seq.done = False
                admits.append((uid, seq, toks, limit, temp, eos))
            if admits:
                slots.ensure_widths(max(len(a[2]) for a in admits),
                                    max(len(a[1].blocks) for a in admits),
                                    self.max_seq_len, self.max_blocks_per_seq)
                slots.admit(admits)
            if slots.live_count() == 0:
                if exhausted and not pending:
                    return
                continue         # arrival gap: poll again
            # ---- frame plan: wide while any slot prefills, else decode
            # (the draft/verify frames when a draft rides) ----
            width = c.prefill_chunk_size if slots.any_prefilling() else 1
            cur_steps = steps
            if adaptive:
                cur_steps = self._pick_frame_steps(ewma, steps, slots.free_slots() == 0)
            toks, emit, nonfinite, stats = slots.run_frame(
                self.runner, self.params, self.kv, width, cur_steps,
                slots.all_greedy(), draft=draft)
            for name, n in zip(STAT_NAMES, stats):
                self.serve_counters[name] += int(n)
            # quarantine before the host replay: a poisoned row's slot is
            # freed here, so absorb neither emits nor retires it
            self._handle_nonfinite(slots, nonfinite, boundary)
            emissions, finished = slots.absorb(toks, emit, width)
            for uid, new_toks in emissions.items():
                seq = self.state.seqs[uid]
                seq.generated.extend(new_toks)
                # the committed watermark: rejected drafts never count as seen
                seq.seen_tokens = int(slots.committed_h[slots.slot_of_uid[uid]])
            for uid in finished:
                seq = self.state.seqs[uid]
                seq.done = True
                out = np.asarray(seq.generated, np.int64)
                slots.retire(uid)
                self.state.flush_sequence(uid)
                yield uid, out


def _is_quantized(tree) -> bool:
    """Whether the tree holds a quantized ({"q", "s"}) leaf."""
    return any(isinstance(v, dict) and ("q" in v or _is_quantized(v)) for v in tree.values())


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
