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
run eagerly (``model_runner.py``).

Serving reports to ``ServingTelemetry`` (``telemetry.py``: ``serve_stats``,
``telemetry.snapshot()`` / ``render_prometheus()``) and keeps JAX's
request ledger (``faults.LedgerEntry``); quarantined rows land in
``fault_log`` as ``faults.FaultReason``. ``serve(scheduler=)`` runs the
SLO-aware ``scheduler.RequestScheduler`` (priorities with aging, tenant
fair share and quotas, shedding and deferral, frame-boundary preemption)
on dict arrivals carrying ``tenant`` / ``priority`` / ``slo_ms``. The KV
hierarchy (``kv_hierarchy.py``): ``prefix_cache=True`` maps published
prefix blocks read-only into a new row's block table (copy-on-write at a
mid-block divergence) and starts its prefill at the watermark;
``kv_swap_dir=`` (or ``attach_kv_tier``) swaps a preempted row's pages to
host files through the port's aio engine and back at re-admission.

``RaggedInferenceEngineConfig`` keeps every field and default of the JAX
config. What is not ported yet raises ``NotImplementedError`` citing its
ROADMAP.md item: tensor parallelism (``tp > 1``, item 11), roles other
than "unified" and ``serve(yield_boundaries=True)`` (item 12), the repair
policy, ``serve(faults=, resume_from=)``, arrivals carrying
``deadline_ms`` or ``generated``, and ``cancel_request`` (item 6), and
arrivals carrying a ``trace`` (item 12). The retry and watchdog fields are
accepted and not acted on.
"""

import collections
import dataclasses
import logging
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import get_device
from ...models.transformer import CausalLM, build_model
from ...module_inject import as_inference_model
from ..sampling import sample_logits
from .faults import FaultReason, LedgerEntry
from .kv_cache import BlockedKVCache
from .kv_hierarchy import KVSwapTier, PrefixCache, token_fingerprint
from .model_implementations.quantize import quantize_params
from .model_runner import PagedModelRunner
from .ragged_manager import DeviceSlotTable, DSStateManager
from .scheduler import PRIORITY_NAMES, Request, normalize_priority
from .telemetry import STAT_NAMES, ServingTelemetry

logger = logging.getLogger(__name__)

_ROADMAP = "not ported to deepspeed_tpu_torch yet (ROADMAP.md, section A)"
_FAULTS = ("rides the deadline and fault machinery, which is not ported to "
           "deepspeed_tpu_torch yet (ROADMAP.md section A, item 6)")
_TRACING = ("distributed tracing is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP.md section A, item 12)")


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
        "tp": c.tp > 1,
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
        self.telemetry = ServingTelemetry(enabled=c.telemetry, trace=c.telemetry_trace)
        # the host-side request ledger of the current serve() run
        self._ledger: Dict[int, LedgerEntry] = {}
        # the serving clock (telemetry spans, scheduler shed stamps);
        # tests inject one clock into both this and ``telemetry.clock``
        self._clock = time.monotonic
        # KV hierarchy (kv_hierarchy.py): host swap tier and prefix cache,
        # both off by default; the cache rides the refcounted allocator
        self.kv_swap = KVSwapTier(c.kv_swap_dir) if c.kv_swap_dir else None
        self.prefix_cache = (PrefixCache(self.kv, max_blocks=c.prefix_cache_max_blocks,
                                         swap=self.kv_swap)
                             if c.prefix_cache else None)
        # cumulative cache / tier stats at the last telemetry sync
        self._pc_stats_base: Optional[Dict] = None
        self._tier_stats_base: Optional[Dict] = None
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
        if self.prefix_cache is not None:
            # spilled prefix pages carry the draft pool's page too, so a
            # restored block keeps draft acceptance
            self.prefix_cache.draft_kv = self.draft_kv
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

    def attach_kv_tier(self, tier, tag: Optional[str] = None) -> None:
        """Attach an external (possibly shared) ``KVSwapTier`` in place of
        any tier built from ``kv_swap_dir``. ``tag`` namespaces this
        engine's prefix-cache spill keys inside a shared tier (default:
        the engine's id)."""
        self.kv_swap = tier
        if self.prefix_cache is not None:
            self.prefix_cache.swap = tier
            self.prefix_cache.tag = f"{id(self):x}_" if tag is None else f"{tag}_"
        self._tier_stats_base = None

    @property
    def serve_stats(self) -> Dict:
        """The telemetry's ``serve_view`` (JAX ``serve_stats``): frames,
        frame-steps histogram and trace, arrival EWMA, the SLO p90s and the
        speculative counters. Full detail: ``telemetry.snapshot()`` /
        ``telemetry.render_prometheus()``."""
        return self.telemetry.serve_view

    def attach_monitor(self, monitor, every_frames: int = 1) -> None:
        """Fan serving telemetry out through ``monitor.write_events`` at
        frame boundaries."""
        self.telemetry.attach_monitor(monitor, every_frames=every_frames)

    def cancel_request(self, uid: int) -> bool:
        """Cancel an in-flight request through the ledger (not ported)."""
        raise NotImplementedError(f"cancel_request {_FAULTS}")

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
        """Normalize one arrival to ``(uid, tokens, limit, temp, eos,
        tenant, priority, slo_ms)`` (JAX ``_norm_arrival`` without the
        fields of paths not ported yet).

        Tuple form: ``(uid, tokens[, max_new_tokens[, temperature[,
        eos_id]]])``; None in an optional field means the serve() default
        (eos_id=-1 disables EOS for one row). Tuples carry no scheduling
        metadata. Dict form: ``{"uid", "tokens"}`` plus optional
        ``max_new_tokens`` / ``temperature`` / ``eos_token_id`` and the
        scheduling fields ``tenant`` (str), ``priority`` ("interactive" |
        "batch" | "best_effort" or 0..2) and ``slo_ms`` (a per-request TTFT
        target), which are inert without a ``scheduler=``. A dict carrying
        ``deadline_ms`` or ``generated`` (a resume) raises, as does one
        carrying ``trace``: those paths are not ported yet."""
        if isinstance(item, dict):
            for key, why in (("deadline_ms", _FAULTS), ("generated", _FAULTS),
                             ("trace", _TRACING)):
                if item.get(key) is not None:
                    raise NotImplementedError(f"arrival field {key!r}: {why}")
            uid, toks = item["uid"], item["tokens"]
            limit = item.get("max_new_tokens")
            limit = max_new_tokens if limit is None else limit
            temp = item.get("temperature")
            temp = temperature if temp is None else temp
            eos = item.get("eos_token_id")
            eos = eos_token_id if eos is None else eos
            tenant, prio, slo_ms = item.get("tenant"), item.get("priority"), item.get("slo_ms")
        else:
            uid, toks = item[0], item[1]
            limit = item[2] if len(item) > 2 and item[2] is not None else max_new_tokens
            temp = item[3] if len(item) > 3 and item[3] is not None else temperature
            eos = item[4] if len(item) > 4 and item[4] is not None else eos_token_id
            tenant = prio = slo_ms = None
        return (uid, np.asarray(toks, np.int32).reshape(-1), int(limit), float(temp), eos,
                tenant, prio, slo_ms)

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
        ``next()`` returns the arrivals since the last poll (possibly an
        empty list; tuples or dicts, see ``_norm_arrival``) and raises
        StopIteration when no more will come.

        Decoding runs as K-step frames over a fixed set of slots whose
        state stays on the device between frames; the host touches the
        loop only at frame boundaries: admit arrivals into free slots (KV
        reserved up front for prompt + budget; admission defers arrivals
        the pool can't hold), retire finished rows (EOS is detected
        in-frame; the host replays the emit mask), publish prefix blocks,
        and grow the pow2 shape buckets. ``rng`` (an int seed or a
        ``torch.Generator`` on the engine's device) makes sampled rows
        reproducible. With a draft attached (or ``speculate=True``) the
        width-1 frames are draft/verify frames of ``gamma`` drafts a step
        (default ``config.speculate_gamma``); greedy rows give the tokens
        of plain decoding.

        ``scheduler`` (a ``scheduler.RequestScheduler``) replaces the FIFO
        admission deque with the SLO-aware policy object: priority classes
        with aging, tenant fair share and quotas, shedding and deferral
        under TTFT pressure, and frame-boundary preemption, whose victims
        swap their pages to the tier when ``kv_swap_dir`` is set. Every
        request reports to ``self.telemetry``.
        """
        unported = {"faults": faults is not None, "resume_from": resume_from is not None,
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
        if self.prefix_cache is not None:
            # telemetry counters restart per serve run: rebase the cache's
            # cumulative bookkeeping
            self._pc_stats_base = dict(self.prefix_cache.stats)
        if self.kv_swap is not None:
            # request records exist solely for re-admission: a new run has
            # abandoned its predecessors' (a shared tier never prunes)
            self.kv_swap.prune_requests(set())
            self._tier_stats_base = dict(self.kv_swap.stats)
        self._ledger = {}
        self.telemetry.begin_serve(speculate=speculate, gamma=gamma, adaptive=adaptive,
                                   n_slots=n_slots, kv_blocks_total=self.kv.num_blocks,
                                   tp_degree=c.tp, kv_block_bytes=self.kv.block_bytes)
        draft = ((self.draft_runner, self.draft_params, self.draft_kv, gamma)
                 if speculate else None)
        arrivals = iter(arrivals)
        if scheduler is not None:
            scheduler.begin_serve(self)
            return self._serve_guarded_sched(slots, arrivals, scheduler, steps,
                                             max_new_tokens, temperature, eos_token_id,
                                             adaptive, draft)
        return self._serve_guarded(slots, arrivals, steps, max_new_tokens,
                                   temperature, eos_token_id, adaptive, draft)

    def _release_all(self, slots, queued_uids) -> None:
        """Abandonment (break / close() / error) must not strand state:
        release every slot-held, queued and ledgered sequence. The ledger
        also covers a preempted row caught between eviction and
        re-admission."""
        for uid in list(slots.slot_of_uid) + list(queued_uids) + list(self._ledger):
            self.state.flush_sequence(uid)
        self._ledger.clear()

    def _serve_guarded(self, slots, arrivals, steps, max_new_tokens,
                       temperature, eos_token_id, adaptive, draft):
        pending = collections.deque()
        try:
            yield from self._serve_loop(slots, arrivals, pending, steps,
                                        max_new_tokens, temperature,
                                        eos_token_id, adaptive, draft)
        finally:
            self._release_all(slots, [item[0] for item in pending])

    def _serve_guarded_sched(self, slots, arrivals, sched, steps, max_new_tokens,
                             temperature, eos_token_id, adaptive, draft):
        try:
            yield from self._serve_loop_sched(slots, arrivals, sched, steps,
                                              max_new_tokens, temperature,
                                              eos_token_id, adaptive, draft)
        finally:
            self._release_all(slots, sched.queued_uids())

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

    # ------------------------------------------------------------------
    # telemetry, the request ledger and fault records
    # ------------------------------------------------------------------

    def _run_frame(self, slots, width, cur_steps, ewma, queue_depth, draft):
        """Dispatch one frame and absorb its counters (JAX's frame call and
        ``_sync_frame_stats``): the in-frame stat vector comes back in the
        frame's one device-to-host copy, so each boundary holds exactly
        this frame's counts. ``recompiled_programs`` is the runner's count
        of CUDA-graph captures (0 where nothing is captured)."""
        tel = self.telemetry
        with tel.frame_trace(width, cur_steps):
            toks, emit, nonfinite, stats = slots.run_frame(
                self.runner, self.params, self.kv, width, cur_steps,
                slots.all_greedy(), draft=draft)
        for name, n in zip(STAT_NAMES, stats):
            self.serve_counters[name] += int(n)
        if tel.enabled:
            graphs = self.runner.graphs
            tel.on_frame(delta=stats, width=width, steps=cur_steps,
                         live_slots=slots.live_count(),
                         kv_blocks_in_use=self.kv.num_blocks - self.kv.free_blocks,
                         arrival_ewma=ewma,
                         recompiled_programs=graphs.captures if graphs is not None else 0,
                         queue_depth=queue_depth)
        else:
            tel.frame_view_update(width, cur_steps, ewma)
        return toks, emit, nonfinite

    def _ledger_add(self, uid, toks, limit, temp, eos, tenant=None, priority=None,
                    slo_ms=None) -> None:
        self._ledger[uid] = LedgerEntry(
            uid=uid, prompt=[int(t) for t in toks], limit=int(limit), temp=float(temp),
            eos=eos, tenant=tenant, priority=priority, slo_ms=slo_ms)

    def _enqueue_traced(self, uid, **kw) -> None:
        """``telemetry.on_enqueue``, writing back into the ledger entry the
        trace context it returns (JAX ``_enqueue_traced``; without a tracer
        it is None)."""
        trace = self.telemetry.on_enqueue(uid, **kw)
        ent = self._ledger.get(uid)
        if ent is not None and trace is not None:
            ent.trace = trace

    def _fault_event(self, kind: str, frame: int, detail: str) -> None:
        """Frame-level fault event (no single victim request), e.g. a swap
        tier failure that falls back to re-prefill."""
        self.fault_log.append(FaultReason(uid=-1, kind=kind, frame=frame, detail=detail))
        self.telemetry.on_fault(kind)
        logger.warning(f"serve(): {kind} at frame {frame}: {detail}")

    def _fault_retire(self, uid: int, kind: str, frame: int, detail: str,
                      partial=None) -> None:
        """Abnormal retirement: drop the ledger entry and any swap record,
        record a ``FaultReason`` with the committed partial output and count
        it; the request is not yielded."""
        ent = self._ledger.pop(uid, None)
        self._drop_swap(uid)
        tenant = ent.tenant if ent is not None else None
        priority = ent.priority if ent is not None else None
        self.fault_log.append(FaultReason(
            uid=uid, kind=kind, frame=frame, detail=detail,
            tokens_emitted=len(partial or ()), partial=list(partial) if partial else None,
            tenant=tenant, priority=str(priority) if priority is not None else None))
        self.telemetry.on_fault(kind, uid=uid)
        logger.warning(f"serve(): uid={uid} retired with fault kind={kind} at "
                       f"frame {frame}: {detail}")

    def _quarantine_rows(self, slots, flags, frame: int, sched=None) -> None:
        """Quarantine rows whose logits went non-finite in the last frame
        (``flags``: the frame's finite-check latch): evict, free their
        blocks, drop what they published to the prefix cache (a poisoned
        page must never reach a healthy request) and retire them with a
        ``poison_row`` fault; the batch never dies for one row."""
        for uid in slots.nonfinite_uids(flags):
            seq = self.state.seqs.get(uid)
            partial = list(seq.generated) if seq is not None else []
            slots.evict(uid)
            if sched is not None:
                sched.on_retire(uid)
            if self.prefix_cache is not None:
                self.prefix_cache.invalidate_uid(uid)
            self.state.flush_sequence(uid)
            self._fault_retire(uid, "poison_row", frame,
                               "non-finite logits (in-frame finite check); row "
                               "quarantined, siblings unaffected", partial=partial)

    # ------------------------------------------------------------------
    # KV hierarchy (kv_hierarchy.py): prefix-cache admission, copy-on-write,
    # boundary publishing, swap-tier restore
    # ------------------------------------------------------------------

    def _drop_swap(self, uid: int) -> None:
        """Drop a request's swap-tier record at terminal retirement."""
        if self.kv_swap is not None:
            self.kv_swap.drop_request(uid)

    def _admit_capacity(self, uid: int, seq, toks, limit: int,
                        boundary: int) -> Optional[int]:
        """Reserve KV capacity for one admission (JAX ``_admit_capacity``).
        Returns the admission watermark ``cached0`` (0 on the cold path) or
        None when the pool cannot hold the request yet.

        With the hierarchy off this is the plain capacity probe. With it
        on, in order of preference: (1) a preempted victim whose pages sit
        in the swap tier restores them into fresh blocks; (2) a prompt
        matching published prefix blocks maps them read-only
        (copy-on-write at a mid-block divergence), then the tier's prefix
        records are probed; (3) cold. A deferred request keeps its mapped
        shared blocks and its ``resume_cached`` mark, so the retry at the
        next boundary resumes where it left off."""
        total = len(toks) + limit + 1
        if self.prefix_cache is None and self.kv_swap is None:
            return 0 if self.state.ensure_capacity(seq, total) else None
        chunk = self._config.prefill_chunk_size
        # --- (1) swap-in re-admission ---
        if self.kv_swap is not None and not seq.blocks:
            rec = self.kv_swap.request_record(uid)
            # the record's pages cover the first rec["tokens"] tokens of the
            # folded stream; the content fingerprint is checked too, so a
            # reused uid never restores another request's pages
            if rec is not None and not (
                    0 < rec["tokens"] <= len(toks)
                    and rec.get("fingerprint") == token_fingerprint(toks[:rec["tokens"]])):
                self.kv_swap.drop_request(uid)
                rec = None
            if rec is not None:
                if not self._ensure_capacity_reclaim(seq, total):
                    return None      # record kept: retry next boundary
                try:
                    self.kv_swap.restore_request(uid, self.kv, seq.blocks[:rec["blocks"]],
                                                 draft_kv=self.draft_kv)
                except (OSError, KeyError, ValueError) as e:
                    self.kv_swap.drop_request(uid)
                    self._fault_event("swap_failed", boundary,
                                      f"uid={uid}: page restore failed "
                                      f"({type(e).__name__}: {e}); re-prefilling")
                else:
                    self.kv_swap.drop_request(uid)
                    cached0 = min(rec["tokens"], len(toks) - 1) // chunk * chunk
                    seq.resume_cached = cached0
                    self.telemetry.on_kv_swap_in(rec["blocks"], uid=uid)
                    return cached0
        # --- (2) prefix hit: the local cache first, then the tier's
        # content-addressed prefix records; one probe per enqueue ---
        cached0 = seq.resume_cached
        if not seq.blocks and not seq.hier_probed and (
                self.prefix_cache is not None
                or (self.kv_swap is not None and self._config.tier_prefix_share)):
            seq.hier_probed = True
            if self.prefix_cache is not None:
                cached0 = self._prefix_map(seq, toks)
            if cached0 == 0 and self.kv_swap is not None and self._config.tier_prefix_share:
                cached0 = self._tier_prefix_map(seq, toks, boundary)
        # --- (3) fresh blocks for everything past the mapped prefix ---
        if not self._ensure_capacity_reclaim(seq, total):
            return None
        seq.resume_cached = cached0
        return cached0

    def _ensure_capacity_reclaim(self, seq, total: int) -> bool:
        """``ensure_capacity`` with one retry after evicting cold
        unreferenced prefix-cache blocks (spilled to the swap tier when
        there is one)."""
        if self.state.ensure_capacity(seq, total):
            return True
        if self.prefix_cache is not None:
            need = self.kv.blocks_for(total) - len(seq.blocks) - self.kv.free_blocks
            if need > 0 and self.prefix_cache.reclaim(need) > 0 \
                    and self.state.ensure_capacity(seq, total):
                return True
        return False

    def _prefix_map(self, seq, toks) -> int:
        """Map the longest usable published prefix into ``seq.blocks``:
        full blocks below the chunk-aligned admission watermark are shared
        read-only; a hit ending mid-block copies that page (copy-on-write,
        for the draft's pools too) so the divergent continuation writes a
        private copy. Returns the watermark (0 = miss). Chunk alignment
        makes a hit replay the chunk boundaries of a cold admission."""
        pc = self.prefix_cache
        tel = self.telemetry
        alloc = self.kv.allocator
        bs = self.kv.block_size
        chunk = self._config.prefill_chunk_size
        full, partial = pc.match(toks)
        # every matched entry is refcount 1 until mapped below: protect the
        # whole chain so one entry's restore cannot reclaim a chain-mate
        protect = {e.eid for e in full} | ({partial[0].eid} if partial else set())
        usable = []
        for e in full:
            if not pc.ensure_resident(e, protect=protect):
                break
            usable.append(e)
        partial_ok = partial if (
            partial is not None and len(usable) == len(full)
            and pc.ensure_resident(partial[0], protect=protect)) else None
        matched = len(usable) * bs + (partial_ok[1] if partial_ok else 0)
        cached0 = min(matched, len(toks) - 1) // chunk * chunk
        n_full, mid = cached0 // bs, cached0 % bs
        chain = usable + ([partial_ok[0]] if partial_ok else [])
        if mid and alloc.free_blocks < 1 and \
                not pc.reclaim(1, protect={e.eid for e in chain}):
            # no page for the copy: shrink the hit to whole blocks, aligned
            # to both the block and the chunk
            align = bs * chunk // math.gcd(bs, chunk)
            cached0 = n_full * bs // align * align
            n_full, mid = cached0 // bs, 0
        if cached0 <= 0:
            tel.on_prefix_lookup(0, 0, False)
            return 0
        shared = [e.block for e in chain[:n_full]]
        alloc.share(shared)
        seq.blocks.extend(shared)
        if mid:
            src = chain[n_full].block
            dst = alloc.allocate(1)[0]
            self.kv.k, self.kv.v = self.kv.copy_blocks(self.kv.k, self.kv.v, [src], [dst])
            if self.draft_kv is not None:
                self.draft_kv.k, self.draft_kv.v = self.draft_kv.copy_blocks(
                    self.draft_kv.k, self.draft_kv.v, [src], [dst])
            seq.blocks.append(dst)
            pc.stats["cow_copies"] += 1
        pc.touch(chain[:n_full + (1 if mid else 0)], cached0)
        tel.on_prefix_lookup(cached0, n_full + (1 if mid else 0), mid > 0)
        # the watermark goes on the descriptor the moment blocks are
        # mapped: a deferred admission must resume at cached0, never
        # prefill from 0 into the shared (read-only) pages
        seq.resume_cached = cached0
        # the mapped full blocks are published entries: this row's first
        # boundary publish resumes after them
        seq.published_upto = n_full * bs
        seq.publish_parent = chain[n_full - 1].eid if n_full else -1
        return cached0

    def _publish_prefixes(self, slots) -> None:
        """Frame-boundary publish: every live row's full blocks below its
        committed watermark enter the prefix index; then the cache's
        bookkeeping deltas go to the telemetry counters."""
        pc = self.prefix_cache
        if pc is None:
            return
        bs = self.kv.block_size
        for uid, slot in list(slots.slot_of_uid.items()):
            seq = self.state.seqs.get(uid)
            ent = self._ledger.get(uid)
            if seq is None or ent is None or not seq.blocks:
                continue
            w = int(slots.cached_h[slot])
            lo = seq.published_upto // bs * bs
            if w // bs * bs <= lo:
                continue                     # no newly committed full block
            # hand publish only the unpublished suffix of the stream
            pl = len(ent.prompt)
            seg = seq.generated[lo - pl:] if lo >= pl else ent.prompt[lo:] + seq.generated
            _, seq.publish_parent, d_done = pc.publish(
                uid, seg, seq.blocks, w, start_depth=lo // bs, parent=seq.publish_parent)
            # advance only as far as the walk got: an early stop must retry
            # those depths, never skip them
            seq.published_upto = d_done * bs
        s = dict(pc.stats)
        base = self._pc_stats_base or {k: 0 for k in s}
        self.telemetry.on_prefix_update(
            s["published"] - base["published"], s["evicted"] - base["evicted"],
            s["swapped_out"] - base["swapped_out"], s["swapped_in"] - base["swapped_in"],
            pc.resident_blocks())
        self._pc_stats_base = s

    def _drain_swap_boundary(self, boundary: int) -> None:
        """Frame-boundary drain of the async swap-out commits queued at the
        previous boundary (their writes overlapped the frame in between);
        a drain failure drops the queued records, whose victims then
        re-prefill, and is recorded as a ``swap_failed`` fault."""
        tier = self.kv_swap
        if tier is None:
            return
        try:
            tier.drain(blocking=False)
        except OSError as e:
            self._fault_event("swap_failed", boundary,
                              f"async swap-out commit failed ({type(e).__name__}: {e}); "
                              "queued records dropped, victims will re-prefill")
        if not tier.shared and self.telemetry.enabled:
            s, base = tier.stats, self._tier_stats_base or {}
            self.telemetry.on_kv_swap_commits(
                s["commits_overlapped"] - base.get("commits_overlapped", 0),
                s["commits_blocking"] - base.get("commits_blocking", 0))
            self._tier_stats_base = dict(s)

    def _tier_prefix_map(self, seq, toks, boundary: int) -> int:
        """Match the prompt against the tier's content-addressed prefix
        records and restore the hit pages into fresh private blocks.
        Returns the chunk-aligned admission watermark (0 = miss)."""
        chunk = self._config.prefill_chunk_size
        hit = self.kv_swap.match_prefix(toks, chunk)
        if hit is None:
            return 0
        key, rec = hit
        cached0 = min(rec["tokens"], len(toks) - 1) // chunk * chunk
        if cached0 <= 0:
            return 0
        n = self.kv.blocks_for(cached0)
        if self.kv.allocator.free_blocks < n and self.prefix_cache is not None:
            self.prefix_cache.reclaim(n - self.kv.allocator.free_blocks)
        if self.kv.allocator.free_blocks < n:
            return 0
        blocks = self.kv.allocator.allocate(n)
        try:
            self.kv_swap.restore_prefix(key, self.kv, blocks, draft_kv=self.draft_kv)
        except (OSError, KeyError, ValueError) as e:
            self.kv.allocator.free(blocks)
            self._fault_event("swap_failed", boundary,
                              f"tier prefix restore failed ({type(e).__name__}: {e}); "
                              "admitting cold")
            return 0
        seq.blocks.extend(blocks)
        seq.resume_cached = cached0
        self.telemetry.on_tier_prefix_hit(cached0, n)
        return cached0

    # ------------------------------------------------------------------
    # the serving loops
    # ------------------------------------------------------------------

    def _poll(self, arrivals, exhausted: bool, ewma: float):
        """One arrival poll: (batch or None, exhausted, ewma)."""
        alpha = self._config.frame_steps_ewma_alpha
        if exhausted:
            return None, True, (1.0 - alpha) * ewma
        try:
            batch = next(arrivals)
        except StopIteration:
            exhausted, batch = True, None
        return batch, exhausted, alpha * len(batch or []) + (1.0 - alpha) * ewma

    def _plan_frame(self, slots, steps, adaptive, ewma, cap=None):
        """Frame plan: wide while any slot prefills, else width 1 (the
        draft/verify frames when a draft rides); the frame length is the
        adaptive bucket, capped by the scheduler's pressure signal."""
        width = self._config.prefill_chunk_size if slots.any_prefilling() else 1
        saturated = slots.free_slots() == 0
        cur_steps = self._pick_frame_steps(ewma, steps, saturated) if adaptive else steps
        if cap is not None:
            cur_steps = min(cur_steps, cap)
        self.telemetry.on_frame_plan(ewma, saturated, cur_steps)
        return width, cur_steps

    def _absorb(self, slots, toks, emit, width):
        """Host replay of a frame: extend each row's tokens, advance its
        committed watermark (rejected drafts never count as seen), report
        the emissions; returns the finished uids."""
        emissions, finished = slots.absorb(toks, emit, width)
        for uid, new_toks in emissions.items():
            seq = self.state.seqs[uid]
            seq.generated.extend(new_toks)
            seq.seen_tokens = int(slots.committed_h[slots.slot_of_uid[uid]])
            self.telemetry.on_emit(uid, len(new_toks))
        self._publish_prefixes(slots)
        return finished

    def _retire(self, slots, uid, sched=None):
        seq = self.state.seqs[uid]
        seq.done = True
        out = np.asarray(seq.generated, np.int64)
        slots.retire(uid)
        self.state.flush_sequence(uid)
        if sched is not None:
            sched.on_retire(uid)
        self._ledger.pop(uid, None)
        self._drop_swap(uid)
        self.telemetry.on_retire(uid)
        return out

    def _serve_loop(self, slots, arrivals, pending, steps, max_new_tokens,
                    temperature, eos_token_id, adaptive, draft):
        tel = self.telemetry
        ewma = 0.0
        exhausted = False
        boundary = -1
        while True:
            boundary += 1
            # commit the async swap-out writes queued at the previous boundary
            self._drain_swap_boundary(boundary)
            batch, exhausted, ewma = self._poll(arrivals, exhausted, ewma)
            # validate at enqueue, before any KV is reserved this round
            for item in (batch or []):
                uid, toks, limit, temp, eos, *_ = self._norm_arrival(
                    item, max_new_tokens, temperature, eos_token_id)
                limit = self._validate_arrival(
                    uid, toks, limit,
                    in_flight=uid in slots.slot_of_uid or any(p[0] == uid for p in pending))
                pending.append((uid, toks, limit, temp, eos))
                self._ledger_add(uid, toks, limit, temp, eos)
                self._enqueue_traced(uid)
            # ---- admission control (FIFO; blocks reserved up front, so
            # block tables never grow mid-flight) ----
            admits = []
            blocks_before = self.kv.free_blocks
            while pending and len(admits) < slots.free_slots():
                uid, toks, limit, temp, eos = pending[0]
                seq = self.state.get_or_create_sequence(uid)
                cached0 = self._admit_capacity(uid, seq, toks, limit, boundary)
                if cached0 is None:
                    if slots.live_count() == 0 and not admits:
                        raise RuntimeError(
                            f"uid={uid}: prompt + budget can never fit the "
                            f"KV pool ({self.kv.free_blocks} blocks free "
                            "with no live sequences)")
                    break        # wait for retirements to free blocks
                pending.popleft()
                seq.done = False
                admits.append((uid, seq, toks, limit, temp, eos, cached0))
                tel.on_admit(uid)
            if pending:
                # overload is otherwise invisible: count it and warn
                tel.on_defer(queue_depth=len(pending),
                             frame_steps=tel.serve_view["frame_steps_last"] or steps,
                             free_slots=slots.free_slots() - len(admits),
                             free_blocks=self.kv.free_blocks,
                             reserved_blocks=blocks_before - self.kv.free_blocks)
            if admits:
                slots.ensure_widths(max(len(a[2]) for a in admits),
                                    max(len(a[1].blocks) for a in admits),
                                    self.max_seq_len, self.max_blocks_per_seq)
                slots.admit(admits)
            if slots.live_count() == 0:
                if exhausted and not pending:
                    return
                continue         # arrival gap: poll again
            width, cur_steps = self._plan_frame(slots, steps, adaptive, ewma)
            toks, emit, nonfinite = self._run_frame(slots, width, cur_steps, ewma,
                                                    len(pending), draft)
            # quarantine before the host replay: a poisoned row's slot is
            # freed here, so absorb neither emits nor retires it
            self._quarantine_rows(slots, nonfinite, boundary)
            for uid in self._absorb(slots, toks, emit, width):
                yield uid, self._retire(slots, uid)

    def _evict_to_queue(self, uid, slots, sched, boundary: int = -1):
        """Preempt a live row at a frame boundary: freeze its slot, release
        its KV blocks, fold its emitted tokens into the request's prompt and
        re-queue it at the front of its class/tenant queue. Re-admission
        re-prefills the committed prefix, unless the swap tier is on: then
        the victim's committed pages are swapped out here (one device read
        per pool) and swapped back in at re-admission."""
        seq = self.state.seqs[uid]
        req = sched.on_evict(uid)
        emitted = seq.generated[req.gen_base:]
        if emitted:
            req.tokens = np.concatenate([np.asarray(req.tokens, np.int32),
                                         np.asarray(emitted, np.int32)])
            req.limit -= len(emitted)
        if self.kv_swap is not None and self._config.kv_swap_preempt and seq.blocks:
            # committed watermark: pages cover the first w tokens of the
            # folded stream (the newest emitted token is not in KV yet)
            w = int(slots.committed_h[slots.slot_of_uid[uid]])
            n = self.kv.blocks_for(w)
            if 0 < w <= len(req.tokens) and n <= len(seq.blocks):
                try:
                    # async: the page writes ride the aio queue and commit at
                    # the next boundary's drain; the device read is done, so
                    # freeing the blocks below is safe
                    self.kv_swap.put_request(uid, w, self.kv, seq.blocks[:n],
                                             draft_kv=self.draft_kv,
                                             fingerprint=token_fingerprint(req.tokens[:w]),
                                             async_commit=self._config.kv_swap_async)
                    self.telemetry.on_kv_swap_out(n, uid=uid)
                except OSError as e:
                    self._fault_event("swap_failed", boundary,
                                      f"uid={uid}: page swap-out failed "
                                      f"({type(e).__name__}: {e}); victim will re-prefill")
        slots.evict(uid)
        seq.resume_cached = 0           # the mapped pages are going away
        seq.hier_probed = False         # re-admission probes the cache anew
        if seq.blocks:
            self.kv.allocator.free(seq.blocks)
            seq.blocks = []
        sched.requeue_front(req)
        self.telemetry.on_preempt(uid, req.tenant, PRIORITY_NAMES[req.priority])

    def _serve_loop_sched(self, slots, arrivals, sched, steps, max_new_tokens,
                          temperature, eos_token_id, adaptive, draft):
        """The scheduler-driven twin of ``_serve_loop``: the same frames and
        retirement, with enqueue and admission through the
        ``RequestScheduler``, an SLO control pass, preemption and
        pressure-capped frame lengths at each boundary."""
        tel = self.telemetry
        ewma = 0.0
        exhausted = False
        boundary = -1
        while True:
            boundary += 1
            self._drain_swap_boundary(boundary)
            batch, exhausted, ewma = self._poll(arrivals, exhausted, ewma)
            for item in (batch or []):
                uid, toks, limit, temp, eos, tenant, prio, slo_ms = self._norm_arrival(
                    item, max_new_tokens, temperature, eos_token_id)
                limit = self._validate_arrival(
                    uid, toks, limit,
                    in_flight=uid in slots.slot_of_uid or sched.is_queued(uid))
                prio = normalize_priority(prio)
                tenant = tenant or "default"
                self._ledger_add(uid, toks, limit, temp, eos, tenant=tenant,
                                 priority=PRIORITY_NAMES[prio], slo_ms=slo_ms)
                self._enqueue_traced(uid, tenant=tenant, pclass=PRIORITY_NAMES[prio])
                shed = sched.submit(Request(uid=uid, tokens=toks, limit=limit, temp=temp,
                                            eos=eos, tenant=tenant, priority=prio,
                                            slo_ms=slo_ms))
                if shed is not None:
                    tel.on_shed(uid, shed.tenant, shed.priority, shed.reason)
                    self._ledger.pop(uid, None)
            # ---- SLO control pass: age queues, recompute pressure, shed
            # best-effort work under critical pressure ----
            for shed in sched.on_boundary(tel.slo_view(), live_count=slots.live_count()):
                tel.on_shed(shed.uid, shed.tenant, shed.priority, shed.reason)
                # a shed request may hold a blockless descriptor left by a
                # failed capacity probe: drop it (and any swap record)
                self.state.flush_sequence(shed.uid)
                self._ledger.pop(shed.uid, None)
                self._drop_swap(shed.uid)
            tel.gauges["slo_risk"] = round(sched.risk, 4)
            # ---- preemption: make room for a queued interactive arrival
            # by evicting a lower-priority live row ----
            if sched.preempt_wanted(slots.free_slots()):
                committed = {u: int(slots.committed_h[s]) for u, s in slots.slot_of_uid.items()}
                for uid in sched.pick_victims(committed, free_blocks=self.kv.free_blocks):
                    self._evict_to_queue(uid, slots, sched, boundary)
            # ---- policy admission (strict priority + fair share) ----
            blocks_before = self.kv.free_blocks

            def try_reserve(req):
                seq = self.state.get_or_create_sequence(req.uid)
                cached0 = self._admit_capacity(req.uid, seq, req.tokens, req.limit, boundary)
                return None if cached0 is None else (seq, cached0)

            admits = []
            for req, (seq, cached0) in sched.pick(slots.free_slots(), try_reserve,
                                                  live_count=slots.live_count()):
                seq.done = False
                req.gen_base = len(seq.generated)
                admits.append((req.uid, seq, req.tokens, req.limit, req.temp, req.eos,
                               cached0))
                tel.on_admit(req.uid)
            if sched.queued_count():
                tel.on_defer(queue_depth=sched.queued_count(),
                             frame_steps=tel.serve_view["frame_steps_last"] or steps,
                             free_slots=slots.free_slots() - len(admits),
                             free_blocks=self.kv.free_blocks,
                             reserved_blocks=blocks_before - self.kv.free_blocks)
            if admits:
                slots.ensure_widths(max(len(a[2]) for a in admits),
                                    max(len(a[1].blocks) for a in admits),
                                    self.max_seq_len, self.max_blocks_per_seq)
                slots.admit(admits)
            if slots.live_count() == 0:
                if exhausted and not sched.queued_count():
                    return
                continue
            width, cur_steps = self._plan_frame(slots, steps, adaptive, ewma,
                                                cap=sched.frame_steps_cap(steps))
            toks, emit, nonfinite = self._run_frame(slots, width, cur_steps, ewma,
                                                    sched.queued_count(), draft)
            self._quarantine_rows(slots, nonfinite, boundary, sched=sched)
            for uid in self._absorb(slots, toks, emit, width):
                yield uid, self._retire(slots, uid, sched)


def _is_quantized(tree) -> bool:
    """Whether the tree holds a quantized ({"q", "s"}) leaf."""
    return any(isinstance(v, dict) and ("q" in v or _is_quantized(v)) for v in tree.values())


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
