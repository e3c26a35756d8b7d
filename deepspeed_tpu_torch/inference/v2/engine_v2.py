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
request ledger (``faults.LedgerEntry``). Serving resilience (``faults.py``):
every frame is dispatched under bounded retry with backoff and the
``watchdog_frame_ms`` watchdog (``_run_frame_resilient``); a frame that
cannot be dispatched surfaces as ``faults.FrameDispatchError`` with
``last_crash_snapshot`` set, and ``serve(resume_from=)`` re-admits its
requests. Rows whose logits go non-finite are quarantined, or under
``nonfinite_policy="repair"`` rolled back in the frame and escalated after
``nonfinite_repair_limit`` consecutive boundaries; arrivals may carry
``deadline_ms`` or ``generated`` (a resume); ``cancel_request`` and
``snapshot_serving_state`` work at frame boundaries; ``serve(faults=)``
takes a ``faults.FaultInjector``. Abnormal retirements land in
``fault_log`` as ``faults.FaultReason``. ``serve(scheduler=)`` runs the
SLO-aware ``scheduler.RequestScheduler`` (priorities with aging, tenant
fair share and quotas, shedding and deferral, frame-boundary preemption)
on dict arrivals carrying ``tenant`` / ``priority`` / ``slo_ms``. The KV
hierarchy (``kv_hierarchy.py``): ``prefix_cache=True`` maps published
prefix blocks read-only into a new row's block table (copy-on-write at a
mid-block divergence) and starts its prefill at the watermark;
``kv_swap_dir=`` (or ``attach_kv_tier``) swaps a preempted row's pages to
host files through the port's aio engine and back at re-admission.

Where JAX retries a frame from its intact donated carry, the port's frame
updates its static buffers and pools in place from its first step on: it
retries only a failure raised before that step, and a later one goes
straight to the crash path (ROADMAP.md section C, deliberate divergences).

Tensor-parallel serving (``tp > 1``; ``tp.py``): one process a card, each
running this engine over its shard of the weights and its kv heads' pools
(SPMD), in a process group of ``tp`` ranks joined with
``comm.init_distributed``; the runner's forward issues the collectives, and
the ranks' host state stays identical, so they return the same tokens.
Boundary decisions that read the wall clock (deadlines, the watchdog, the
scheduler's SLO view) are rank 0's, broadcast (``TPContext.agree``). tp = 1
never touches a collective.

``RaggedInferenceEngineConfig`` keeps every field and default of the JAX
config. What is not ported yet raises ``NotImplementedError`` citing its
ROADMAP.md item: the swap tier under tp > 1 (item 11), and roles other than
"unified", ``serve(yield_boundaries=True)`` and arrivals carrying a
``trace`` (item 12).
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
from ...parallel.sharding import is_shard_tree
from ..sampling import sample_logits
from .faults import FaultReason, FrameDispatchError, LedgerEntry, snapshot_ledger
from .kv_cache import BlockedKVCache
from .kv_hierarchy import KVSwapTier, PrefixCache, token_fingerprint
from .model_implementations.quantize import quantize_params
from .model_runner import PagedModelRunner
from .ragged_manager import DeviceSlotTable, DSStateManager
from .scheduler import PRIORITY_NAMES, Request, normalize_priority
from .telemetry import STAT_NAMES, ServingTelemetry
from .tp import build_tp_context, local_device

logger = logging.getLogger(__name__)

_ROADMAP = "not ported to deepspeed_tpu_torch yet (ROADMAP.md, section A)"
_TP_SWAP = ("the KV swap tier under tensor parallelism (tp > 1) is not ported yet: a tier "
            "record holds every kv head, a rank holds KVH / tp (ROADMAP.md section A, "
            "item 11)")
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
    """JAX's checks of the quantized-serving and non-finite fields, with its
    messages, then the fields of paths not ported yet."""
    if c.weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype={c.weight_dtype!r}: expected None or 'int8'")
    if c.kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype={c.kv_dtype!r}: expected None or 'int8'")
    if c.tp_collective_payload not in ("int8", "fp8"):
        raise ValueError(f"tp_collective_payload={c.tp_collective_payload!r}: "
                         "expected 'int8' or 'fp8'")
    if c.nonfinite_policy not in ("quarantine", "repair"):
        raise ValueError(f"nonfinite_policy={c.nonfinite_policy!r}: expected "
                         "'quarantine' or 'repair'")
    if c.nonfinite_repair_limit < 1:
        raise ValueError("nonfinite_repair_limit must be >= 1")
    if c.role != "unified":
        raise NotImplementedError(f"RaggedInferenceEngineConfig.role={c.role!r}: {_ROADMAP}")
    if c.tp > 1 and c.kv_swap_dir:
        raise NotImplementedError(f"RaggedInferenceEngineConfig.kv_swap_dir with tp={c.tp}: "
                                  f"{_TP_SWAP}")


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
        (``attach_draft``).

        With ``config.tp > 1`` the process is one rank of a tp group (the
        world joined with ``comm.init_distributed``, of exactly ``tp``
        ranks), and the engine runs on the card of its local rank unless
        ``device`` is given. ``params`` is then the full tree, whose shard
        this rank keeps (cut from it; int8 weights are quantized whole
        first, so each shard keeps the scales of the whole weight), or this
        rank's shard already (float leaves at their shard's shapes, e.g.
        from ``tp.init_params_shard``). Random weights when omitted are the
        full seed-0 tree's shard."""
        self._config = config or RaggedInferenceEngineConfig()
        c = self._config
        _check_config(c)
        self.model = model if isinstance(model, CausalLM) else build_model(model)
        if self.model.cfg.dtype != c.dtype:
            self.model.cfg = self.model.cfg.replace(dtype=c.dtype)
        cfg = self.model.cfg
        # tensor-parallel serving context (tp.TPContext), None at tp = 1
        self.tp_ctx = build_tp_context(self.model, c.tp, quantized=c.tp_quantized_collectives,
                                       overlap=c.tp_overlap_collectives,
                                       payload=c.tp_collective_payload)
        self.device = (local_device(device) if self.tp_ctx is not None
                       else get_device(device))
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.params, self.tp_ctx = self._serving_params(self.model, params, self.tp_ctx, seed=0)

        bs = c.kv_block_size
        max_blocks_per_seq = (self.max_seq_len + bs - 1) // bs
        exp_ctx = min(c.expected_context or self.max_seq_len, self.max_seq_len)
        per_seq = (exp_ctx + 1 + bs - 1) // bs      # +1 lookahead slot
        conc = min(c.expected_concurrency or c.max_ragged_batch_size,
                   c.max_ragged_batch_size)
        num_blocks = c.num_kv_blocks or (conc * per_seq + 1)
        # under tp each rank's pools hold its KVH / tp kv heads
        self.kv = BlockedKVCache(cfg.num_layers, self._local_kv_heads(cfg), cfg.dims_per_head,
                                 num_blocks=num_blocks, block_size=bs,
                                 dtype=cfg.act_dtype, device=self.device,
                                 kv_dtype=c.kv_dtype)
        # block 0 is the trash block for padded writes: never allocate it
        self.kv.reserve_trash_block()
        self.state = DSStateManager(self.kv, c.max_tracked_sequences)
        self.runner = PagedModelRunner(self.model, bs, max_blocks_per_seq, self.device,
                                       cuda_graphs=cuda_graphs)
        if self.tp_ctx is not None:
            self.runner.set_tp(self.tp_ctx)
            self.tp_ctx.warm_up(self.device)
            logger.info(f"InferenceEngineV2: tensor-parallel serving tp={c.tp} rank "
                        f"{self.tp_ctx.rank} (vocab_sharded={self.tp_ctx.vocab_sharded} "
                        f"quantized={c.tp_quantized_collectives} "
                        f"overlap={c.tp_overlap_collectives})")
        self.max_blocks_per_seq = max_blocks_per_seq
        # host stream the per-serve frame generators are seeded from
        self._rng = torch.Generator().manual_seed(0)
        # the sampled tokens of step(), generate() and generate_compiled()
        self._sample_rng = torch.Generator(device=self.device).manual_seed(0)
        # abnormal retirements and absorbed fault events, newest last; the
        # ledger snapshot taken when a frame dispatch fails for good
        # (serve(resume_from=) consumes it)
        self.fault_log: collections.deque = collections.deque(maxlen=c.fault_log_max)
        self.last_crash_snapshot: Optional[Dict] = None
        # uids of the current serve()'s resume not yet re-admitted
        self._resume_pending: set = set()
        # "repair" runs the rollback steps; the host counts consecutive
        # latched boundaries per row to escalate a persistent fault
        self._nonfinite_repair = c.nonfinite_policy == "repair"
        self._repair_counts: Dict[int, int] = {}
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

    def _local_kv_heads(self, cfg) -> int:
        """The kv heads this rank's pools hold: KVH / tp."""
        return cfg.kv_heads if self.tp_ctx is None else self.tp_ctx.kv_heads(cfg.kv_heads)

    def _serving_params(self, model, params, ctx, seed: int, inplace: bool = True):
        """The params this rank serves for ``model``: ``params`` on the
        engine's device (random from ``seed`` when None), int8 under
        ``weight_dtype`` (``inplace``: the tree's own leaves are replaced)
        and, under the tp context ``ctx``, this rank's shard. The full tree
        is quantized with its spec tree before the cut (JAX
        ``_init_tensor_parallel``), so a float tree already cut to shards
        cannot take int8 weights, and a quantized tree must come whole."""
        c = self._config
        cfg = model.cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            tree = model.init(gen, device=self.device, dtype=cfg.act_dtype)
        else:
            tree = _to_device(params, self.device)
        if ctx is None:
            if c.weight_dtype and not _is_quantized(tree):
                tree, _ = quantize_params(tree, model.logical_axes(),
                                          weight_dtype=c.weight_dtype, inplace=inplace)
            return tree, None
        full = model.abstract_params()
        specs = ctx.param_specs
        if c.weight_dtype:
            if _is_quantized(tree) or is_shard_tree(tree, specs, full):
                raise ValueError("tensor-parallel int8 weights are quantized from the full "
                                 "float params (each shard keeps the scales of the whole "
                                 "weight): pass the full float tree")
            tree, specs = quantize_params(tree, model.logical_axes(), specs,
                                          weight_dtype=c.weight_dtype, inplace=inplace)
            ctx = dataclasses.replace(ctx, param_specs=specs)
        return ctx.shard_params(tree, full), ctx

    def attach_draft(self, draft_model, draft_params=None) -> None:
        """Attach a small draft model for speculative decoding (JAX
        ``attach_draft``). ``draft_model``: a port
        ``CausalLM``, a preset name or a config. The draft gets its OWN
        paged pools with the target's block count, block size and
        ``kv_dtype``, addressed by the SAME per-slot block tables, so
        admission reserves blocks once for both. ``draft_params=None`` draws
        fresh weights from seed 1; pass the target's params for a self-draft
        (the 100 %-acceptance bound). The draft is quantized under the
        target's ``weight_dtype``. A re-attach drops the speculative graphs
        captured over the previous draft. Under tp the draft rides the
        target's process group: validated with ``role="draft"``, its params
        cut by its own specs, its pools holding this rank's kv heads."""
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
        dctx = None
        if self.tp_ctx is not None:
            dctx = build_tp_context(self.draft_model, c.tp, quantized=c.tp_quantized_collectives,
                                    overlap=c.tp_overlap_collectives,
                                    payload=c.tp_collective_payload, role="draft",
                                    group=self.tp_ctx.group)
        # a self-draft shares the target's float leaves: quantize a copy of
        # the tree, never the caller's
        self.draft_params, dctx = self._serving_params(self.draft_model, converted, dctx, seed=1,
                                                       inplace=converted is None)
        self.draft_kv = BlockedKVCache(dcfg.num_layers, self._local_kv_heads(dcfg),
                                       dcfg.dims_per_head,
                                       num_blocks=self.kv.num_blocks,
                                       block_size=c.kv_block_size, dtype=dcfg.act_dtype,
                                       device=self.device, kv_dtype=c.kv_dtype)
        # the draft's forward runs inside the target runner's programs; its
        # own runner captures nothing
        self.draft_runner = PagedModelRunner(self.draft_model, c.kv_block_size,
                                             self.max_blocks_per_seq, self.device,
                                             cuda_graphs=False)
        if dctx is not None:
            self.draft_runner.set_tp(dctx)
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
        if self.tp_ctx is not None:
            raise NotImplementedError(f"attach_kv_tier with tp={self._config.tp}: {_TP_SWAP}")
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
        """Cancel an accepted, in-flight request (JAX ``cancel_request``):
        mark its ledger entry cancelled and expire its deadline, so the next
        frame boundary's deadline pass cancels it wherever it sits (popped
        from the queue, or evicted from its slot with its KV blocks freed)
        and retires it with a ``cancelled`` FaultReason. It writes two
        fields of an existing entry, so it may be called from another
        thread while a serve generator runs. False when ``uid`` is not in
        flight."""
        ent = self._ledger.get(uid)
        if ent is None:
            return False
        ent.cancelled = True
        ent.deadline_at = self._clock()
        return True

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
        tenant, priority, slo_ms, deadline_ms, generated)`` (JAX
        ``_norm_arrival`` without ``trace``).

        Tuple form: ``(uid, tokens[, max_new_tokens[, temperature[,
        eos_id]]])``; None in an optional field means the serve() default
        (eos_id=-1 disables EOS for one row). Tuples carry no scheduling
        metadata. Dict form: ``{"uid", "tokens"}`` plus optional
        ``max_new_tokens`` / ``temperature`` / ``eos_token_id``, the
        scheduling fields ``tenant`` (str), ``priority`` ("interactive" |
        "batch" | "best_effort" or 0..2) and ``slo_ms`` (a per-request TTFT
        target), which are inert without a ``scheduler=``, ``deadline_ms``
        (a budget from enqueue, > 0: past it the request is cancelled at the
        next frame boundary, queued or live) and ``generated`` (a resume
        arrival, ``faults.snapshot_split``'s form: ``tokens`` is the
        original prompt, ``generated`` the tokens already committed,
        ``max_new_tokens`` the original budget). A dict carrying ``trace``
        raises: distributed tracing is not ported yet."""
        if isinstance(item, dict):
            if item.get("trace") is not None:
                raise NotImplementedError(f"arrival field 'trace': {_TRACING}")
            uid, toks = item["uid"], item["tokens"]
            limit = item.get("max_new_tokens")
            limit = max_new_tokens if limit is None else limit
            temp = item.get("temperature")
            temp = temperature if temp is None else temp
            eos = item.get("eos_token_id")
            eos = eos_token_id if eos is None else eos
            tenant, prio, slo_ms = item.get("tenant"), item.get("priority"), item.get("slo_ms")
            deadline_ms = item.get("deadline_ms")
            if deadline_ms is not None and deadline_ms <= 0:
                raise ValueError(f"uid={uid}: deadline_ms must be > 0")
            generated = item.get("generated")
            if generated is not None:
                generated = [int(t) for t in generated]
                if len(generated) > int(limit):
                    raise ValueError(
                        f"uid={uid}: resume arrival carries {len(generated)} committed "
                        f"tokens beyond its budget of {limit}")
        else:
            uid, toks = item[0], item[1]
            limit = item[2] if len(item) > 2 and item[2] is not None else max_new_tokens
            temp = item[3] if len(item) > 3 and item[3] is not None else temperature
            eos = item[4] if len(item) > 4 and item[4] is not None else eos_token_id
            tenant = prio = slo_ms = deadline_ms = generated = None
        return (uid, np.asarray(toks, np.int32).reshape(-1), int(limit), float(temp), eos,
                tenant, prio, slo_ms, deadline_ms, generated)

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

        Fault tolerance (``faults.py``): every frame runs under bounded
        retry with backoff and the watchdog; non-finite rows are quarantined
        (or repaired, ``nonfinite_policy="repair"``) while their siblings
        decode on; ``deadline_ms`` and ``cancel_request`` act at frame
        boundaries on queued and live rows; a fatal dispatch failure leaves
        ``last_crash_snapshot``, and ``resume_from=`` (that or a
        ``snapshot_serving_state()``) re-admits every in-flight request by
        re-prefilling prompt + committed tokens: greedy outputs are
        token-identical across the restart. ``faults=`` takes a
        ``faults.FaultInjector`` whose schedule drives these paths.
        """
        if yield_boundaries:
            raise NotImplementedError(f"serve(yield_boundaries=...): {_ROADMAP}")
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
                                table_width=1, rng=frame_rng, device=self.device, tp=self.tp_ctx,
                                debug_replicas=c.tp_debug_replica_check)
        if faults is not None:
            faults.begin_serve()         # rearm the scripted schedule
        self.serve_counters = dict.fromkeys(STAT_NAMES, 0)
        if self.prefix_cache is not None:
            # telemetry counters restart per serve run: rebase the cache's
            # cumulative bookkeeping
            self._pc_stats_base = dict(self.prefix_cache.stats)
        resume = self._resume_entries(resume_from)
        if self.kv_swap is not None:
            # request records exist solely for re-admission: a run that will
            # not resume a uid has abandoned its pages (a shared tier never
            # prunes)
            self.kv_swap.prune_requests({r[0] for r in resume})
            self._tier_stats_base = dict(self.kv_swap.stats)
        self._ledger = {}
        self._resume_pending = {r[0] for r in resume}
        self._repair_counts = {}
        self.telemetry.begin_serve(speculate=speculate, gamma=gamma, adaptive=adaptive,
                                   n_slots=n_slots, kv_blocks_total=self.kv.num_blocks,
                                   tp_degree=c.tp, kv_block_bytes=self.kv.block_bytes)
        draft = ((self.draft_runner, self.draft_params, self.draft_kv, gamma)
                 if speculate else None)
        arrivals = iter(arrivals)
        loop = (steps, max_new_tokens, temperature, eos_token_id, adaptive, draft, faults,
                resume)
        if scheduler is not None:
            scheduler.begin_serve(self)
            return self._serve_guarded_sched(slots, arrivals, scheduler, *loop)
        return self._serve_guarded(slots, arrivals, *loop)

    def _release_all(self, slots, queued_uids) -> None:
        """Abandonment (break / close() / error) must not strand state:
        release every slot-held, queued and ledgered sequence. The ledger
        also covers a preempted row caught between eviction and
        re-admission."""
        for uid in list(slots.slot_of_uid) + list(queued_uids) + list(self._ledger):
            self.state.flush_sequence(uid)
        self._ledger.clear()

    def _serve_guarded(self, slots, arrivals, *loop):
        pending = collections.deque()
        try:
            yield from self._serve_loop(slots, arrivals, pending, *loop)
        finally:
            self._release_all(slots, [item[0] for item in pending])

    def _serve_guarded_sched(self, slots, arrivals, sched, *loop):
        try:
            yield from self._serve_loop_sched(slots, arrivals, sched, *loop)
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
    # telemetry, the request ledger, fault records and resilient dispatch
    # (faults.py)
    # ------------------------------------------------------------------

    def _run_frame(self, slots, width, cur_steps, ewma, queue_depth, draft, faults,
                   frame: int):
        """Dispatch one frame under the resilience policy and absorb its
        counters (JAX's frame call and ``_sync_frame_stats``): the in-frame
        stat vector comes back in the frame's one device-to-host copy, so
        each boundary holds exactly this frame's counts.
        ``recompiled_programs`` is the runner's count of CUDA-graph captures
        (0 where nothing is captured). Returns (tokens, emit, the
        finite-check latch)."""
        tel = self.telemetry
        with tel.frame_trace(width, cur_steps):
            toks, emit, nonfinite, stats = self._run_frame_resilient(
                slots, width, cur_steps, slots.all_greedy(), draft, faults, frame)
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

    def _run_frame_resilient(self, slots, width, cur_steps, greedy, draft, faults,
                             frame: int):
        """Dispatch one frame (JAX ``_run_frame_resilient``): the injector's
        hooks, bounded retry with exponential backoff, the wall-clock
        watchdog and, when the frame cannot be dispatched, a ledger snapshot
        (``last_crash_snapshot``) before ``FrameDispatchError`` surfaces.

        A failure is retried only when no step of the frame began
        (``runner.steps_begun``): every step updates the slot state and the
        pools in place, and ``absorb`` has not run, so a retry after one
        would advance them twice. A later failure goes straight to the crash
        path. The snapshot reads host state only, which is the last
        boundary's. A retry re-runs the same call: nothing falls back to
        eager steps. The watchdog window opens before the injection hook
        (an injected stall is a slow dispatch) and closes after the frame's
        device-to-host copy, since replays are asynchronous."""
        c = self._config
        attempt = 0
        while True:
            begun = self.runner.steps_begun
            try:
                t0 = self._clock()
                if faults is not None:
                    faults.before_dispatch(frame, attempt)
                out = slots.run_frame(self.runner, self.params, self.kv, width, cur_steps,
                                      greedy, draft=draft, repair=self._nonfinite_repair)
                dt_ms = (self._clock() - t0) * 1e3
                if c.watchdog_frame_ms is not None:
                    dt_ms = self._agree(dt_ms)      # rank 0's reading, every rank's
                if c.watchdog_frame_ms is not None and dt_ms > c.watchdog_frame_ms:
                    self._fault_event(
                        "slow_frame", frame,
                        f"frame took {dt_ms:.1f} ms > watchdog {c.watchdog_frame_ms} ms "
                        f"(width={width} steps={cur_steps})")
                return out
            except Exception as e:        # noqa: BLE001 (bounded, re-raised)
                attempt += 1
                stepped = self.runner.steps_begun != begun
                if stepped or attempt > c.max_frame_retries:
                    self.last_crash_snapshot = self.snapshot_serving_state()
                    why = ("after its first step changed the slot state; not retried"
                           if stepped else f"after {attempt} attempts")
                    self._fault_event("dispatch_failed", frame,
                                      f"{type(e).__name__}: {e} ({why})")
                    raise FrameDispatchError(
                        f"frame {frame} dispatch failed {why} ({type(e).__name__}: {e}); "
                        "engine.last_crash_snapshot holds the request ledger — "
                        "serve(resume_from=...) resumes the in-flight requests") from e
                self._fault_event(
                    "dispatch_retry", frame,
                    f"{type(e).__name__}: {e} (attempt {attempt}/"
                    f"{c.max_frame_retries}, retrying)")
                backoff = c.frame_retry_backoff_s * (2 ** (attempt - 1))
                if backoff > 0:
                    time.sleep(backoff)

    def _any_deadline_armed(self) -> bool:
        """Under tp, whether some rank's ledger holds a deadline, by a one-int
        all-reduce: the deadline pass broadcasts rank 0's verdicts only then.
        Arrivals reach every rank alike, but ``cancel_request``, called from
        another thread, can reach the ranks at different boundaries, so a
        rank cannot tell from its own ledger alone."""
        armed = any(ent.deadline_at is not None for ent in self._ledger.values())
        return self.tp_ctx.any_rank(armed, self.device)

    def _agree(self, obj):
        """Rank 0's value of a host decision that reads the clock, on every
        tp rank (a decision taken on one rank only would send the ranks into
        different collectives); ``obj`` itself at tp = 1."""
        return obj if self.tp_ctx is None else self.tp_ctx.agree(obj)

    def snapshot_serving_state(self) -> Dict:
        """The host-side request ledger of the current (or last) serve run
        as a plain-python dict (JAX ``snapshot_serving_state``): every
        accepted, not-yet-retired request's original prompt, committed
        tokens, remaining budget and deadline, and scheduling metadata. No
        device read. ``serve(..., resume_from=)`` on a restarted engine (of
        either package) re-prefills prompt + committed tokens, so greedy
        outputs are token-identical across the restart; sampled rows resume
        correctly but not bit-identically (the frame generator restarts)."""
        return snapshot_ledger(self._ledger, self.state.seqs, self._clock,
                               swap_tier=self.kv_swap)

    def _ledger_add(self, uid, toks, limit, temp, eos, deadline_ms=None, tenant=None,
                    priority=None, slo_ms=None, resumed_from=0) -> None:
        self._ledger[uid] = LedgerEntry(
            uid=uid, prompt=[int(t) for t in toks], limit=int(limit), temp=float(temp),
            eos=eos,
            deadline_at=None if deadline_ms is None else self._clock() + deadline_ms * 1e-3,
            tenant=tenant, priority=priority, slo_ms=slo_ms, resumed_from=resumed_from)

    def _enqueue_traced(self, uid, **kw) -> None:
        """``telemetry.on_enqueue``, writing back into the ledger entry the
        trace context it returns (JAX ``_enqueue_traced``; without a tracer
        it is None)."""
        trace = self.telemetry.on_enqueue(uid, **kw)
        ent = self._ledger.get(uid)
        if ent is not None and trace is not None:
            ent.trace = trace

    def _ingest_resume(self, uid, toks, limit, gen):
        """Mid-run resume arrival (JAX ``_ingest_resume``), for both serve
        loops: rebuild the host sequence with the committed tokens, then
        either retire at once (already at its budget: returns ``(None,
        output)``, the ledger entry dropped) or return ``((folded prompt,
        remaining budget), None)`` for re-prefill."""
        seq = self.state.get_or_create_sequence(uid)
        seq.generated = list(gen)
        seq.done = False
        remaining = limit - len(gen)
        if remaining <= 0:
            out = np.asarray(seq.generated, np.int64)
            self.state.flush_sequence(uid)
            self._ledger.pop(uid, None)
            self.telemetry.on_retire(uid)
            return None, out
        folded = np.concatenate([toks, np.asarray(gen, np.int32)]) if gen else toks
        return (folded, remaining), None

    def _resume_entries(self, resume_from) -> List[Tuple]:
        """A ``snapshot_serving_state()`` dict as resume tuples (uid, prompt,
        limit, temp, eos, deadline_remaining_ms, generated, tenant,
        priority, slo_ms), checked at the serve() call. A snapshot request
        carrying a ``trace`` raises: distributed tracing is not ported."""
        if resume_from is None:
            return []
        if resume_from.get("version") != 1:
            raise ValueError("resume_from: unrecognized snapshot "
                             f"version {resume_from.get('version')!r}")
        out = []
        for r in resume_from.get("requests", []):
            uid = int(r["uid"])
            if uid in self.state.seqs:
                raise ValueError(f"resume_from: uid={uid} is already tracked by the "
                                 "engine — flush it before resuming")
            if r.get("trace") is not None:
                raise NotImplementedError(f"resume_from: uid={uid} carries a trace: "
                                          f"{_TRACING}")
            out.append((uid, np.asarray(r["prompt"], np.int32), int(r["limit"]),
                        float(r["temp"]), r["eos"], r.get("deadline_remaining_ms"),
                        [int(t) for t in r.get("generated", [])], r.get("tenant"),
                        r.get("priority"), r.get("slo_ms")))
        return out

    def _note_resume_truncated(self, uid, want, limit, frame: int) -> None:
        """A resume landed on an engine whose ``max_seq_len`` cannot hold the
        original budget: the clamp breaks token identity with the
        no-failure run, so it is recorded as a ``resume_truncated`` fault;
        the request still serves what fits."""
        self.fault_log.append(FaultReason(
            uid=uid, kind="resume_truncated", frame=frame,
            detail=f"resume budget clamped {want}->{limit} by "
                   f"max_seq_len={self.max_seq_len}; output will be "
                   "shorter than the no-failure run"))
        self.telemetry.on_fault("resume_truncated", uid=uid)

    def _note_recovery_progress(self, slots, resume_t0: float, n_resumed: int) -> None:
        """Once every resumed request has left the queue (admitted, or
        handled for good), count the recoveries and stamp
        ``last_recovery_ms``: how long the crashed run's clients waited on
        the restarted engine before decoding resumed."""
        if not self._resume_pending:
            return
        self._resume_pending = {u for u in self._resume_pending
                                if u in self._ledger and u not in slots.slot_of_uid}
        if not self._resume_pending:
            self.telemetry.on_recover(n_resumed, (self._clock() - resume_t0) * 1e3)

    def _fault_event(self, kind: str, frame: int, detail: str) -> None:
        """Frame-level fault event (no single victim request): retries, slow
        frames, allocation failures, crashes, swap tier failures."""
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

    def _expire_deadlines(self, slots, frame: int, pending=None, sched=None) -> None:
        """Frame-boundary deadline pass over queued and live rows (JAX
        ``_expire_deadlines``): an expired or cancelled request is dropped
        wherever it sits (the FIFO deque or the scheduler's queue, before it
        can be admitted, aged or preempted for; or its live slot), its KV
        blocks freed, and retired with a ``deadline_expired`` or
        ``cancelled`` fault."""
        now = self._clock()
        expired = [(uid, ent.cancelled) for uid, ent in self._ledger.items()
                   if ent.deadline_at is not None and now >= ent.deadline_at]
        if self.tp_ctx is not None:
            # rank 0's verdicts, so every rank evicts the same rows
            expired = self.tp_ctx.agree(expired) if self._any_deadline_armed() else []
        for uid, cancelled in expired:
            seq = self.state.seqs.get(uid)
            partial = list(seq.generated) if seq is not None else []
            if uid in slots.slot_of_uid:
                slots.evict(uid)
                if sched is not None:
                    sched.on_retire(uid)
                where = f"live row ({len(partial)} tokens committed)"
            else:
                if sched is not None:
                    sched.cancel(uid)
                elif pending is not None:
                    for item in pending:
                        if item[0] == uid:
                            pending.remove(item)
                            break
                where = "queued (never admitted)"
            self.state.flush_sequence(uid)       # frees any KV blocks
            if cancelled:
                self._fault_retire(uid, "cancelled", frame,
                                   f"cancel_request() while {where}", partial=partial)
            else:
                self._fault_retire(uid, "deadline_expired", frame,
                                   f"deadline_ms elapsed while {where}", partial=partial)

    def _quarantine_rows(self, uids, slots, frame: int, sched=None,
                         escalated: bool = False) -> None:
        """Quarantine rows whose logits went non-finite: evict, free their
        blocks, drop what they published to the prefix cache (a poisoned
        page must never reach a healthy request) and retire them with a
        ``poison_row`` fault; the batch never dies for one row."""
        detail = (f"non-finite logits persisted past nonfinite_repair_limit="
                  f"{self._config.nonfinite_repair_limit} boundaries; row quarantined, "
                  "siblings unaffected") if escalated else (
            "non-finite logits (in-frame finite check); row quarantined, siblings "
            "unaffected")
        for uid in uids:
            seq = self.state.seqs.get(uid)
            partial = list(seq.generated) if seq is not None else []
            slots.evict(uid)
            if sched is not None:
                sched.on_retire(uid)
            if self.prefix_cache is not None:
                self.prefix_cache.invalidate_uid(uid)
            self.state.flush_sequence(uid)
            self._repair_counts.pop(uid, None)
            self._fault_retire(uid, "poison_row", frame, detail, partial=partial)

    def _handle_nonfinite(self, slots, flags, frame: int, sched=None) -> List[int]:
        """The boundary's verdict on rows whose finite-check latch tripped
        (``flags``, from the frame's one copy; JAX ``_handle_nonfinite``).
        Under "quarantine" each is retired. Under "repair" the frame already
        rolled each back to its pre-step carry: a row gets another chance
        (latch and poison cleared in one batched write) until it has latched
        ``nonfinite_repair_limit`` consecutive boundaries, then it is
        quarantined. Returns the repaired uids, whose watermark mirrors the
        caller resyncs after the host replay. Repaired rows keep their
        published prefix blocks: the finite check gates the watermark."""
        flagged = slots.nonfinite_uids(flags)
        if not self._nonfinite_repair:
            if flagged:
                self._quarantine_rows(flagged, slots, frame, sched=sched)
            return []
        # a clean boundary resets a row's count of consecutive blips
        for uid in [u for u in self._repair_counts if u not in flagged]:
            self._repair_counts.pop(uid)
        repaired, doomed = [], []
        for uid in flagged:
            n = self._repair_counts.get(uid, 0) + 1
            if n > self._config.nonfinite_repair_limit:
                doomed.append(uid)
            else:
                self._repair_counts[uid] = n
                repaired.append(uid)
        if doomed:
            self._quarantine_rows(doomed, slots, frame, sched=sched, escalated=True)
        if repaired:
            slots.clear_nonfinite(repaired)
            for uid in repaired:
                seq = self.state.seqs.get(uid)
                self.fault_log.append(FaultReason(
                    uid=uid, kind="nonfinite_repaired", frame=frame,
                    detail=f"non-finite logits; row rolled back to its pre-fault carry "
                           f"(blip {self._repair_counts[uid]}/"
                           f"{self._config.nonfinite_repair_limit})",
                    tokens_emitted=len(seq.generated) if seq else 0))
                # no uid: the request is still in flight, its span lives on
                self.telemetry.on_fault("nonfinite_repaired")
        return repaired

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
                    self.telemetry.on_kv_swap_in(rec["blocks"],
                                                 resume=uid in self._resume_pending, uid=uid)
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

    def _absorb(self, slots, toks, emit, width, repaired=()):
        """Host replay of a frame: extend each row's tokens, advance its
        committed watermark (rejected drafts never count as seen; a
        repaired row's mirror is read back first), report the emissions;
        returns the finished uids."""
        emissions, finished = slots.absorb(toks, emit, width)
        if repaired:
            slots.resync_committed(repaired)
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

    def _dispatch(self, slots, width, cur_steps, ewma, queue_depth, draft, faults,
                  boundary, sched=None):
        """One frame and its boundary verdicts, for both loops: arm the
        scheduled poison, run the frame, then quarantine or repair the rows
        whose logits went non-finite, before the host replay (a quarantined
        row's slot is freed here, so absorb neither emits nor retires it).
        Returns the finished uids."""
        if faults is not None:
            slots.set_poison(faults.poison_uids(boundary))
        toks, emit, nonfinite = self._run_frame(slots, width, cur_steps, ewma, queue_depth,
                                                draft, faults, boundary)
        repaired = self._handle_nonfinite(slots, nonfinite, boundary, sched=sched)
        return self._absorb(slots, toks, emit, width, repaired)

    def _serve_loop(self, slots, arrivals, pending, steps, max_new_tokens,
                    temperature, eos_token_id, adaptive, draft, faults, resume):
        tel = self.telemetry
        ewma = 0.0
        exhausted = False
        boundary = -1     # frame-boundary index: fault schedules key on it
        resume_t0 = self._clock()
        n_resumed = len(resume)
        # crash-recovery ingestion: the snapshot's requests go ahead of any
        # new arrival, prompt + committed tokens folded for re-prefill
        for uid, prompt, limit, temp, eos, dl_ms, generated, *_ in resume:
            self._ledger_add(uid, prompt, limit, temp, eos, dl_ms,
                             resumed_from=len(generated))
            self._enqueue_traced(uid, resumed=len(generated) > 0)
            fold, done_out = self._ingest_resume(uid, prompt, limit, generated)
            if done_out is not None:
                yield uid, done_out       # finished before the crash could yield it
                continue
            pending.append((uid, *fold, temp, eos))
        while True:
            boundary += 1
            # commit the async swap-out writes queued at the previous boundary
            self._drain_swap_boundary(boundary)
            batch, exhausted, ewma = self._poll(arrivals, exhausted, ewma)
            # validate at enqueue, before any KV is reserved this round
            for item in (batch or []):
                uid, toks, limit, temp, eos, _, _, _, dl_ms, gen = self._norm_arrival(
                    item, max_new_tokens, temperature, eos_token_id)
                want = limit
                limit = self._validate_arrival(
                    uid, toks, limit,
                    in_flight=uid in slots.slot_of_uid or any(p[0] == uid for p in pending))
                if gen is not None:
                    # a resume arrival: the ledger keeps the originals
                    if limit < want:
                        self._note_resume_truncated(uid, want, limit, boundary)
                    self._ledger_add(uid, toks, limit, temp, eos, dl_ms,
                                     resumed_from=len(gen))
                    self._enqueue_traced(uid, resumed=len(gen) > 0)
                    fold, done_out = self._ingest_resume(uid, toks, limit, gen)
                    if done_out is not None:
                        yield uid, done_out
                        continue
                    pending.append((uid, *fold, temp, eos))
                    continue
                pending.append((uid, toks, limit, temp, eos))
                self._ledger_add(uid, toks, limit, temp, eos, dl_ms)
                self._enqueue_traced(uid)
            # deadlines: expired work, queued or live, goes before admission
            # can spend a slot or blocks on it
            self._expire_deadlines(slots, boundary, pending=pending)
            # ---- admission control (FIFO; blocks reserved up front, so
            # block tables never grow mid-flight) ----
            alloc_blocked = faults is not None and faults.kv_alloc_blocked(boundary)
            if alloc_blocked and pending:
                self._fault_event("kv_alloc_failed", boundary,
                                  "injected KV-block allocation failure; admission "
                                  "deferred this boundary")
            admits = []
            blocks_before = self.kv.free_blocks
            while pending and not alloc_blocked and len(admits) < slots.free_slots():
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
            self._note_recovery_progress(slots, resume_t0, n_resumed)
            if slots.live_count() == 0:
                if exhausted and not pending:
                    return
                continue         # arrival gap: poll again
            width, cur_steps = self._plan_frame(slots, steps, adaptive, ewma)
            for uid in self._dispatch(slots, width, cur_steps, ewma, len(pending), draft,
                                      faults, boundary):
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
                          temperature, eos_token_id, adaptive, draft, faults, resume):
        """The scheduler-driven twin of ``_serve_loop``: the same frames and
        retirement, with enqueue and admission through the
        ``RequestScheduler``, an SLO control pass, preemption and
        pressure-capped frame lengths at each boundary. Deadlines expire
        before the control pass, so expired work is never aged, preempted
        for or admitted."""
        tel = self.telemetry
        ewma = 0.0
        exhausted = False
        boundary = -1
        resume_t0 = self._clock()
        n_resumed = len(resume)
        # crash-recovery ingestion: the snapshot's requests re-enter with
        # their class, tenant and slo, tokens folded for re-prefill; the
        # submit bypasses the tenant quota (they were accepted once)
        for uid, prompt, limit, temp, eos, dl_ms, generated, tenant, prio, slo_ms in resume:
            prio = normalize_priority(prio)
            tenant = tenant or "default"
            self._ledger_add(uid, prompt, limit, temp, eos, dl_ms, tenant=tenant,
                             priority=PRIORITY_NAMES[prio], slo_ms=slo_ms,
                             resumed_from=len(generated))
            self._enqueue_traced(uid, tenant=tenant, pclass=PRIORITY_NAMES[prio],
                                 resumed=len(generated) > 0)
            fold, done_out = self._ingest_resume(uid, prompt, limit, generated)
            if done_out is not None:
                yield uid, done_out
                continue
            sched.submit(Request(uid=uid, tokens=fold[0], limit=fold[1], temp=temp, eos=eos,
                                 tenant=tenant, priority=prio, slo_ms=slo_ms,
                                 resumed_from=len(generated), resumed=True),
                         bypass_quota=True)
        while True:
            boundary += 1
            self._drain_swap_boundary(boundary)
            batch, exhausted, ewma = self._poll(arrivals, exhausted, ewma)
            for item in (batch or []):
                (uid, toks, limit, temp, eos, tenant, prio, slo_ms, dl_ms,
                 gen) = self._norm_arrival(item, max_new_tokens, temperature, eos_token_id)
                want = limit
                limit = self._validate_arrival(
                    uid, toks, limit,
                    in_flight=uid in slots.slot_of_uid or sched.is_queued(uid))
                if gen is not None and limit < want:
                    self._note_resume_truncated(uid, want, limit, boundary)
                prio = normalize_priority(prio)
                tenant = tenant or "default"
                self._ledger_add(uid, toks, limit, temp, eos, dl_ms, tenant=tenant,
                                 priority=PRIORITY_NAMES[prio], slo_ms=slo_ms,
                                 resumed_from=len(gen) if gen else 0)
                self._enqueue_traced(uid, tenant=tenant, pclass=PRIORITY_NAMES[prio],
                                     resumed=bool(gen))
                if gen is not None:
                    # a resume arrival bypasses the tenant quota: its
                    # committed tokens must not be shed at a second admission
                    fold, done_out = self._ingest_resume(uid, toks, limit, gen)
                    if done_out is not None:
                        yield uid, done_out
                        continue
                    sched.submit(Request(uid=uid, tokens=fold[0], limit=fold[1], temp=temp,
                                         eos=eos, tenant=tenant, priority=prio,
                                         slo_ms=slo_ms, resumed_from=len(gen),
                                         resumed=True),
                                 bypass_quota=True)
                    continue
                shed = sched.submit(Request(uid=uid, tokens=toks, limit=limit, temp=temp,
                                            eos=eos, tenant=tenant, priority=prio,
                                            slo_ms=slo_ms))
                if shed is not None:
                    tel.on_shed(uid, shed.tenant, shed.priority, shed.reason)
                    self._ledger.pop(uid, None)
            # ---- deadlines, then the SLO control pass: age queues,
            # recompute pressure, shed best-effort work under critical
            # pressure ----
            self._expire_deadlines(slots, boundary, sched=sched)
            # the SLO view reads the wall clock: under tp, rank 0's
            for shed in sched.on_boundary(self._agree(tel.slo_view()),
                                          live_count=slots.live_count()):
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
            alloc_blocked = faults is not None and faults.kv_alloc_blocked(boundary)
            if alloc_blocked and sched.queued_count():
                self._fault_event("kv_alloc_failed", boundary,
                                  "injected KV-block allocation failure; admission "
                                  "deferred this boundary")

            def try_reserve(req):
                seq = self.state.get_or_create_sequence(req.uid)
                cached0 = self._admit_capacity(req.uid, seq, req.tokens, req.limit, boundary)
                return None if cached0 is None else (seq, cached0)

            admits = []
            picked = [] if alloc_blocked else sched.pick(slots.free_slots(), try_reserve,
                                                         live_count=slots.live_count())
            for req, (seq, cached0) in picked:
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
            self._note_recovery_progress(slots, resume_t0, n_resumed)
            if slots.live_count() == 0:
                if exhausted and not sched.queued_count():
                    return
                continue
            width, cur_steps = self._plan_frame(slots, steps, adaptive, ewma,
                                                cap=sched.frame_steps_cap(steps))
            for uid in self._dispatch(slots, width, cur_steps, ewma, sched.queued_count(),
                                      draft, faults, boundary, sched=sched):
                yield uid, self._retire(slots, uid, sched)


def _is_quantized(tree) -> bool:
    """Whether the tree holds a quantized ({"q", "s"}) leaf."""
    return any(isinstance(v, dict) and ("q" in v or _is_quantized(v)) for v in tree.values())


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
