"""Continuous-batching inference engine (FastGen analog).

Mirrors ``deepspeed_tpu/inference/v2/engine_v2.py`` for the FIFO,
single-device, float-KV ``serve()`` path: paged KV (``kv_cache.py``),
sequence tracking (``ragged_manager.py``) and Dynamic SplitFuse frames
(``model_runner.py``). ``RaggedInferenceEngineConfig`` keeps every field and
default of the JAX config; the fields of paths not ported yet (tensor
parallelism, the KV hierarchy, quantized weights/KV, disaggregated roles,
the repair policy) raise ``NotImplementedError`` when set, as do
``serve(scheduler=, faults=, resume_from=, speculate=True,
yield_boundaries=True)`` and dict arrivals (ROADMAP.md lists them). The
telemetry, trace, retry and watchdog fields are accepted and not acted on:
``ServingTelemetry`` and the fault machinery are not ported yet.
"""

import collections
import dataclasses
import logging
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ...accelerator import get_device
from ...models.transformer import CausalLM, build_model
from .kv_cache import BlockedKVCache
from .model_runner import PagedModelRunner
from .ragged_manager import DeviceSlotTable, DSStateManager
from .telemetry import STAT_NAMES

logger = logging.getLogger(__name__)

_ROADMAP = "not ported to deepspeed_tpu_torch yet (ROADMAP.md, section A)"


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


def _check_ported(c: RaggedInferenceEngineConfig) -> None:
    unported = {
        "tp": c.tp > 1, "prefix_cache": c.prefix_cache,
        "kv_swap_dir": bool(c.kv_swap_dir), "kv_dtype": c.kv_dtype is not None,
        "weight_dtype": c.weight_dtype is not None,
        "role": c.role != "unified",
        "nonfinite_policy": c.nonfinite_policy != "quarantine",
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"RaggedInferenceEngineConfig.{name}={getattr(c, name)!r}: {_ROADMAP}")


class InferenceEngineV2:
    def __init__(self, model, config: Optional[RaggedInferenceEngineConfig] = None,
                 params=None, max_seq_len: Optional[int] = None, device=None):
        """``model``: a ``CausalLM`` (or a preset name / config for
        ``build_model``); ``params``: a params dict (random weights from
        seed 0 when omitted, stored in the serving dtype); ``device``:
        where the engine runs — the current CUDA device by default, which
        raises when there is no GPU."""
        self._config = config or RaggedInferenceEngineConfig()
        c = self._config
        _check_ported(c)
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

        bs = c.kv_block_size
        max_blocks_per_seq = (self.max_seq_len + bs - 1) // bs
        exp_ctx = min(c.expected_context or self.max_seq_len, self.max_seq_len)
        per_seq = (exp_ctx + 1 + bs - 1) // bs      # +1 lookahead slot
        conc = min(c.expected_concurrency or c.max_ragged_batch_size,
                   c.max_ragged_batch_size)
        num_blocks = c.num_kv_blocks or (conc * per_seq + 1)
        self.kv = BlockedKVCache(cfg.num_layers, cfg.kv_heads, cfg.dims_per_head,
                                 num_blocks=num_blocks, block_size=bs,
                                 dtype=cfg.act_dtype, device=self.device)
        # block 0 is the trash block for padded writes: never allocate it
        self.kv.reserve_trash_block()
        self.state = DSStateManager(self.kv, c.max_tracked_sequences)
        self.runner = PagedModelRunner(self.model, bs, max_blocks_per_seq, self.device)
        self.max_blocks_per_seq = max_blocks_per_seq
        # host stream the per-serve frame generators are seeded from
        self._rng = torch.Generator().manual_seed(0)
        # abnormal retirements (non-finite rows), newest last
        self.fault_log: collections.deque = collections.deque(maxlen=c.fault_log_max)
        # the in-frame counters of the last serve() run, by STAT_NAMES
        self.serve_counters: Dict[str, int] = {}
        logger.info(f"InferenceEngineV2: blocks={num_blocks}x{bs} "
                    f"chunk={c.prefill_chunk_size} device={self.device}")

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
              speculate: Optional[bool] = None, rng=None, scheduler=None,
              faults=None, resume_from=None, yield_boundaries: bool = False):
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
        engine's device) makes sampled rows reproducible.
        """
        unported = {"scheduler": scheduler is not None, "faults": faults is not None,
                    "resume_from": resume_from is not None,
                    "speculate": bool(speculate), "yield_boundaries": yield_boundaries}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"serve({name}=...): {_ROADMAP}")
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
        return self._serve_guarded(slots, iter(arrivals), steps, max_new_tokens,
                                   temperature, eos_token_id, adaptive)

    def _serve_guarded(self, slots, arrivals, steps, max_new_tokens,
                       temperature, eos_token_id, adaptive):
        pending = collections.deque()
        try:
            yield from self._serve_loop(slots, arrivals, pending, steps,
                                        max_new_tokens, temperature,
                                        eos_token_id, adaptive)
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
                    temperature, eos_token_id, adaptive):
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
            # ---- frame plan: wide while any slot prefills, else decode ----
            width = c.prefill_chunk_size if slots.any_prefilling() else 1
            cur_steps = steps
            if adaptive:
                cur_steps = self._pick_frame_steps(ewma, steps, slots.free_slots() == 0)
            toks, emit, nonfinite, stats = slots.run_frame(
                self.runner, self.params, self.kv, width, cur_steps,
                slots.all_greedy())
            for name, n in zip(STAT_NAMES, stats):
                self.serve_counters[name] += int(n)
            # quarantine before the host replay: a poisoned row's slot is
            # freed here, so absorb neither emits nor retires it
            self._handle_nonfinite(slots, nonfinite, boundary)
            emissions, finished = slots.absorb(toks, emit, width)
            for uid, new_toks in emissions.items():
                seq = self.state.seqs[uid]
                seq.generated.extend(new_toks)
                seq.seen_tokens = int(slots.cached_h[slots.slot_of_uid[uid]])
            for uid in finished:
                seq = self.state.seqs[uid]
                seq.done = True
                out = np.asarray(seq.generated, np.int64)
                slots.retire(uid)
                self.state.flush_sequence(uid)
                yield uid, out


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
