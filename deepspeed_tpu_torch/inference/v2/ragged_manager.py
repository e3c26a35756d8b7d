"""Sequence state tracking for continuous batching.

Mirrors ``deepspeed_tpu/inference/v2/ragged_manager.py``:
``DSSequenceDescriptor``, ``DSStateManager`` and the single-device
``DeviceSlotTable``, whose frames may carry a draft model (speculative
serving: ``penult`` in the slot state, (steps, B, gamma + 1) emissions,
the committed watermark ``committed_h``). Per-slot state (last token, cached-token
counts, per-row limits/EOS/temperature, padded block tables) lives on the
device between frames as tensors the frame loop updates; the host keeps
numpy mirrors purely for admission control and never reads slot state back
mid-frame.
"""

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kv_cache import BlockedKVCache
from .telemetry import zero_stats


@dataclasses.dataclass
class DSSequenceDescriptor:
    uid: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0            # tokens whose KV is in cache
    pending: List[int] = dataclasses.field(default_factory=list)   # not yet prefilled
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1                  # decode-slot index, -1 = not resident
    # KV hierarchy (kv_hierarchy.py): tokens whose pages are already valid
    # at admission (mapped prefix-cache blocks or swapped-in pages); prefill
    # starts here. Reset when the blocks are released (preemption).
    resume_cached: int = 0
    # the prefix cache is probed once per enqueue (a deferred miss stays a
    # miss across retries)
    hier_probed: bool = False
    # stream position this row has published prefix blocks up to, and the
    # chain entry id there (the publish walk resumes from it)
    published_upto: int = 0
    publish_parent: int = -1        # kv_hierarchy.CHAIN_ROOT
    # (JAX's tier_blocks / tier_final / tier_partial marks belong to the
    # prefill role's handoff pipeline and wait for ROADMAP §A item 12)

    @property
    def in_prefill(self) -> bool:
        return len(self.pending) > 0


class DSStateManager:
    """Owns sequence descriptors + their KV block lists."""

    def __init__(self, kv_cache, max_tracked_sequences: int = 2048):
        self.kv_cache = kv_cache
        self.max_tracked = max_tracked_sequences
        self.seqs: Dict[int, DSSequenceDescriptor] = {}

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self.seqs:
            return self.seqs[uid]
        if len(self.seqs) >= self.max_tracked:
            raise RuntimeError(f"tracking limit reached ({self.max_tracked} sequences)")
        seq = DSSequenceDescriptor(uid=uid)
        self.seqs[uid] = seq
        return seq

    def ensure_capacity(self, seq: DSSequenceDescriptor, new_total_tokens: int) -> bool:
        """Grow the sequence's block list to hold ``new_total_tokens``;
        returns False if the pool can't satisfy it."""
        need = self.kv_cache.blocks_for(new_total_tokens) - len(seq.blocks)
        if need <= 0:
            return True
        if need > self.kv_cache.allocator.free_blocks:
            return False
        seq.blocks.extend(self.kv_cache.allocator.allocate(need))
        return True

    def flush_sequence(self, uid: int):
        seq = self.seqs.pop(uid, None)
        if seq is not None and seq.blocks:
            self.kv_cache.allocator.free(seq.blocks)

    @staticmethod
    def block_table(seq: DSSequenceDescriptor, max_blocks: int) -> np.ndarray:
        """Padded block-table row as host numpy (callers stack rows and ship
        one device transfer)."""
        if len(seq.blocks) > max_blocks:
            # never truncate: positions past a truncated table would gather
            # a wrong page and silently overwrite live KV
            raise ValueError(
                f"uid={seq.uid}: {len(seq.blocks)} blocks exceed the "
                f"{max_blocks}-wide table (sequence past max_seq_len?)")
        tbl = np.zeros((max_blocks,), np.int32)
        tbl[:len(seq.blocks)] = seq.blocks
        return tbl


# The device tensors of a slot table, in the frame's argument order; the
# carry is the part a serving step writes back, and a speculative step also
# carries ``penult`` (the token at position cached - 1).
SPEC_CARRY = ("cached", "produced", "last_tok", "penult", "done", "poison", "nonfinite",
              "stats")
SLOT_CARRY = tuple(n for n in SPEC_CARRY if n != "penult")
SLOT_STATE = ("prompts", "prompt_lens", "limits", "eos_ids", "temps", "tables") + SPEC_CARRY


def slot_state(n_slots: int, prompt_width: int, table_width: int, device) -> Dict:
    """Fresh slot-state tensors by ``SLOT_STATE`` name, every slot free.
    ``poison`` is the fault-injection flag and ``nonfinite`` the in-frame
    finite-check latch."""
    dev = torch.device(device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return {"prompts": zi(n_slots, max(1, prompt_width)), "prompt_lens": zi(n_slots),
            "limits": zi(n_slots),
            "eos_ids": torch.full((n_slots,), -1, dtype=torch.int32, device=dev),
            "temps": torch.zeros((n_slots,), dtype=torch.float32, device=dev),
            "tables": zi(n_slots, max(1, table_width)), "cached": zi(n_slots),
            "produced": zi(n_slots), "last_tok": zi(n_slots), "penult": zi(n_slots),
            "done": torch.ones((n_slots,), dtype=torch.bool, device=dev),
            "poison": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            "nonfinite": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            "stats": zero_stats(dev)}


class DeviceSlotTable:
    """Fixed set of serving slots whose state is device-resident.

    ``PagedModelRunner.frame_loop`` reads these tensors and returns their
    next values; a runner with step graphs instead makes them its static
    buffers and updates them in place (``frame_in_place``). Between frames
    they stay on the device. The host mirrors
    (``*_h`` numpy arrays, ``uid_of_slot``/``slot_of_uid``) exist so
    admission and retirement are decided without a device read:
    ``absorb`` replays the frame's emit mask with the in-frame arithmetic.

    A free slot is a frozen row: ``done=True, limits=0`` — the frame gives
    it width 0, its positions go to -1, and its writes land in the trash
    block.
    """

    def __init__(self, n_slots: int, prompt_width: int, table_width: int,
                 rng: torch.Generator, device):
        self.n_slots = n_slots
        self.device = torch.device(device)
        for name, t in slot_state(n_slots, prompt_width, table_width, self.device).items():
            setattr(self, name, t)
        self.rng = rng
        # host mirrors: admission control only
        self.uid_of_slot = np.full((n_slots,), -1, np.int64)
        self.slot_of_uid: Dict[int, int] = {}
        self.cached_h = np.zeros((n_slots,), np.int64)
        self.plen_h = np.zeros((n_slots,), np.int64)
        self.produced_h = np.zeros((n_slots,), np.int64)
        self.limit_h = np.zeros((n_slots,), np.int64)
        self.eos_h = np.full((n_slots,), -1, np.int64)
        self.temps_h = np.zeros((n_slots,), np.float64)
        self.done_h = np.ones((n_slots,), bool)

    def _dev(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # ---------------- host-mirror queries (no device sync) ----------------

    def free_slots(self) -> int:
        return int((self.uid_of_slot < 0).sum())

    def live_count(self) -> int:
        return self.n_slots - self.free_slots()

    def any_prefilling(self) -> bool:
        live = self.uid_of_slot >= 0
        return bool(np.any(live & (self.cached_h < self.plen_h)))

    def all_greedy(self) -> bool:
        live = self.uid_of_slot >= 0
        return bool(np.all(self.temps_h[live] <= 0.0))

    # ---------------- frame-boundary mutations ----------------

    def ensure_widths(self, prompt_need: int, table_need: int,
                      prompt_cap: int, table_cap: int) -> None:
        """Grow the padded prompt buffer / block-table width to the next
        power-of-two bucket."""
        assert prompt_need <= prompt_cap and table_need <= table_cap, \
            "admission let an over-context request through"
        p = self.prompts.shape[1]
        if prompt_need > p:
            new_p = BlockedKVCache.bucket_width(prompt_need, prompt_cap)
            self.prompts = F.pad(self.prompts, (0, new_p - p))
        t = self.tables.shape[1]
        if table_need > t:
            new_t = BlockedKVCache.bucket_width(table_need, table_cap)
            self.tables = F.pad(self.tables, (0, new_t - t))

    def admit(self, items: List[Tuple]) -> None:
        """Admit arrivals into free slots: ``items`` is a list of
        (uid, seq, prompt_tokens, limit, temperature, eos_id[, cached0]).
        ``cached0`` (default 0) is the KV-hierarchy admission watermark:
        tokens whose pages are already valid in the row's block table
        (mapped prefix-cache blocks or swapped-in pages); the frame starts
        the row's prefill there, as it resumes a mid-prefill row. Device
        writes are batched: one indexed store per tensor, however many
        arrive, into the tensors in place (on the card, the static buffers
        of the captured steps)."""
        free = [i for i in range(self.n_slots) if self.uid_of_slot[i] < 0]
        assert len(items) <= len(free), "admit() beyond free slots"
        p_w = int(self.prompts.shape[1])
        t_w = int(self.tables.shape[1])
        rows, p_rows, t_rows = [], [], []
        plens, lims, eoss, temps, cacheds = [], [], [], [], []
        for item, slot in zip(items, free):
            (uid, seq, toks, limit, temp, eos), rest = item[:6], item[6:]
            cached0 = int(rest[0]) if rest else 0
            toks = np.asarray(toks, np.int32).reshape(-1)
            if not 0 <= cached0 < max(len(toks), 1):
                raise ValueError(f"uid={uid}: admission watermark {cached0} must "
                                 f"leave a token of its {len(toks)} to prefill")
            self.uid_of_slot[slot] = uid
            self.slot_of_uid[uid] = slot
            seq.slot = slot
            self.cached_h[slot] = cached0
            self.plen_h[slot] = len(toks)
            self.produced_h[slot] = 0
            self.limit_h[slot] = limit
            self.eos_h[slot] = -1 if eos is None else eos
            self.temps_h[slot] = temp
            self.done_h[slot] = False
            p_row = np.zeros((p_w,), np.int32)
            p_row[:len(toks)] = toks
            rows.append(slot)
            p_rows.append(p_row)
            t_rows.append(DSStateManager.block_table(seq, t_w))
            plens.append(len(toks))
            lims.append(limit)
            eoss.append(-1 if eos is None else eos)
            temps.append(temp)
            cacheds.append(cached0)
        idx = self._dev(rows, torch.long)
        self.prompts[idx] = self._dev(np.stack(p_rows), torch.int32)
        self.tables[idx] = self._dev(np.stack(t_rows), torch.int32)
        self.prompt_lens[idx] = self._dev(plens, torch.int32)
        self.limits[idx] = self._dev(lims, torch.int32)
        self.eos_ids[idx] = self._dev(eoss, torch.int32)
        self.temps[idx] = self._dev(temps, torch.float32)
        self.cached[idx] = self._dev(cacheds, torch.int32)
        for t in (self.produced, self.last_tok, self.penult):
            t[idx] = 0
        self.done[idx] = False
        # a slot freed by quarantine must not hand its flags to the next row
        self.poison[idx] = False
        self.nonfinite[idx] = False

    def retire(self, uid: int) -> None:
        """Free the slot on the host side; the device row is already frozen
        (EOS set ``done`` in-frame, or it sits at ``produced == limits``)."""
        slot = self.slot_of_uid.pop(uid)
        self.uid_of_slot[slot] = -1
        self.done_h[slot] = True

    def evict(self, uid: int) -> None:
        """Evict a LIVE row at a frame boundary (quarantine): write the
        frozen-row invariant ``done=True, limits=0`` and free the slot."""
        slot = self.slot_of_uid.pop(uid)
        self.uid_of_slot[slot] = -1
        self.done_h[slot] = True
        self.done[slot] = True
        self.limits[slot] = 0
        self.poison[slot] = False
        self.nonfinite[slot] = False

    # ---------------- frame execution + host replay ----------------

    def dispatch_frame(self, runner, params, kv, width: int, steps: int,
                       greedy: bool, draft=None):
        """Run one K-step frame, returning the (tokens, emit) DEVICE tensors;
        nothing is read back. ``draft=(draft_runner, draft_params, draft_kv,
        gamma)`` runs the speculative frame: the draft's pools share this
        table's block tables. A runner with step graphs runs it in place on
        its static buffers; otherwise the functional loop's carry becomes the
        new state."""
        if runner.graphs is not None:
            return runner.frame_in_place(self, params, kv, width=width,
                                         steps=steps, greedy=greedy, draft=draft)
        if draft is None:
            (toks, emit, self.cached, self.produced, self.last_tok, self.done,
             self.poison, self.nonfinite, self.stats, self.rng, kv.k,
             kv.v) = runner.frame_loop(
                params, self.prompts, self.prompt_lens, self.limits, self.eos_ids,
                self.temps, self.tables, self.cached, self.produced, self.last_tok,
                self.done, self.poison, self.nonfinite, self.stats, self.rng,
                kv.k, kv.v, width=width, steps=steps, greedy=greedy)
            return toks, emit
        draft_runner, draft_params, draft_kv, gamma = draft
        (toks, emit, self.cached, self.produced, self.last_tok, self.penult, self.done,
         self.poison, self.nonfinite, self.stats, self.rng, kv.k, kv.v, draft_kv.k,
         draft_kv.v) = runner.frame_loop_spec(
            draft_runner, params, draft_params, self.prompts, self.prompt_lens,
            self.limits, self.eos_ids, self.temps, self.tables, self.cached,
            self.produced, self.last_tok, self.penult, self.done, self.poison,
            self.nonfinite, self.stats, self.rng, kv.k, kv.v, draft_kv.k, draft_kv.v,
            width=width, steps=steps, greedy=greedy, gamma=gamma)
        return toks, emit

    def run_frame(self, runner, params, kv, width: int, steps: int,
                  greedy: bool, draft=None):
        """Dispatch one frame, then fetch everything the boundary reads in
        the one device-to-host copy a frame makes: (tokens (steps, B[,
        gamma + 1]), emit (same) bool, the finite-check latch (B,) bool, the
        in-frame counters' increment (N_STATS,) int64). The device counter
        vector restarts at zero, in place."""
        toks, emit = self.dispatch_frame(runner, params, kv, width, steps, greedy,
                                         draft=draft)
        n, b = toks.numel(), self.n_slots
        host = torch.cat([toks.flatten(), emit.flatten().to(torch.int32),
                          self.nonfinite.to(torch.int32), self.stats]).cpu().numpy()
        self.stats.zero_()
        return (host[:n].reshape(toks.shape), host[n:2 * n].reshape(toks.shape) != 0,
                host[2 * n:2 * n + b] != 0, host[2 * n + b:].astype(np.int64))

    def nonfinite_uids(self, flags: np.ndarray) -> List[int]:
        """Live uids whose logits went non-finite during the last frame,
        from the finite-check latch ``run_frame`` fetched."""
        return [int(self.uid_of_slot[i]) for i in range(self.n_slots)
                if flags[i] and self.uid_of_slot[i] >= 0]

    @property
    def committed_h(self) -> np.ndarray:
        """Host mirror of the per-row committed watermark (JAX
        ``committed_h``): the tokens whose target KV is final (``cached``; pool slots at or beyond it may hold
        rejected speculation awaiting overwrite)."""
        return self.cached_h

    def absorb(self, toks: np.ndarray, emit: np.ndarray, width: int):
        """Replay the frame against the host mirrors (same arithmetic as the
        in-frame step) -> ({uid: [tokens emitted this frame]}, [finished
        uids]). A row finishes when it emits its EOS or reaches its limit.
        Speculative frames hand in (steps, B, gamma + 1) arrays."""
        if emit.ndim == 3:
            return self._absorb_spec(toks, emit, width)
        emissions: Dict[int, List[int]] = {}
        finished: List[int] = []
        live = [i for i in range(self.n_slots) if self.uid_of_slot[i] >= 0]
        for s in range(toks.shape[0]):
            for i in live:
                if self.done_h[i]:
                    continue
                if self.cached_h[i] < self.plen_h[i]:
                    self.cached_h[i] += min(width, self.plen_h[i] - self.cached_h[i])
                elif self.produced_h[i] < self.limit_h[i]:
                    self.cached_h[i] += 1
                else:
                    continue
                if emit[s, i]:
                    t = int(toks[s, i])
                    uid = int(self.uid_of_slot[i])
                    emissions.setdefault(uid, []).append(t)
                    self.produced_h[i] += 1
                    if t == self.eos_h[i] or self.produced_h[i] >= self.limit_h[i]:
                        self.done_h[i] = True
        for i in live:
            if self.done_h[i]:
                finished.append(int(self.uid_of_slot[i]))
        return emissions, finished

    def _absorb_spec(self, toks: np.ndarray, emit: np.ndarray, width: int):
        """Speculative replay (JAX ``_absorb_spec``): a decode row advances
        its committed watermark by the tokens its emit row carries (accepted
        drafts and the bonus or correction token); a prefill row advances by
        the chunk and emits at most its first token, in column 0."""
        emissions: Dict[int, List[int]] = {}
        finished: List[int] = []
        live = [i for i in range(self.n_slots) if self.uid_of_slot[i] >= 0]

        def take(i, uid, t):
            emissions.setdefault(uid, []).append(t)
            self.produced_h[i] += 1
            if t == self.eos_h[i] or self.produced_h[i] >= self.limit_h[i]:
                self.done_h[i] = True

        for s in range(toks.shape[0]):
            for i in live:
                if self.done_h[i]:
                    continue
                uid = int(self.uid_of_slot[i])
                if self.cached_h[i] < self.plen_h[i]:
                    self.cached_h[i] += min(width, self.plen_h[i] - self.cached_h[i])
                    if emit[s, i, 0]:
                        take(i, uid, int(toks[s, i, 0]))
                elif self.produced_h[i] < self.limit_h[i]:
                    m = 0
                    for k in range(emit.shape[2]):
                        if emit[s, i, k]:
                            take(i, uid, int(toks[s, i, k]))
                            m += 1
                    self.cached_h[i] += m
        for i in live:
            if self.done_h[i]:
                finished.append(int(self.uid_of_slot[i]))
        return emissions, finished
