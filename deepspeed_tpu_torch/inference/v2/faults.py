"""Serving resilience: fault injection, fault taxonomy, crash recovery.

Mirrors ``deepspeed_tpu/inference/v2/faults.py`` without the router's
injector (``RouterFaultSpec``, ``RouterFaultInjector``; ROADMAP.md section
A, item 12):

1. **Fault taxonomy**: every abnormal request retirement is a
   ``FaultReason`` (kind, frame, partial output) appended to the engine's
   bounded ``fault_log`` and counted in ``ds_serving_faults_total{kind=}``.
   Kinds: ``FAULT_KINDS`` (plus ``cancelled``, ``engine.cancel_request``).
2. **Deterministic fault injection**: ``FaultInjector`` drives a scripted
   schedule of ``FaultSpec``s keyed only by the frame-boundary index and a
   uid, through the real code paths: dispatch exceptions raise before the
   frame's first step runs (so a retry re-runs the identical frame), poison
   sets a row's flag in the slot table, which the frame turns into NaN
   logits (so quarantine or repair runs the real in-frame check), KV
   allocation failures gate the real admission, and slow frames sleep
   inside the watchdog's window.
3. **Crash recovery**: ``snapshot_ledger`` serializes the host-side request
   ledger (original prompts, committed tokens, scheduling metadata; no
   device read), ``serve(..., resume_from=snapshot)`` re-admits every
   in-flight request by re-prefilling prompt + committed tokens, and
   ``snapshot_split`` cuts a snapshot into per-request resume arrivals.
   Snapshots are plain JSON, the same dicts in both packages.
4. **Recovery telemetry**: the quarantine, deadline, recovery, retry and
   slow-frame counters and the ``last_recovery_ms`` gauge
   (``telemetry.py``).

The engine keeps its slot state in place (static buffers of the captured
steps), so a frame that failed after its first step has already advanced
them: the engine retries only a failure raised before the first step, and
any later one goes straight to the crash path (``engine_v2.py``
``_run_frame_resilient``).
"""

import dataclasses
import time
from typing import Dict, List, Optional

FAULT_KINDS = ("poison_row", "deadline_expired", "dispatch_failed",
               "dispatch_retry", "slow_frame", "kv_alloc_failed",
               # a KV swap-tier page restore/spill failed; the engine falls
               # back to re-prefill (correctness preserved, work recomputed)
               "swap_failed",
               # nonfinite_policy="repair": a transient non-finite blip was
               # absorbed in the frame (row rolled back to its pre-step
               # carry, not retired)
               "nonfinite_repaired",
               # a resume landed on an engine whose max_seq_len cannot hold
               # the original budget: the clamp breaks token identity with
               # the no-failure run, so it is recorded
               "resume_truncated")

INJECTABLE_KINDS = ("dispatch_exception", "kv_alloc_fail", "poison_row",
                    "slow_frame")


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector`` at its dispatch hook. The retry loop
    treats it like any other dispatch failure."""


class FrameDispatchError(RuntimeError):
    """A serving frame could not be dispatched within the retry budget, or
    failed after its first step. By the time this propagates,
    ``engine.last_crash_snapshot`` holds the host-side request ledger:
    ``serve(..., resume_from=)`` on a fresh (or the same) engine resumes
    every in-flight request."""


@dataclasses.dataclass
class FaultReason:
    """Structured record of one abnormal request retirement (or absorbed
    fault event), appended to ``engine.fault_log``."""
    uid: int
    kind: str                  # one of FAULT_KINDS, or "cancelled"
    frame: int                 # frame index at detection
    detail: str = ""
    tokens_emitted: int = 0    # committed tokens at the fault
    partial: Optional[List[int]] = None   # committed output, if any
    tenant: Optional[str] = None
    priority: Optional[str] = None


@dataclasses.dataclass
class LedgerEntry:
    """One accepted, not-yet-retired request in the engine's host-side
    serving ledger: added at enqueue, dropped at retire, shed or fault. The
    unit of crash recovery and the set ``serve()`` cleans up on
    abandonment."""
    uid: int
    prompt: List[int]          # ORIGINAL prompt (preemption folds happen in
                               # the scheduler's Request, never here)
    limit: int                 # ORIGINAL generation budget
    temp: float
    eos: Optional[int]
    deadline_at: Optional[float] = None    # absolute monotonic, None = none
    tenant: Optional[str] = None
    priority: Optional[object] = None      # class name / int, as submitted
    slo_ms: Optional[float] = None
    resumed_from: int = 0      # committed tokens carried across a resume
    # engine.cancel_request: rides the deadline machinery but retires with
    # a ``cancelled`` FaultReason
    cancelled: bool = False
    # distributed-trace context ({"id", "parent"}); the tracer that mints
    # it is not ported yet (ROADMAP.md section A, item 12)
    trace: Optional[Dict] = None


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault, keyed by the serve loop's frame-boundary index
    (``frame``; it counts idle polls too, where no frame is dispatched)
    and, for poison, a uid.

    * ``dispatch_exception``: the first ``times`` dispatch attempts at
      frame ``frame`` raise ``InjectedFault`` before the frame's first
      step. ``times`` within the engine's retry budget is transient; beyond
      it, a crash.
    * ``kv_alloc_fail``: admission fails at boundaries ``frame .. frame +
      times - 1``; arrivals defer.
    * ``poison_row``: at the boundary before frame ``frame``, set row
      ``uid``'s poison flag; the frame NaNs its logits. One-shot.
    * ``slow_frame``: sleep ``seconds`` before dispatching frame ``frame``
      (first attempt only), inside the watchdog's window.
    """
    kind: str
    frame: int
    times: int = 1
    uid: Optional[int] = None
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in INJECTABLE_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected "
                             f"one of {INJECTABLE_KINDS}")
        if self.frame < 0 or self.times < 1:
            raise ValueError("fault frame must be >= 0 and times >= 1")
        if self.kind == "poison_row" and self.uid is None:
            raise ValueError("poison_row needs a target uid")
        if self.kind == "slow_frame" and self.seconds < 0:
            raise ValueError("slow_frame seconds must be >= 0")


class FaultInjector:
    """Schedule-driven fault injection for ``serve(..., faults=)``.

    Specs may be ``FaultSpec`` instances or plain dicts with the same
    fields. One injector drives one serve run at a time (``begin_serve``
    rearms the schedule); ``fired`` records every injection that happened,
    in order. ``sleep`` is the stall of a ``slow_frame`` (tests pass one
    that advances their synthetic clock)."""

    def __init__(self, schedule, sleep=time.sleep):
        self.schedule = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                         for s in schedule]
        self._sleep = sleep
        self.fired: List[Dict] = []
        self.begin_serve()

    def begin_serve(self) -> None:
        """Rearm every spec (``serve()`` calls it: two identical runs inject
        identically)."""
        self._dispatch_fired = {id(s): 0 for s in self.schedule}
        self._poison_done = {id(s): False for s in self.schedule}
        self._slept = set()

    def _fire(self, spec: FaultSpec, frame: int, **extra) -> None:
        self.fired.append({"kind": spec.kind, "frame": frame, **extra})

    def poison_uids(self, frame: int) -> List[int]:
        """uids whose poison flag should be set before this frame."""
        out = []
        for s in self.schedule:
            if s.kind == "poison_row" and s.frame == frame \
                    and not self._poison_done[id(s)]:
                self._poison_done[id(s)] = True
                self._fire(s, frame, uid=s.uid)
                out.append(s.uid)
        return out

    def kv_alloc_blocked(self, frame: int) -> bool:
        """True when this boundary's KV reservations should fail."""
        for s in self.schedule:
            if s.kind == "kv_alloc_fail" and \
                    s.frame <= frame < s.frame + s.times:
                self._fire(s, frame)
                return True
        return False

    def before_dispatch(self, frame: int, attempt: int) -> None:
        """Runs inside the engine's dispatch guard, before the frame's first
        step: may sleep (slow_frame) or raise ``InjectedFault``
        (dispatch_exception), so a retried frame is token-identical."""
        for s in self.schedule:
            if s.kind == "slow_frame" and s.frame == frame \
                    and attempt == 0 and id(s) not in self._slept:
                self._slept.add(id(s))
                self._fire(s, frame, seconds=s.seconds)
                self._sleep(s.seconds)
        for s in self.schedule:
            if s.kind == "dispatch_exception" and s.frame == frame \
                    and self._dispatch_fired[id(s)] < s.times:
                self._dispatch_fired[id(s)] += 1
                self._fire(s, frame, attempt=attempt)
                raise InjectedFault(
                    f"injected dispatch failure (frame={frame} "
                    f"attempt={attempt} "
                    f"{self._dispatch_fired[id(s)]}/{s.times})")


def snapshot_split(snapshot: Dict) -> List[Dict]:
    """Split a ``snapshot_serving_state()`` snapshot into per-request resume
    arrivals, the dict form ``serve()`` ingests mid-run (the ``generated``
    key marks the re-admission; see ``InferenceEngineV2._norm_arrival``).
    Each can be placed on a different engine, which re-prefills prompt +
    committed tokens, so greedy outputs stay token-identical to the
    no-failure run. ``eos`` None maps to the explicit no-EOS sentinel -1;
    an expired deadline maps to an epsilon budget (cancelled at the
    target's next boundary)."""
    if snapshot.get("version") != 1:
        raise ValueError("snapshot_split: unrecognized snapshot version "
                         f"{snapshot.get('version')!r}")
    out = []
    for r in snapshot.get("requests", []):
        item = {
            "uid": int(r["uid"]),
            "tokens": [int(t) for t in r["prompt"]],
            "generated": [int(t) for t in r.get("generated", [])],
            "max_new_tokens": int(r["limit"]),
            "temperature": float(r["temp"]),
            "eos_token_id": -1 if r["eos"] is None else int(r["eos"]),
        }
        for k in ("tenant", "priority", "slo_ms", "trace"):
            if r.get(k) is not None:
                item[k] = r[k]
        if r.get("deadline_remaining_ms") is not None:
            item["deadline_ms"] = max(float(r["deadline_remaining_ms"]), 1e-3)
        out.append(item)
    return out


def snapshot_ledger(ledger: Dict[int, LedgerEntry], seqs: Dict,
                    clock, swap_tier=None) -> Dict:
    """Serialize the host-side request ledger to a plain-python snapshot
    (ints, floats, strings and lists only; safe to persist as JSON).

    Per request: the ORIGINAL prompt, every committed token (the host
    mirror ``seq.generated``; tokens of a frame that never returned are
    re-generated by the resume's re-prefill), the remaining deadline budget
    and the scheduling metadata. No device read. ``swap_tier`` (a
    ``kv_hierarchy.KVSwapTier``) annotates requests whose committed pages
    are already in the tier (``swapped_tokens``); a resume on an engine
    sharing the tier restores them instead of re-prefilling."""
    now = clock()
    reqs = []
    for uid, ent in ledger.items():
        seq = seqs.get(uid)
        generated = [int(t) for t in seq.generated] if seq is not None else []
        swapped = None
        if swap_tier is not None:
            rec = swap_tier.request_record(uid)
            swapped = rec["tokens"] if rec else None
        reqs.append({
            "swapped_tokens": swapped,
            "uid": int(uid),
            "prompt": [int(t) for t in ent.prompt],
            "generated": generated,
            "limit": int(ent.limit),
            "temp": float(ent.temp),
            "eos": None if ent.eos is None else int(ent.eos),
            "deadline_remaining_ms": (
                None if ent.deadline_at is None
                else max(0.0, (ent.deadline_at - now) * 1e3)),
            "tenant": ent.tenant,
            "priority": ent.priority,
            "slo_ms": ent.slo_ms,
            "trace": ent.trace,
        })
    return {"version": 1, "requests": reqs}
