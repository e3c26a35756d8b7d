"""Serving fault records and the request ledger.

Mirrors the records of ``deepspeed_tpu/inference/v2/faults.py``:
``FaultReason``, one abnormal request retirement (or absorbed fault event)
in ``engine.fault_log``, and ``LedgerEntry``, one accepted, not yet retired
request in the engine's host-side ledger. The ledger is the authoritative
set ``serve()`` cleans up on abandonment, and the prefix cache publishes
only rows that have an entry. The fault injector, resilient dispatch,
deadlines, cancellation and snapshots of that file are not ported yet
(ROADMAP.md section A, item 6).
"""

import dataclasses
from typing import Dict, List, Optional

FAULT_KINDS = ("poison_row", "deadline_expired", "dispatch_failed",
               "dispatch_retry", "slow_frame", "kv_alloc_failed",
               # a KV swap-tier page restore/spill failed; the engine falls
               # back to re-prefill (correctness preserved, work recomputed)
               "swap_failed", "nonfinite_repaired", "resume_truncated")


@dataclasses.dataclass
class FaultReason:
    """Structured record of one abnormal request retirement (or absorbed
    fault event), appended to ``engine.fault_log``."""
    uid: int
    kind: str                  # one of FAULT_KINDS
    frame: int                 # frame index at detection
    detail: str = ""
    tokens_emitted: int = 0    # committed tokens at the fault
    partial: Optional[List[int]] = None   # committed output, if any
    tenant: Optional[str] = None
    priority: Optional[str] = None


@dataclasses.dataclass
class LedgerEntry:
    """One accepted, not-yet-retired request in the engine's host-side
    serving ledger: added at enqueue, dropped at retire, shed or fault."""
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
    cancelled: bool = False
    # distributed-trace context ({"id", "parent"}); the tracer that mints
    # it is not ported yet (ROADMAP.md section A, item 12)
    trace: Optional[Dict] = None
