"""In-graph serving counters.

Mirrors the counter layout of ``deepspeed_tpu/inference/v2/telemetry.py``:
the (N_STATS,) int32 vector the serving frame carries, and its fresh zero.
``ServingTelemetry`` (the host-side histograms, gauges and exporters) is
not ported yet (ROADMAP.md).
"""

import torch

# Indices into the (N_STATS,) int32 vector the serving frame carries.
# Per step:
#   EMITTED        tokens emitted (sum of the emit mask)
#   ACTIVE_STEPS   rows that did any work this step (occupancy integral)
#   PREFILL_TOKS   prompt tokens consumed this step
#   EOS            emitted tokens that hit their row's EOS id
#   TARGET_FWD     decode-mode target forwards (plain decode row-steps)
#   DRAFTED        draft tokens proposed (speculative serving)
#   ACCEPTED       accepted-and-emitted draft tokens (speculative serving)
STAT_EMITTED = 0
STAT_ACTIVE_STEPS = 1
STAT_PREFILL_TOKS = 2
STAT_EOS = 3
STAT_TARGET_FWD = 4
STAT_DRAFTED = 5
STAT_ACCEPTED = 6
N_STATS = 7

STAT_NAMES = ("tokens_emitted", "active_row_steps", "prefill_tokens",
              "eos_events", "target_forwards", "drafted_tokens",
              "accepted_draft_tokens")


def zero_stats(device=None):
    """Fresh (N_STATS,) int32 stat vector for a frame carry."""
    return torch.zeros((N_STATS,), dtype=torch.int32, device=device)
