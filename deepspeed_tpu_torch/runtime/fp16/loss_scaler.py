"""Loss scaling for fp16 training.

Mirrors ``deepspeed_tpu/runtime/fp16/loss_scaler.py``: ``LossScaleState``,
the stateless ``DynamicLossScaler`` / ``StaticLossScaler`` policies,
``has_overflow`` and ``create_loss_scaler``. The JAX package keeps the
state on the device inside its compiled step and skips an overflowed update
with a select; the port's eager step must know on the host whether to run
the update, so the state is host numbers and ``update`` takes the overflow
flag as a bool (the engine reads it only when the overflow check is on).
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float         # the loss multiplier
    good_steps: int      # consecutive overflow-free steps
    hysteresis: int      # remaining tolerated overflows before backoff
    overflows: int       # total skipped steps (telemetry)


class DynamicLossScaler:
    """Stateless policy producing and updating a ``LossScaleState``."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False):
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = bool(consecutive_hysteresis)

    def init_state(self) -> LossScaleState:
        return LossScaleState(scale=self.init_scale, good_steps=0,
                              hysteresis=self.delayed_shift, overflows=0)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        overflow = bool(overflow)
        hysteresis_spent = state.hysteresis - 1 if overflow else state.hysteresis
        do_backoff = overflow and hysteresis_spent <= 0
        scale = max(state.scale / self.scale_factor, self.min_scale) if do_backoff else state.scale
        grow = not overflow and state.good_steps + 1 >= self.scale_window
        if grow:
            scale = scale * self.scale_factor
        good = 0 if (overflow or grow) else state.good_steps + 1
        if self.consecutive_hysteresis:
            hyst = max(hysteresis_spent, 0) if overflow else self.delayed_shift
        elif do_backoff:
            hyst = self.delayed_shift
        else:
            hyst = hysteresis_spent if overflow else state.hysteresis
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hyst,
                              overflows=state.overflows + int(overflow))


class StaticLossScaler:
    def __init__(self, scale=1.0):
        self.scale = float(scale)

    def init_state(self) -> LossScaleState:
        return LossScaleState(scale=self.scale, good_steps=0, hysteresis=1, overflows=0)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        return state._replace(overflows=state.overflows + int(bool(overflow)))


def has_overflow(grads) -> torch.Tensor:
    """A device bool: True if any element of any gradient is non-finite."""
    flags = [~torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).any()


def create_loss_scaler(fp16_config=None, dtype=None):
    """The engine's scaler: dynamic or static for fp16, static 1.0 otherwise."""
    if fp16_config is None or not fp16_config.enabled or dtype != torch.float16:
        return StaticLossScaler(1.0)
    if fp16_config.dynamic_loss_scale:
        return DynamicLossScaler(init_scale=2 ** fp16_config.initial_scale_power,
                                 scale_window=fp16_config.loss_scale_window,
                                 min_scale=fp16_config.min_loss_scale,
                                 delayed_shift=fp16_config.hysteresis,
                                 consecutive_hysteresis=fp16_config.consecutive_hysteresis)
    return StaticLossScaler(fp16_config.loss_scale)
