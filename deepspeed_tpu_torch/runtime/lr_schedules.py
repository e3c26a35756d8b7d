"""Learning-rate schedules.

Mirrors ``deepspeed_tpu/runtime/lr_schedules.py`` (the port keeps its own
copy; it is host math): LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and
WarmupCosineLR, each a pure ``lr_at(step)`` behind the torch-scheduler-style
``step()/get_lr()/state_dict()`` facade the engine calls.
"""

import math
from typing import Optional

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


class LRSchedule:
    """Base: stateful facade over a pure ``lr_at(step)``."""

    def __init__(self):
        self.last_batch_iteration = -1
        self._last_lr = None

    def lr_at(self, step: int) -> float:
        raise NotImplementedError

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.lr_at(last_batch_iteration)
        return self._last_lr

    def get_lr(self):
        if self._last_lr is None:
            self._last_lr = self.lr_at(max(self.last_batch_iteration, 0))
        return [self._last_lr]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = None


class WarmupLR(LRSchedule):
    """Linear/log warmup to ``warmup_max_lr`` then constant (DeepSpeed ``lr_schedules.py:634``)."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _warmup_gamma(self, step):
        if step < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(step + 1)
            return step / self.warmup_num_steps
        return 1.0

    def lr_at(self, step):
        g = self._warmup_gamma(step)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * g


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 at total_num_steps (DeepSpeed ``lr_schedules.py:723``)."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        frac = max(0.0, (self.total_num_steps - step) /
                   max(1, self.total_num_steps - self.warmup_num_steps))
        return self.warmup_max_lr * frac


class WarmupCosineLR(WarmupLR):
    """Warmup then cosine decay to ``cos_min_ratio`` (DeepSpeed ``lr_schedules.py:774``)."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_ratio=0.0,
                 warmup_num_steps=1000, cos_min_ratio=0.0001, warmup_type=WARMUP_LINEAR_RATE,
                 warmup_max_lr=0.001, last_batch_iteration=-1):
        super().__init__(optimizer, warmup_min_ratio * warmup_max_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step):
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        frac = min(1.0, (step - self.warmup_num_steps) /
                   max(1, self.total_num_steps - self.warmup_num_steps))
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        ratio = self.cos_min_ratio + (1 - self.cos_min_ratio) * cos
        return self.warmup_max_lr * ratio


class LRRangeTest(LRSchedule):
    """LR range test sweep (DeepSpeed ``lr_schedules.py:267``)."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        if self.staircase:
            count = float(step // self.step_size)
        else:
            count = step / self.step_size
        return self.min_lr * (1 + self.step_rate * count)


class OneCycle(LRSchedule):
    """1-cycle policy (DeepSpeed ``lr_schedules.py:370``): up, down, then decay tail."""

    def __init__(self, optimizer=None, cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                 decay_lr_rate=0.0, cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, last_batch_iteration=-1, **momentum_kwargs):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        if step <= self.total_size:
            if step <= self.first_size:
                frac = step / self.first_size
            else:
                frac = max(0.0, 1 - (step - self.first_size) / self.second_size)
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
        decay_steps = step - self.total_size
        if self.decay_step_size > 0:
            decay = self.decay_lr_rate * (decay_steps // self.decay_step_size)
        else:
            decay = self.decay_lr_rate * decay_steps
        return max(0.0, self.cycle_min_lr * (1 - decay)) if decay < 1 else 0.0


SCHEDULE_REGISTRY = {
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
}

VALID_LR_SCHEDULES = list(SCHEDULE_REGISTRY)


def build_lr_schedule(name: str, params: dict, default_lr: Optional[float] = None) -> LRSchedule:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown lr schedule {name!r}; known: {VALID_LR_SCHEDULES}")
    params = dict(params)
    cls = SCHEDULE_REGISTRY[name]
    if default_lr is not None and "warmup_max_lr" not in params and \
            cls in (WarmupLR, WarmupDecayLR, WarmupCosineLR):
        params["warmup_max_lr"] = default_lr
    return cls(**params)
