"""Throughput timer.

Mirrors ``ThroughputTimer`` and ``NoopTimer`` of
``deepspeed_tpu/utils/timer.py``. No device fence: CUDA work is queued
asynchronously, and a per-step synchronize would serialize host and card;
over a window of steps the wall time between ``start``/``stop`` pairs
converges to the step time.
"""

import logging
import time

logger = logging.getLogger(__name__)


class ThroughputTimer:
    """Samples/sec across train batches, after ``start_step`` warm-up steps."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50, monitor_memory=False,
                 logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.initialized = True
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.perf_counter()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            self.end_time = time.perf_counter()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and report_speed and self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                    f"global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.6g}, "
                    f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.6g}")
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step:
            total_step_offset = self.global_step_count - self.start_step
            avg_time_per_step = self.total_elapsed_time / max(total_step_offset, 1)
            return self.batch_size / max(avg_time_per_step, 1e-12)
        return float("-inf")


class NoopTimer:
    class Timer:
        def start(self, **kw):
            ...

        def stop(self, **kw):
            ...

        def reset(self):
            ...

        def elapsed(self, **kw):
            return 0.0

    def __call__(self, name):
        return self.Timer()

    def get_timers(self):
        return {}

    def log(self, *args, **kwargs):
        ...

    def get_mean(self, *args, **kwargs):
        return {}
