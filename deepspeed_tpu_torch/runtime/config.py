"""Top-level config system.

Mirrors ``deepspeed_tpu/runtime/config.py`` (``DeepSpeedConfig``) on
dataclasses and plain dict parsing: one JSON dict (or path, or JSON
string) with the reference's field names. The port keeps what its
training path reads: the batch-size algebra and its errors, fp16/bf16,
optimizer, scheduler, ``gradient_clipping``, ``steps_per_print``,
``activation_checkpointing``, ``zero_optimization``, ``checkpoint``,
``sparse_gradients``, ``wall_clock_breakdown``, ``seed`` and the JAX ``mesh`` block (read only to
refuse layouts over more than one card). Other blocks stay in
``_param_dict`` unread.

Batch-size resolution (train_batch_size = micro_batch * grad_accum *
dp_world) follows ``_configure_train_batch_size``.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch

from .config_utils import DeepSpeedConfigModel, dict_raise_error_on_duplicate_keys
from .constants import (ACTIVATION_CHECKPOINTING, BFLOAT16, BFLOAT16_OLD, CHECKPOINT, FP16,
                        GRADIENT_ACCUMULATION_STEPS, GRADIENT_ACCUMULATION_STEPS_DEFAULT,
                        GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT, MESH, OPTIMIZER,
                        SCHEDULER, SPARSE_GRADIENTS, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT,
                        TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT,
                        TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                        TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT, WALL_CLOCK_BREAKDOWN,
                        WALL_CLOCK_BREAKDOWN_DEFAULT, ZERO_OPTIMIZATION)
from .zero.config import DeepSpeedZeroConfig


@dataclasses.dataclass
class DeepSpeedFP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 -> dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    bounds = {"loss_scale": (0.0, None), "initial_scale_power": (0, None),
              "loss_scale_window": (0, None), "hysteresis": (0, None),
              "min_loss_scale": (0.0, None)}

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0


@dataclasses.dataclass
class DeepSpeedBF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    immediate_grad_update: bool = False
    # f32 master copies of bf16 params in the optimizer state
    master_weights: bool = True
    # opt-in inf/nan grad check that skips the step on overflow
    check_grad_overflow: bool = False


@dataclasses.dataclass
class DeepSpeedOptimizerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    legacy_fusion: bool = False


@dataclasses.dataclass
class DeepSpeedSchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # recompute policy: "none" (no remat) or "full" (the port's
    # torch.utils.checkpoint per layer); the JAX policies "dots",
    # "dots_no_batch" and "dots_offload" are not ported
    policy: str = "none"


def _to_dict(config: Union[str, dict, None]) -> dict:
    if config is None:
        return {}
    if isinstance(config, dict):
        return config
    if isinstance(config, str):
        if os.path.exists(config):
            with open(config) as f:
                return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        try:
            return json.loads(config)
        except json.JSONDecodeError:
            raise ValueError(f"Expected a file path or JSON string for config, got: {config!r}")
    raise TypeError(f"Unsupported config type: {type(config)}")


@dataclasses.dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    """The ``checkpoint`` block (JAX ``CheckpointConfig``); the engine
    refuses ``async_save``."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = dataclasses.field(default_factory=dict)
    async_save: bool = False


class DeepSpeedConfig:
    """Parsed, validated view over the user's JSON config dict."""

    def __init__(self, config: Union[str, dict, None], world_size: Optional[int] = None):
        self._param_dict = _to_dict(config)
        d = self._param_dict

        self.train_batch_size = d.get(TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = d.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                                                    TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = d.get(GRADIENT_ACCUMULATION_STEPS,
                                                 GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        for key in (TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, GRADIENT_ACCUMULATION_STEPS):
            if isinstance(d.get(key), str) and d[key] != "auto":
                raise ValueError(f"{key} must be an integer or 'auto', got {d[key]!r}")

        self.steps_per_print = d.get(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = d.get(WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.sparse_gradients_enabled = d.get(SPARSE_GRADIENTS, False)
        self.gradient_clipping = d.get(GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.seed = int(d.get("seed", 42))
        self.mesh = dict(d.get(MESH, {}))

        self.fp16 = DeepSpeedFP16Config.from_dict(d.get(FP16, {}))
        self.bf16 = DeepSpeedBF16Config.from_dict(d.get(BFLOAT16, d.get(BFLOAT16_OLD, {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 modes cannot both be enabled")

        opt = d.get(OPTIMIZER, None)
        self.optimizer = DeepSpeedOptimizerConfig.from_dict(opt if isinstance(opt, dict) else {})
        sched = d.get(SCHEDULER, None)
        self.scheduler = DeepSpeedSchedulerConfig.from_dict(
            sched if isinstance(sched, dict) else {})
        self.zero_config = DeepSpeedZeroConfig.from_dict(d.get(ZERO_OPTIMIZATION, {}))
        self.activation_checkpointing = ActivationCheckpointingConfig.from_dict(
            d.get(ACTIVATION_CHECKPOINTING, {}))
        self.checkpoint_config = CheckpointConfig.from_dict(d.get(CHECKPOINT, {}))

        self.world_size = world_size
        if world_size is not None:
            self._configure_train_batch_size(world_size)

    # ---- batch size math ----

    def _batch_assertion(self, dp_world):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        # AssertionError, as the JAX config raises, but never stripped by -O
        if not train_batch > 0:
            raise AssertionError(f"Train batch size: {train_batch} has to be greater than 0")
        if not micro_batch > 0:
            raise AssertionError(f"Micro batch size per gpu: {micro_batch} has to be greater than 0")
        if not grad_acc > 0:
            raise AssertionError(f"Gradient accumulation steps: {grad_acc} has to be greater than 0")
        if train_batch != micro_batch * grad_acc * dp_world:
            raise AssertionError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size {train_batch} != "
                f"{micro_batch} * {grad_acc} * {dp_world}")

    def _set_batch_related_parameters(self, dp_world):
        def as_int(x):
            return x if isinstance(x, int) else None

        train_batch = as_int(self.train_batch_size)
        micro_batch = as_int(self.train_micro_batch_size_per_gpu)
        grad_acc = as_int(self.gradient_accumulation_steps)

        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch // dp_world
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // dp_world // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * dp_world
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // dp_world
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * dp_world
            self.gradient_accumulation_steps = 1
        else:
            raise ValueError("Either train_batch_size or train_micro_batch_size_per_gpu "
                             "needs to be provided")

    def _configure_train_batch_size(self, dp_world):
        self._set_batch_related_parameters(dp_world)
        self._batch_assertion(dp_world)

    # ---- convenience ----

    @property
    def zero_optimization_stage(self):
        return self.zero_config.stage

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32
