"""ZeRO configuration.

Mirrors ``deepspeed_tpu/runtime/zero/config.py`` on dataclasses: the same
JSON keys (and aliases) and defaults. The port's engine reads ``stage`` and
``param_persistence_threshold``, as the JAX engine does; the bucket sizes
are parsed and not acted on (XLA schedules JAX's collectives; the port
issues one a leaf). It refuses every offload, ZeRO++ and MiCS (ROADMAP.md
section A, item 16).
"""

import dataclasses
from typing import Optional

from ..config_utils import DeepSpeedConfigModel

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


class _OffloadDevice:
    def check_bounds(self):
        super().check_bounds()
        if self.device not in OFFLOAD_DEVICES:
            raise ValueError(f"offload device {self.device!r} not in {OFFLOAD_DEVICES}")


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(_OffloadDevice, DeepSpeedConfigModel):
    """Where to keep (partitioned) parameters."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    bounds = {"buffer_count": (0, None), "buffer_size": (0, None), "max_in_cpu": (0, None)}


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(_OffloadDevice, DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    native: bool = True
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    bounds = {"buffer_count": (0, None), "ratio": (0.0, 1.0)}


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None

    sub_group_size: int = 1_000_000_000
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 2 ** 62
    gather_16bit_weights_on_model_save: bool = False

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    zero_quantized_weights: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_gradients: bool = False
    zero_quantized_nontrainable_weights: bool = False

    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True
    log_trace_cache_warnings: bool = False

    aliases = {"stage3_prefetch_bucket_size": "prefetch_bucket_size",
               "stage3_param_persistence_threshold": "param_persistence_threshold",
               "stage3_model_persistence_threshold": "model_persistence_threshold",
               "stage3_max_live_parameters": "max_live_parameters",
               "stage3_max_reuse_distance": "max_reuse_distance",
               "stage3_gather_16bit_weights_on_model_save":
                   "gather_16bit_weights_on_model_save"}
    bounds = {"stage": (0, 3), "reduce_bucket_size": (0, None),
              "allgather_bucket_size": (0, None), "sub_group_size": (0, None),
              "max_live_parameters": (0, None), "max_reuse_distance": (0, None),
              "prefetch_bucket_size": (0, None), "param_persistence_threshold": (0, None),
              "model_persistence_threshold": (0, None), "zero_hpz_partition_size": (0, None)}
    blocks = {"offload_param": DeepSpeedZeroOffloadParamConfig,
              "offload_optimizer": DeepSpeedZeroOffloadOptimizerConfig}

    def __post_init__(self):
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3
