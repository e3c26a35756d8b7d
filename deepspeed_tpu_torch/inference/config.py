"""Inference configuration.

Mirrors ``deepspeed_tpu/inference/config.py`` (DeepSpeedInferenceConfig,
DeepSpeedTPConfig, QuantizationConfig) on the port's dataclass config base
(``runtime/config_utils.py``): the same field names, defaults and aliases
(``max_out_tokens`` for ``max_tokens``, ``ds_config`` for
``checkpoint_config``), so reference-style ``init_inference(...,
dtype=..., tensor_parallel={"tp_size": N})`` calls parse unchanged.
"""

import dataclasses
from typing import Any, Dict, Optional, Union

from ..runtime.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


@dataclasses.dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    qkv: Optional[Any] = None
    bits: int = 8
    group_size: int = 64


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = False
    dtype: Any = "bfloat16"              # a name, "torch.<name>", or a torch.dtype
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(default_factory=DeepSpeedTPConfig)
    enable_cuda_graph: bool = False      # parsed, not read (as in JAX)
    zero: Dict[str, Any] = dataclasses.field(default_factory=dict)
    triangular_masking: bool = True
    moe: Union[bool, Dict[str, Any]] = False
    quant: QuantizationConfig = dataclasses.field(default_factory=QuantizationConfig)
    checkpoint: Optional[Union[str, Dict]] = None
    base_dir: str = ""
    max_tokens: int = 4096
    min_out_tokens: int = 1
    transposed_mode: bool = False
    mp_size: int = 1                     # legacy alias for tp_size
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = None
    injection_policy_tuple: Optional[tuple] = None
    config: Optional[Dict] = None
    save_mp_checkpoint_path: Optional[str] = None
    checkpoint_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    aliases = {"max_out_tokens": "max_tokens", "ds_config": "checkpoint_config"}
    blocks = {"tensor_parallel": DeepSpeedTPConfig, "quant": QuantizationConfig}

    @property
    def tp_size_effective(self):
        return max(self.tensor_parallel.tp_size, self.mp_size)
