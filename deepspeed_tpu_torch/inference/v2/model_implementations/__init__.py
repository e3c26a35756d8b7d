"""v2 model implementations of the port (mirrors
``deepspeed_tpu/inference/v2/model_implementations``): serving-side weight
quantization and the tensor-parallel arch check. The per-arch checkpoint
containers are not ported yet (ROADMAP.md section A, item 13)."""

from .archs import validate_tp_serving  # noqa: F401
from .quantize import quantize_params, quantized_param_bytes  # noqa: F401
