"""v2 ragged serving of the port (mirrors ``deepspeed_tpu/inference/v2``)."""

from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig  # noqa: F401
from .kv_cache import BlockedKVCache  # noqa: F401
from .ragged_manager import DeviceSlotTable, DSStateManager  # noqa: F401
