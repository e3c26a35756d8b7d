"""Model zoo of the port (mirrors ``deepspeed_tpu/models``)."""

from .config import PRESETS, TransformerConfig, get_config  # noqa: F401
from .transformer import CausalLM, build_model  # noqa: F401
