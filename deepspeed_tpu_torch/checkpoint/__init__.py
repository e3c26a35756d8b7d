"""Checkpoint formats (mirrors ``deepspeed_tpu/checkpoint``): the universal
format of ``universal.py``."""

from .universal import ds_to_universal, load_universal_checkpoint  # noqa: F401
