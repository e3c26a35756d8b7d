"""Inference of the port (mirrors ``deepspeed_tpu/inference``)."""
