"""ZeRO-Inference weight-only quantization of the port (mirrors
``deepspeed_tpu/inference/quantization``)."""
