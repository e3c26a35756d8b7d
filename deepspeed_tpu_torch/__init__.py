"""PyTorch/CUDA port of deepspeed_tpu."""
