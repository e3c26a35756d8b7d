"""fp16 loss scaling."""
