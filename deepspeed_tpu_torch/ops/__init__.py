"""Kernels of the PyTorch port and their plain versions."""
