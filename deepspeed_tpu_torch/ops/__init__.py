"""Kernels of the PyTorch port and their plain versions, and the public ops
users call directly: block-sparse attention, Evoformer attention and the
fp8 quantizer."""

from .evoformer import DS4Sci_EvoformerAttention
from .fp_quantizer import dequantize_fp8, quantize_fp8
from .sparse_attention import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                               DenseSparsityConfig, FixedSparsityConfig,
                               SparseSelfAttention, SparsityConfig)
from .sparse_flash import sparse_flash_attention
