"""Block quantization (int8 / int4).

Mirrors ``deepspeed_tpu/ops/pallas/quantizer.py``: symmetric per-group
quantization, groups being rows of a (num_groups, group_size) view, used by
ZeRO-Inference weight-only quantization (``inference/quantization``). int4
packs two nibbles per int8 byte (element 2i low, 2i + 1 high).

``quantize_int8`` and ``quantize_int4`` take the tensor's device as the
choice of implementation: on a CUDA tensor they launch the hand-written
Hopper kernel (``csrc/quantizer.cu``; the int4 packing fused into it) or
raise; on a CPU tensor they run the plain version. Both give q and scales
byte-identical to the JAX functions' (the scale as XLA computes it, see
``recip``). The dequantizers are plain torch, as
they are plain XLA in JAX. The TPU wrapper's ``block_g = 1`` fallback (a
tiling limit) has no counterpart.
"""

import ctypes

import numpy as np
import torch

from . import op_builder

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def recip(qmax):
    """1 / qmax rounded to f32. The JAX kernel body runs compiled (under
    jit in interpret mode), where XLA rewrites its division of the absmax
    by the constant qmax into a product with this reciprocal; it differs
    from the IEEE quotient in the last bit of some scales (ROADMAP.md
    section C), so the port multiplies too and its scales are
    bit-identical. The eager ``quantize_woq`` divides, and so does its
    port."""
    return float(np.float32(1.0) / np.float32(qmax))


def _quantize_groups_plain(flat, qmax):
    """(G, gs) -> (q int8 (G, gs), scale (G, 1) f32): the TPU kernel body."""
    x = flat.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10) * recip(qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _pack_nibbles(q):
    """(G, gs) int8 codes in [-7, 7] -> (G, gs / 2) int8: (2i) | (2i+1) << 4."""
    lo = q[:, 0::2].int() & 0xF
    hi = (q[:, 1::2].int() & 0xF) << 4
    packed = lo | hi
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def quantize_groups_plain(x, bits: int, group_size: int):
    """The plain PyTorch version of ``quantize_groups`` (on any device), on
    a zero-padded copy of the flat ``x``."""
    flat = x.reshape(-1)
    groups = -(-flat.numel() // group_size)
    pad = groups * group_size - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = _quantize_groups_plain(flat.reshape(groups, group_size),
                                      127.0 if bits == 8 else 7.0)
    return (q.reshape(-1), scale) if bits == 8 else (_pack_nibbles(q), scale)


def quantize_groups(x, bits: int, group_size: int):
    """Quantize the flat ``x`` as if zero-padded to a multiple of
    ``group_size``: returns (q, scale (G, 1) f32) with q the (G * gs,) int8
    codes (bits 8) or the (G, gs / 2) packed nibbles (bits 4). A CUDA
    tensor launches the kernel, which masks the short last group instead of
    padding; its launch counts on ``quantize_int8.launches`` (bits 8) or
    ``quantize_int4.launches`` (bits 4). A CPU tensor runs the plain
    version."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if x.device.type == "cpu":
        return quantize_groups_plain(x, bits, group_size)
    flat = x.reshape(-1)
    n = flat.numel()
    groups = -(-n // group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: no kernel for {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the quantizer kernel takes f32, bf16 or f16, got {x.dtype}")
    if bits == 4 and group_size % 2:
        raise ValueError(f"int4 packs pairs: group_size {group_size} must be even")
    if n == 0:
        raise ValueError("quantize: empty tensor")
    flat = flat.contiguous()
    if bits == 8:
        q = torch.empty((groups * group_size,), dtype=torch.int8, device=x.device)
    else:
        q = torch.empty((groups, group_size // 2), dtype=torch.int8, device=x.device)
    scale = torch.empty((groups, 1), dtype=torch.float32, device=x.device)
    fn = op_builder.load("quantizer").ds_quantize
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(flat.data_ptr(), q.data_ptr(), scale.data_ptr(), n, group_size, bits,
             _KERNEL_DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantizer kernel launch failed: cudaError {err}")
    if bits == 8:
        quantize_int8.launches += 1
    else:
        quantize_int4.launches += 1
    return q, scale


def _check_groups(x, group_size):
    if x.numel() % group_size:
        raise ValueError(f"{x.numel()} elements do not split into groups of {group_size}")


def quantize_int8(x, group_size: int = 256):
    """x: any shape with total % group_size == 0 -> (q int8 same shape,
    scales (groups, 1) f32)."""
    _check_groups(x, group_size)
    q, scale = quantize_groups(x, 8, group_size)
    return q.reshape(x.shape), scale


def dequantize_int8(q, scales, orig_dtype=torch.float32, group_size: int = 256):
    flat = q.reshape(-1, group_size)
    out = flat.float() * scales
    return out.reshape(q.shape).to(orig_dtype)


def quantize_int4(x, group_size: int = 256):
    """Symmetric int4: values in [-7, 7], packed two per byte ->
    (packed (groups, group_size / 2) int8, scales (groups, 1) f32,
    orig_shape)."""
    _check_groups(x, group_size)
    packed, scale = quantize_groups(x, 4, group_size)
    return packed, scale, tuple(x.shape)


def dequantize_int4(packed, scales, orig_shape, orig_dtype=torch.float32,
                    group_size: int = 256):
    p = packed.int()
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)           # sign-extend 4-bit two's complement
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], group_size)
    return (out.float() * scales).reshape(orig_shape).to(orig_dtype)


quantize_int8.launches = 0
quantize_int4.launches = 0


def ds_quantize(x, groups: int, bits: int = 8):
    """Reference-named wrapper: ``groups`` equal groups at ``bits``."""
    group_size = x.numel() // groups
    if bits == 8:
        return quantize_int8(x, group_size)
    if bits == 4:
        return quantize_int4(x, group_size)
    raise ValueError(f"unsupported bits={bits}")
