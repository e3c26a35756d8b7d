"""ZeRO-Inference weight-only quantization.

Mirrors ``deepspeed_tpu/inference/quantization/layers.py``
(QuantizedParameter, QuantizedLinear, QuantizedEmbedding,
quantize_model_params, dequantize_model_params): weights stored int8, int4
or fp6 with per-group scales and dequantized at use. The int8 and int4
paths run the group quantizers (``ops/quantizer.py``, the hand-written
kernel on the card), and ``QuantizedLinear`` runs the fused
weight-only-quantized matmul (``ops/woq_matmul.py``) where the weight's
layout allows. Each class works on the device of the tensors it is given:
CUDA tensors run the kernels, CPU tensors their plain versions.
"""

import math

import torch

from ...ops.quantizer import dequantize_int4, dequantize_int8, quantize_groups
from ...ops.woq_matmul import quantize_woq, woq_dequantize, woq_matmul
from ...utils.tree import tree_map


class QuantizedParameter:
    """A weight held in quantized form; dequantizes at use."""

    def __init__(self, q, scales, orig_shape, bits: int, group_size: int,
                 dtype=torch.bfloat16):
        self.q = q
        self.scales = scales
        self.orig_shape = tuple(orig_shape)
        self.bits = bits
        self.group_size = group_size
        self.dtype = dtype

    @classmethod
    def quantize(cls, w, bits: int = 8, group_size: int = 256):
        """The flattened ``w`` as if zero-padded to a multiple of the group
        (JAX pads with a copy; on the card the kernel masks the short last
        group): bits 8 gives (n_padded,) int8 codes, bits 4 (G, gs / 2)
        packed nibbles, bits 6 (3 n_padded / 4,) packed fp6 bytes; scales
        (G, 1), or (G,) for fp6."""
        if bits in (8, 4):
            q, s = quantize_groups(w, bits, group_size)
            return cls(q, s, w.shape, bits, group_size, w.dtype)
        if bits == 6:
            flat = w.reshape(-1)
            pad = (-flat.numel()) % group_size
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            q, s = _quantize_fp6(flat, group_size)
            return cls(q, s, w.shape, 6, group_size, w.dtype)
        raise ValueError(f"bits must be 4, 6 or 8, got {bits}")

    def dequantized(self):
        n = math.prod(self.orig_shape)
        padded = -(-n // self.group_size) * self.group_size
        if self.bits == 8:
            full = dequantize_int8(self.q, self.scales, self.dtype, self.group_size)
        elif self.bits == 6:
            full = _dequantize_fp6(self.q, self.scales, padded, self.dtype, self.group_size)
        else:
            full = dequantize_int4(self.q, self.scales, (padded,), self.dtype,
                                   self.group_size)
        return full.reshape(-1)[:n].reshape(self.orig_shape)

    @property
    def nbytes(self):
        return self.q.numel() + self.scales.numel() * 4


# ---- FP6 (e3m2) weight-only format ---------------------------------------
# sign + 3-bit exponent (bias 3) + 2-bit mantissa, per-group absmax scaling to
# the format's max magnitude (28.0); four 6-bit codes pack into three bytes.

def _fp6_codebook(device=None):
    vals = []
    for code in range(64):
        s = -1.0 if code & 0x20 else 1.0
        e = (code >> 2) & 0x7
        m = code & 0x3
        v = 0.25 * (m / 4.0) if e == 0 else (2.0 ** (e - 3)) * (1.0 + m / 4.0)
        vals.append(s * v)
    return torch.tensor(vals, dtype=torch.float32, device=device)   # max magnitude 28.0


_FP6_MAX = 28.0


def _quantize_fp6(flat, group_size):
    """Nearest code by a search against the midpoints of the 32
    non-negative codebook values (ascending in (e, m)); ``searchsorted``
    takes the left side, as ``jnp.searchsorted`` does."""
    pos = _fp6_codebook(flat.device)[:32]
    mids = (pos[:-1] + pos[1:]) * 0.5
    g = flat.reshape(-1, group_size).float()
    scales = (g.abs().amax(dim=1, keepdim=True) / _FP6_MAX).clamp_min(1e-12)
    x = (g / scales).reshape(-1)
    mag = torch.searchsorted(mids, x.abs().contiguous()).to(torch.int32)
    codes = torch.where(x < 0, mag | 0x20, mag)
    pad4 = (-codes.numel()) % 4                              # pack needs 4 | n
    if pad4:
        codes = torch.cat([codes, codes.new_zeros(pad4)])
    c = codes.reshape(-1, 4)
    word = c[:, 0] | (c[:, 1] << 6) | (c[:, 2] << 12) | (c[:, 3] << 18)
    packed = torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                         dim=1).to(torch.uint8).reshape(-1)
    return packed, scales.reshape(-1)


def _dequantize_fp6(packed, scales, n_padded, dtype, group_size):
    book = _fp6_codebook(packed.device)
    b = packed.reshape(-1, 3).int()
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    codes = torch.stack([word & 0x3F, (word >> 6) & 0x3F, (word >> 12) & 0x3F,
                         (word >> 18) & 0x3F], dim=1).reshape(-1)
    vals = book[codes[:n_padded].long()].reshape(-1, group_size)   # drop pack padding
    return (vals * scales[:, None]).to(dtype).reshape(-1)[:n_padded]


class QuantizedLinear:
    """y = x @ dequant(Wq) (+ b).

    A 2-D weight whose K tiles the plane layout runs the fused
    weight-only-quantized matmul (the packed weight is dequantized tile by
    tile; the bf16 weight never exists); other shapes dequantize, then
    multiply."""

    def __init__(self, weight, bias=None, bits: int = 8, group_size: int = 256):
        self.bias = bias
        self.fused = None
        self.wq = None
        self._wdtype = weight.dtype
        planes = {8: 1, 6: 4, 4: 2}[bits]
        # the caller's group when the fused layout supports it, else the
        # kernel's native 128, else the flat dequantize path
        for fg in (group_size, 128):
            if weight.dim() == 2 and weight.shape[0] % (fg * planes) == 0:
                self.fused = quantize_woq(weight, bits, fg)
                break
        if self.fused is None:
            self.wq = QuantizedParameter.quantize(weight, bits, group_size)

    def __call__(self, x):
        if self.fused is not None:
            lead = x.shape[:-1]
            y = woq_matmul(x.reshape(-1, x.shape[-1]), self.fused)
            y = y.reshape(*lead, y.shape[-1])
        else:
            y = x @ self.wq.dequantized().to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y

    def dequantized(self):
        if self.fused is not None:
            return woq_dequantize(self.fused, self._wdtype)
        return self.wq.dequantized()

    @property
    def nbytes(self):
        if self.fused is not None:
            return self.fused["q"].numel() + self.fused["scales"].numel() * 4
        return self.wq.nbytes


class QuantizedEmbedding:
    """Embedding lookup over a quantized table."""

    def __init__(self, table, bits: int = 8, group_size: int = 256):
        self.wq = QuantizedParameter.quantize(table, bits, group_size)

    def __call__(self, ids):
        return self.wq.dequantized()[torch.as_tensor(ids).long()]


def quantize_model_params(params, bits: int = 8, group_size: int = 256,
                          min_size: int = 4096):
    """Quantize every weight of a params tree (nested dicts of tensors)
    with at least ``min_size`` elements and two axes into a
    ``QuantizedParameter``; smaller tensors stay dense."""
    def one(x):
        if x.numel() >= min_size and x.dim() >= 2:
            return QuantizedParameter.quantize(x, bits, group_size)
        return x
    return tree_map(one, params)


def dequantize_model_params(qparams):
    return tree_map(lambda x: x.dequantized() if isinstance(x, QuantizedParameter) else x,
                     qparams)
