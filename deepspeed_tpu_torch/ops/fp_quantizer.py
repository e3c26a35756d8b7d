"""FP8 quantization with stochastic rounding.

Mirrors ``deepspeed_tpu/ops/pallas/fp_quantizer.py`` (the reference's
``csrc/fp_quantizer``): per-group scales that use the fp8 range (e4m3, max
448; e5m2, max 57344), then codes rounded to nearest or stochastically
(unbiased, for gradient and weight compression).

``quantize_fp8`` takes the tensor's device as the choice of implementation:
on a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/fp_quantizer.cu``, K9) or raises; on a CPU tensor it runs
``quantize_fp8_plain``. Both compute the scale as the IEEE quotient
``max(absmax, 1e-12) / fmax`` and ``x / scale`` in f32, as the JAX function
does. Stochastic rounding (the default, as in JAX) draws from Philox4x32-10
keyed by ``seed`` at each element's index, on both devices, and rounds by
an integer rule on the bits of x / scale (``_stochastic_codes``), so the
plain version and the kernel give the same bytes; the rule is exact, and
the float law it computes stays as ``_stochastic_codes_law`` for the
checks. The JAX function's CPU path ignores ``stochastic`` and rounds to
nearest; the port follows the TPU kernel on every device (ROADMAP.md
section C), and with ``stochastic=False`` its codes are the JAX function's
byte for byte.
"""

import ctypes

import torch

from . import op_builder

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_FORMATS = {"e4m3": (torch.float8_e4m3fn, E4M3_MAX, 0x7E),
            "e5m2": (torch.float8_e5m2, E5M2_MAX, 0x7B)}   # dtype, fmax, largest finite code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _format(fmt):
    if fmt not in _FORMATS:
        raise ValueError(f"fmt must be 'e4m3' or 'e5m2', got {fmt!r}")
    return _FORMATS[fmt]


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m for int64 ``a`` in [0, 2^32) and a
    32-bit constant m, with no intermediate past 2^49."""
    t_lo, t_hi = a * (m & 0xFFFF), a * (m >> 16)
    low = t_lo + ((t_hi & 0xFFFF) << 16)
    return ((t_hi >> 16) + (low >> 32)) & _MASK32, low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) of the counter words (int64
    tensors in [0, 2^32)) under the key (k0, k1): four 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_words(seed: int, index):
    """The 32-bit random word of each element index (int64 tensor): word
    ``index & 3`` of Philox4x32-10 keyed by the 64-bit ``seed`` at counter
    (index >> 2, 0, 0), as the kernel draws it."""
    ctr = index >> 2
    zero = torch.zeros_like(ctr)
    words = philox4x32_10(ctr & _MASK32, ctr >> 32, zero, zero, seed & _MASK32,
                          (seed >> 32) & _MASK32)
    return torch.stack(words, dim=-1).gather(-1, (index & 3)[..., None])[..., 0]


def _stochastic_codes_law(y, r, fmt):
    """The law of stochastic rounding, in floats: fp8 bytes of f32 ``y``,
    the lower or upper fp8 neighbour of |y| (saturated at fmax), the upper
    with probability (|y| - lo) / (hi - lo) against u = (r >> 8) 2^-24,
    then y's sign; NaN keeps its round-to-nearest code. Every step is exact
    (neighbours differ by a power of two), so ``_stochastic_codes`` must
    give the same bytes; the tests hold the two together."""
    dtype, fmax, maxcode = _format(fmt)

    def decode(code):
        return code.to(torch.uint8).view(dtype).float()

    a = y.abs()
    m = a.clamp(max=fmax).to(dtype).view(torch.uint8).long()   # nearest, saturated
    v = decode(m)
    lo = torch.where(v > a, m - 1, m)
    hi = torch.where(v < a, torch.clamp(m + 1, max=maxcode), m)
    vlo, vhi = decode(lo), decode(hi)
    up = (a - vlo) / (vhi - vlo)
    u = (r >> 8).float() * 2.0 ** -24
    code = torch.where((hi != lo) & (u < up), hi, lo) | (torch.signbit(y).long() << 7)
    rn = y.to(dtype).view(torch.uint8).long()
    return torch.where(torch.isnan(y), rn, code).to(torch.uint8).view(dtype)


# per format: D, the f32 significand bits below the fp8 mantissa; the bits
# of the least normal fp8 value 2^EMIN; the f32 - fp8 exponent rebias in code
# units (the kernel's Fmt)
_SR = {"e4m3": (20, 121 << 23, 120 << 3), "e5m2": (21, 113 << 23, 112 << 2)}


def _stochastic_codes(y, r, fmt):
    """The bytes of ``_stochastic_codes_law`` from the bits of f32 ``y``
    and the int64 words ``r`` in [0, 2^32), as the kernel computes them.
    In the fp8 normal range the upper neighbour is taken when
    (r >> 8) < t 2^(24 - D), t the D low significand bits of |y| (that is
    r < (bits << (32 - D)) mod 2^32), and the code is the truncated one plus
    that, saturated at the largest finite code. Below it the spacing is
    2^(EMIN - mantissa bits): the code is k = sig >> sh plus
    (r >> 8) < ceil(t 2^(24 - sh)), sig the significand, sh its bits below
    the spacing and t the rest."""
    dtype, _, maxcode = _format(fmt)
    d, low, rebias = _SR[fmt]
    yb = y.contiguous().view(torch.int32).long() & _MASK32
    b = yb & 0x7FFFFFFF
    up = (r < ((b << (32 - d)) & _MASK32)).long()
    normal = torch.clamp((b >> d) - rebias + up, max=maxcode)
    e = b >> 23
    sig = (b & 0x7FFFFF) | ((e > 0).long() << 23)
    # past 48 bits below the spacing, k = 0 and the threshold is (sig != 0)
    sh = (d + (low >> 23) - e.clamp(min=1)).clamp(max=48)
    k = sig >> sh
    t = sig - (k << sh)
    thr = ((t << 24) + (1 << sh) - 1) >> sh
    small = k + ((r >> 8) < thr).long()
    code = torch.where(b >= low, normal, small) | ((yb >> 24) & 0x80)
    rn = y.to(dtype).view(torch.uint8).long()
    return torch.where(b > 0x7F800000, rn, code).to(torch.uint8).view(dtype)


def quantize_fp8_plain(x, group_size: int = 256, fmt: str = "e4m3", stochastic: bool = True,
                       seed: int = 0, index0: int = 0, law: bool = False):
    """The plain version of K9 on any device: x (numel a multiple of
    ``group_size``) -> (q fp8 (G, group_size), scale (G, 1) f32).
    ``index0`` is the flat index of x's first element in the tensor the
    kernel quantized (the Philox counter of stochastic rounding); ``law``
    rounds stochastically by the float law instead of the kernel's integer
    rule (a check of the two, never the main path)."""
    dtype, fmax, _ = _format(fmt)
    flat = x.reshape(-1, group_size).float()
    # the divisor is a tensor on x's device: CUDA torch turns a division by
    # a Python scalar into a product with its reciprocal, which misses the
    # IEEE quotient in about half the scales
    fmax_t = torch.tensor(fmax, device=x.device)
    scale = flat.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / fmax_t
    y = flat / scale
    if not stochastic:
        return y.to(dtype), scale
    index = torch.arange(index0, index0 + y.numel(), device=x.device).reshape(y.shape)
    codes = _stochastic_codes_law if law else _stochastic_codes
    return codes(y, philox_words(seed, index), fmt), scale


def quantize_fp8(x, group_size: int = 256, fmt: str = "e4m3", stochastic: bool = True,
                 seed: int = 0):
    """x -> (q fp8 of x's shape, scales (groups, 1) fp32). CUDA launches
    count in ``quantize_fp8.launches``."""
    dtype, _, _ = _format(fmt)
    if x.numel() % group_size:
        raise ValueError(f"{x.numel()} elements do not split into groups of {group_size}")
    if x.device.type == "cpu":
        q, scale = quantize_fp8_plain(x, group_size, fmt, stochastic, seed)
        return q.reshape(x.shape), scale
    if x.device.type != "cuda":
        raise ValueError(f"quantize_fp8: no kernel for {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the fp8 quantizer kernel takes f32, bf16 or f16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("quantize_fp8: empty tensor")
    flat = x.reshape(-1).contiguous()
    groups = flat.numel() // group_size
    q = torch.empty(x.shape, dtype=dtype, device=x.device)
    scale = torch.empty((groups, 1), dtype=torch.float32, device=x.device)
    fn = op_builder.load("fp_quantizer").ds_quantize_fp8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_ulonglong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(flat.data_ptr(), q.data_ptr(), scale.data_ptr(), groups, group_size,
             _KERNEL_DTYPES[x.dtype], int(fmt == "e5m2"), int(bool(stochastic)),
             seed & 0xFFFFFFFFFFFFFFFF, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8 quantizer kernel launch failed: cudaError {err}")
    quantize_fp8.launches += 1
    return q, scale


quantize_fp8.launches = 0


def dequantize_fp8(q, scales, orig_dtype=torch.float32, group_size: int = 256):
    flat = q.reshape(-1, group_size).float()
    return (flat * scales).reshape(q.shape).to(orig_dtype)
