"""Fused weight-only-quantized matmul (mixed-input GEMM).

Mirrors ``deepspeed_tpu/ops/pallas/woq_matmul.py``: the quantized weight
stays packed in device memory and is dequantized tile by tile inside the
matmul, so the full-size bf16 weight never exists. Layouts are the JAX
package's:

- scales are per (K-group, column): ``(K/g, N)`` f32;
- int8: q ``(K, N)`` int8;
- int4: two nibble planes, q ``(K/2, N)``: byte row i holds w[i] (low
  nibble) and w[i + K/2] (high nibble);
- fp6 (e3m2): q ``(3, K/4, N)`` uint8; the 24-bit word at (i, n) packs the
  codes of rows i, i + K/4, i + K/2, i + 3K/4, decoded arithmetically.

``quantize_woq``, ``woq_dequantize`` and the fp6 helpers are plain torch
(load time, plain XLA in JAX). ``woq_matmul`` takes the tensors' device as
the choice of implementation: on CUDA tensors it launches the hand-written
Hopper kernel (``csrc/woq_matmul.cu``, bf16 activations) or raises; on CPU
tensors it runs ``woq_matmul_plain``. The kernel has three routes, chosen
by ``woq_route`` from the shape before the launch: a weight-streaming
kernel for small M, a wgmma mainloop for large M, and the first (SIMT)
design for an N that is no multiple of 16. The JAX wrapper's fallback to
one N tile when ``block_n`` does not divide N has no counterpart: every
route masks a ragged N.
"""

import ctypes

import torch

from . import op_builder

_FP6_MAX = 28.0
_PLANES = {8: 1, 4: 2, 6: 4}
# the kernel's K step (csrc/woq_matmul.cu BK); group sizes are multiples
KERNEL_K_STEP = 32
# output tiles of the simt route and the blocks its split-K launch aims for
_BM, _BN, _TARGET_BLOCKS = 64, 128, 264
ROUTES = ("simt", "stream", "wgmma")
# the largest M the streaming route takes, by bit width; above it the wgmma
# mainloop is faster (the crossover measured on the H100 by chip_smoke.py's
# woq_crossover: PERF.md, section 6)
STREAM_MAX_M = {8: 16, 4: 8, 6: 8}
# the streaming route: columns a block, byte rows a warp step and steps a
# warp prefetches per bit width, the most blocks a cluster takes along K, and
# the shared memory a block may use for its x slice, scales and sums
STREAM_COLS = 128
STREAM_ROWS_PER_STEP = {8: 16, 4: 8, 6: 4}
STREAM_PREFETCH = {8: 4, 4: 8, 6: 4}
STREAM_WARPS = 4
STREAM_BLOCKS_PER_SM = {8: 3, 4: 3, 6: 2}
STREAM_MAX_CLUSTER = 8
STREAM_SMEM_BYTES = 64 * 1024


# ---- quantization (load time, plain torch) -------------------------------

def _group_scales(w, group, qmax):
    k, n = w.shape
    wg = w.reshape(k // group, group, n).float()
    return wg.abs().amax(dim=1).clamp_min(1e-10) / qmax          # (K/g, N)


def _to_int8(v):
    """int32 byte patterns in [0, 255] -> the int8 with those bits."""
    return torch.where(v > 127, v - 256, v).to(torch.int8)


def quantize_woq(w, bits: int = 8, group_size: int = 128):
    """w: (K, N) -> dict(q, scales, bits, group_size, shape).

    K must be divisible by group_size (and by 2 * group_size for int4,
    4 * group_size for fp6: the plane layouts need aligned halves and
    quarters)."""
    k, n = w.shape
    if bits not in _PLANES:
        raise ValueError(f"bits must be 4, 6 or 8, got {bits}")
    if k % (group_size * _PLANES[bits]):
        raise ValueError(f"K={k} must be divisible by {group_size * _PLANES[bits]} "
                         f"for bits={bits}")
    qmax = {8: 127.0, 4: 7.0, 6: _FP6_MAX}[bits]
    scales = _group_scales(w, group_size, qmax)
    x = w.float() / scales.repeat_interleave(group_size, dim=0)
    if bits == 8:
        q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    elif bits == 4:
        qi = torch.clamp(torch.round(x), -7, 7).int()
        q = _to_int8((qi[: k // 2] & 0xF) | ((qi[k // 2:] & 0xF) << 4))   # (K/2, N)
    else:
        codes = _fp6_encode(x)                                 # (K, N) int32 6-bit
        kq = k // 4
        c0, c1, c2, c3 = (codes[i * kq:(i + 1) * kq] for i in range(4))
        word = c0 | (c1 << 6) | (c2 << 12) | (c3 << 18)
        q = torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF]
                        ).to(torch.uint8)                      # (3, K/4, N)
    return {"q": q, "scales": scales, "bits": bits, "group_size": group_size,
            "shape": (k, n)}


def _fp6_encode(x):
    """Nearest e3m2 code (sign + 3-bit exp, bias 3 + 2-bit mantissa) for
    |x| <= 28; arithmetic round-to-nearest (monotone codebook)."""
    ax = x.abs()
    e = torch.clamp(torch.floor(torch.log2(ax.clamp_min(1e-12))) + 3, 0, 7).int()
    ef = e.float()
    step = torch.where(e == 0, 1.0 / 16.0, torch.exp2(ef - 3) / 4)
    base = torch.where(e == 0, 0.0, torch.exp2(ef - 3))
    m = torch.clamp(torch.round((ax - base) / step), 0, 3).int()
    # rounding up past m = 3 bumps the exponent; re-derive via value compare
    v = base + m.float() * step
    nxt_e = torch.clamp_max(e + 1, 7)
    nxt_v = torch.exp2(nxt_e.float() - 3)
    bump = ((ax - nxt_v).abs() < (ax - v).abs()) & (e < 7)
    e = torch.where(bump, nxt_e, e)
    m = torch.where(bump, 0, m)
    code = (e << 2) | m
    return torch.where(x < 0, code | 0x20, code)


def _fp6_decode_f32(code):
    """code int32 in [0, 63] -> f32 value (arithmetic, no gather)."""
    sign = torch.where((code & 0x20) != 0, -1.0, 1.0)
    e = ((code >> 2) & 0x7).float()
    m = (code & 0x3).float()
    mag = torch.where(e == 0, m / 16.0, (1.0 + 0.25 * m) * torch.exp2(e - 3.0))
    return sign * mag


def _unscaled(qstate):
    """The (K, N) f32 codes' values before scaling."""
    q, bits = qstate["q"], qstate["bits"]
    if bits == 8:
        return q.float()
    u = q.int() & 0xFF
    if bits == 4:
        lo, hi = u & 0xF, u >> 4
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        return torch.cat([lo, hi]).float()
    word = u[0] | (u[1] << 8) | (u[2] << 16)
    return torch.cat([_fp6_decode_f32((word >> (6 * i)) & 0x3F) for i in range(4)])


def woq_dequantize(qstate, dtype=torch.bfloat16):
    """Full dequantization (reference and verification path)."""
    s_full = qstate["scales"].repeat_interleave(qstate["group_size"], dim=0)
    return (_unscaled(qstate) * s_full).to(dtype)


# ---- the fused kernel ------------------------------------------------------

def woq_matmul_plain(x, qstate):
    """The plain PyTorch version: every (K-group) tile dequantized and
    rounded to x's dtype, as the TPU kernel does, then one f32-accumulated
    product; (M, N) in x.dtype."""
    w = woq_dequantize(qstate, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def _splitk(m, k, n):
    """(splits, rows per split) of the simt route: enough blocks for the
    card at small M, each split a whole number of kernel K steps."""
    tiles = -(-m // _BM) * -(-n // _BN)
    steps = k // KERNEL_K_STEP
    splits = max(1, min(steps // 4, -(-_TARGET_BLOCKS // tiles)))
    per = -(-steps // splits) * KERNEL_K_STEP
    return -(-k // per), per


def woq_route(m, n, bits, aligned=True):
    """The kernel route for an (M, K) x (K, N) product at ``bits``:
    ``"simt"`` where N is no multiple of 16 or a tensor does not start
    16-byte aligned (the other routes read 16-byte pieces and TMA boxes),
    else ``"stream"`` up to ``STREAM_MAX_M[bits]`` rows and ``"wgmma"``
    above."""
    if n % 16 or not aligned:
        return "simt"
    return "stream" if m <= STREAM_MAX_M[bits] else "wgmma"


def stream_plan(m, k, n, bits, group, sms):
    """(cluster size, steps a block, steps a chunk) of the streaming route.

    A step is 16 k values: ``STREAM_ROWS_PER_STEP[bits]`` byte rows of each
    plane, inside one quantization group (groups are multiples of 32 rows and
    the planes start on group boundaries). A block takes 128 columns and a
    run of whole steps, its 4 warps every fourth step; the blocks of one
    cluster (at most 8) cover K, the last block's run shorter, and sum their
    results in rank order. The cluster is sized so that the blocks fit in
    one wave at ``STREAM_BLOCKS_PER_SM`` blocks an SM (what the registers
    allow), an eighth of the slots spare for placing whole clusters. A
    block stages x and the scales a chunk of steps at a time: a multiple of
    4 x the prefetch depth, as many as fit ``STREAM_SMEM_BYTES`` beside the
    block's sums."""
    pk, rps, u = _PLANES[bits], STREAM_ROWS_PER_STEP[bits], STREAM_PREFETCH[bits]
    steps = k // pk // rps
    tiles = -(-n // STREAM_COLS)
    # an eighth of the slots left free: a cluster's blocks must share a GPC
    slots = 7 * STREAM_BLOCKS_PER_SM[bits] * sms // 8
    cs = max(1, min(STREAM_MAX_CLUSTER, slots // tiles, steps // STREAM_WARPS))
    per = -(-steps // cs)
    cs = -(-steps // per)
    m_pad = 8 if m <= 8 else 16
    unit = STREAM_WARPS * u
    chunk = -(-per // unit) * unit
    while chunk > unit and _stream_smem(m_pad, pk, rps, chunk, group) > STREAM_SMEM_BYTES:
        chunk -= unit
    return cs, per, chunk


def _stream_smem(m_pad, pk, rps, chunk, group):
    """Shared memory of a streaming block: its x slice (padded rows), the
    scale rows a chunk touches in each slab, and its f32 sums."""
    rows = chunk * rps
    return (m_pad * (pk * rows + 16) * 2 + pk * ((rows - 1) // group + 2) * STREAM_COLS * 4
            + m_pad * STREAM_COLS * 4)


_SMS = {}


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def woq_matmul(x, qstate):
    """y = x @ dequant(Wq): x (M, K); returns (M, N) in x.dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel (x
    bf16, group size a multiple of 32) and count the launch in
    ``woq_matmul.launches``."""
    k, n = qstate["shape"]
    bits, g = qstate["bits"], qstate["group_size"]
    q, scales = qstate["q"], qstate["scales"]
    m = x.shape[0]
    if x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match the weight's K={k}")
    if x.device.type == "cpu":
        return woq_matmul_plain(x, qstate)
    if x.device.type != "cuda":
        raise ValueError(f"woq_matmul: no kernel for {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the woq_matmul kernel takes bf16 activations, got {x.dtype} (other "
            "instantiations: ROADMAP.md section A, item 15)")
    if g % KERNEL_K_STEP or k % (g * _PLANES[bits]):
        raise ValueError(f"woq_matmul kernel: group {g} must be a multiple of "
                         f"{KERNEL_K_STEP} and tile K={k} in {_PLANES[bits]} planes")
    want_q = {8: (k, n), 4: (k // 2, n), 6: (3, k // 4, n)}[bits]
    for name, t, shape in (("q", q, want_q), ("scales", scales, (k // g, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scales.dtype != torch.float32 or q.element_size() != 1:
        raise ValueError(f"woq_matmul kernel: q must be bytes and scales f32, got "
                         f"{q.dtype} and {scales.dtype}")
    x = x.contiguous()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q, scales))
    route = woq_route(m, n, bits, aligned)
    sms = _sm_count(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, chunk = None, 1
    if route == "simt":
        splits, per = _splitk(m, k, n)
        if splits > 1:
            part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    elif route == "stream":
        splits, per, chunk = stream_plan(m, k, n, bits, g, sms)
    else:
        splits, per = 1, 1
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = op_builder.load("woq_matmul").ds_woq_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), m, k, n, g, bits,
             ROUTES.index(route), splits, per, chunk, sms, stream)
    if err != 0:
        raise RuntimeError(f"woq_matmul kernel launch failed: cudaError {err}")
    woq_matmul.launches += 1
    return out


woq_matmul.launches = 0
