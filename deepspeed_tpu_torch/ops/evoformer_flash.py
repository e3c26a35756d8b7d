"""Evoformer (DS4Science) bias-flash attention forward.

Mirrors ``deepspeed_tpu/ops/pallas/evoformer_flash.py`` (the reference's
CUTLASS kernel under ``csrc/deepspeed4science/evoformer_attn``):
AlphaFold-style attention over (B, N, H, S, D) MSA activations with a
per-row mask bias (B, N, 1, 1, S) and a pairwise bias (B, 1, H, S, S) shared
over the N rows, folded into the logits inside the kernel, so the
(B, N, H, S, S) logits never reach device memory.

``evoformer_flash_fwd`` takes the tensors' device as the choice of
implementation: on CUDA tensors it launches the hand-written Hopper kernel
(``csrc/evoformer_flash.cu``, K12) or raises; on CPU tensors it runs
``evoformer_flash_plain``. The backward pass is the query-chunked recompute
of ``ops/evoformer.py``, as in JAX.
"""

import ctypes

import torch

from . import op_builder

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
KERNEL_HEAD_DIMS = (64, 128, 256)   # the kernel's compiled head dims; it takes bf16


def evoformer_flash_supported(s, d, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K) -> bool:
    """The JAX dispatch rule, kept as the port's: S a multiple of 128, D in
    {64, 128, 256}, and S divisible by both of the TPU kernel's blocks."""
    if s % 128 != 0 or d not in (64, 128, 256):
        return False
    bq, bk = min(block_q, s), min(block_k, s)
    return s % bq == 0 and s % bk == 0


def prescale(q, scale):
    """q times ``scale`` rounded to q's dtype, as the JAX wrapper's
    ``q * jnp.asarray(scale, q.dtype)`` and the weak-typed ``q * scale`` of
    the chunked path compute it (in bf16 the scale itself is rounded)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def evoformer_flash_plain(q, k, v, bias1, bias2, *, scale):
    """The plain version of K12: q/k/v (B, N, H, S, D) head-major, bias1
    (B, N, 1, 1, S) or None, bias2 (B, 1, H, S, S) or None -> (B, N, H, S, D)
    in q's dtype. f32 logits of the pre-scaled q plus the biases, softmax
    with the max floored at -1e30 (a row of -inf logits gives 0), p rounded
    to v's dtype before P.V."""
    logits = prescale(q, scale).float() @ k.float().transpose(-1, -2)
    if bias1 is not None:
        logits = logits + bias1.float()
    if bias2 is not None:
        logits = logits + bias2.float()
    m = logits.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(v.dtype).float() @ v.float()) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


def _check(q, k, v, bias1, bias2):
    """Raise unless the kernel takes these CUDA tensors."""
    b, n, h, s, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"evoformer_flash_fwd: no kernel for {q.device}")
    if not evoformer_flash_supported(s, d):
        raise ValueError(f"evoformer kernel: S {s}, D {d} not eligible "
                         "(evoformer_flash_supported)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the evoformer kernel is bf16; {name} is {t.dtype}, not ported yet "
                "(ROADMAP.md section B)")
        if tuple(t.shape) != (b, n, h, s, d):
            raise ValueError(f"{name}: {tuple(t.shape)}, expected {(b, n, h, s, d)}")
        if t.stride(4) != 1 or any(st % 8 for st in t.stride()[:4]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows with D contiguous")
    for name, t, shape in (("bias1", bias1, (b, n, 1, 1, s)), ("bias2", bias2, (b, 1, h, s, s))):
        if t is not None and (tuple(t.shape) != shape or not t.is_floating_point()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected float {shape}")
    for t in (k, v, bias1, bias2):
        if t is not None and t.device != q.device:
            raise ValueError(f"evoformer_flash_fwd: tensors on {t.device} and {q.device}")
    if b * n > 65535:
        raise ValueError(f"evoformer kernel: B * N = {b * n} exceeds the grid's 65535")


def evoformer_flash_fwd(q, k, v, bias1, bias2, *, scale):
    """K12. q/k/v: (B, N, H, S, D) head-major (any strides with D
    contiguous: a ``movedim`` view of (B, N, S, H, D) storage is read in
    place); bias1 (B, N, 1, 1, S) or None; bias2 (B, 1, H, S, S) or None,
    any float dtype (read as f32). Returns (B, N, H, S, D) in q's dtype, a
    view of (B, N, S, H, D) storage. CUDA launches count in
    ``evoformer_flash_fwd.launches``."""
    if q.device.type == "cpu":
        return evoformer_flash_plain(q, k, v, bias1, bias2, scale=scale)
    _check(q, k, v, bias1, bias2)
    b, n, h, s, d = q.shape
    qs = prescale(q, scale)
    out = torch.empty((b, n, s, h, d), dtype=q.dtype, device=q.device).movedim(3, 2)
    b1 = None if bias1 is None else bias1.float().contiguous()
    b2 = None if bias2 is None else bias2.float().contiguous()
    strides = (ctypes.c_longlong * 16)(*[st for t in (qs, k, v, out) for st in t.stride()[:4]])
    fn = op_builder.load("evoformer_flash").ds_evoformer_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None if b1 is None else b1.data_ptr(),
             None if b2 is None else b2.data_ptr(), out.data_ptr(), strides, b, n, h, s, d,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"evoformer attention kernel launch failed: cudaError {err}")
    evoformer_flash_fwd.launches += 1
    return out


evoformer_flash_fwd.launches = 0
