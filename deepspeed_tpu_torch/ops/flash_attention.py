"""Flash attention (training): forward and backward.

Mirrors ``deepspeed_tpu/ops/pallas/flash_attention.py``: FlashAttention-2
with the softmax scale folded into q before the kernels, the row
log-sum-exp saved by the forward, and a backward of two kernels (dq; dk and
dv) after ``delta = sum(do * out)``. Masks, forward and backward: causal or
not, a static causal sliding window (``rows - cols < window``), in-kernel
ALiBi ``slope * (col - row)``, and segment ids (packed sequences). GQA: k/v
carry KVH heads, dk/dv are summed over each group of H / KVH query heads in
f32, then cast.

Three wrappers, one per kernel, take the tensors' device as the choice of
implementation: on CUDA tensors they launch the hand-written Hopper kernels
(``csrc/flash_attention.cu``; K3 is a wgmma kernel on
``csrc/flash_fwd_wgmma.cuh`` at every head dim, K4 and K5 wgmma kernels on
``csrc/flash_bwd_wgmma.cuh`` at head dims 64 and 128 and wmma ones at 256,
``kernel_info`` says which) or raise; on CPU tensors they run the plain
versions ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain``
(dense f32 math of the same function), which the CPU tests and the card's
comparisons use. Unlike the TPU kernels they take any S >= 1: the tail tile
is masked, where the JAX wrapper requires S to be a multiple of its block.
Fully masked keys get p = 0 explicitly.
"""

import ctypes

import torch

from . import op_builder

# the kernels' compiled head dims (csrc/flash_attention.cu); they take bf16
KERNEL_HEAD_DIMS = (64, 128, 256)


def _scores(q, k, *, causal, segment_ids, alibi_slopes, window):
    """(B, H, S, S) f32 scores of scaled q against k (GQA heads repeated)
    with the ALiBi term, and the (B, 1 or H, S, S) visibility mask."""
    b, s, h, _ = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    sc = qf @ kf.transpose(-1, -2)
    idx = torch.arange(s, device=q.device)
    rows, cols = idx[:, None], idx[None, :]
    if alibi_slopes is not None:
        sc = sc + alibi_slopes.float()[None, :, None, None] * (cols - rows).float()
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rows >= cols)
    if window:
        mask = mask & (rows - cols < window)
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])
    return sc, mask


def flash_attention_fwd_plain(q, k, v, *, causal=True, segment_ids=None,
                              alibi_slopes=None, window=0):
    """The plain forward: q (B, S, H, D) already scaled, k/v (B, S, KVH, D).
    Returns (out (B, S, H, D) in q's dtype, lse (B, H, S) f32). Probabilities
    are rounded to v's dtype before the P.V product, as the kernels do."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    sc, mask = _scores(q, k, causal=causal, segment_ids=segment_ids,
                       alibi_slopes=alibi_slopes, window=window)
    sc = sc.masked_fill(~mask, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)      # no visible key: every p = 0
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    o = (p.to(v.dtype).float() @ vf) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(l), float("inf")).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, do, lse, delta, *, causal=True,
                              segment_ids=None, alibi_slopes=None, window=0):
    """The plain backward from the saved ``lse`` and ``delta`` (B, H, S):
    returns (dq, dk, dv) in the dtypes of q, k, v. ds is rounded to q's
    dtype and p to do's before their products, as the kernels do."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sc, mask = _scores(q, k, causal=causal, segment_ids=segment_ids,
                       alibi_slopes=alibi_slopes, window=window)
    p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
    dof = do.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = ds @ kf
    dv_h = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dk_h = ds.transpose(-1, -2) @ q.float().transpose(1, 2)
    dk = dk_h.reshape(b, kvh, g, s, d).sum(dim=2)
    dv = dv_h.reshape(b, kvh, g, s, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _fn(name, n_ptrs):
    fn = getattr(op_builder.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, segment_ids, alibi_slopes, extra):
    """Raise unless the kernels take these CUDA tensors: bf16, D in
    KERNEL_HEAD_DIMS, contiguous, one device, 16-byte aligned rows."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash attention kernels are bf16; {q.dtype} instantiations are not "
            "ported yet (ROADMAP.md section A, item 16)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    want = {"q": (q, (b, s, h, d)), "k": (k, (b, s, kvh, d)), "v": (v, (b, s, kvh, d))}
    want.update(extra)
    for name, (t, shape) in want.items():
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected bf16 {shape}")
    for name, t, dtype, shape in (("segment_ids", segment_ids, torch.int32, (b, s)),
                                  ("alibi_slopes", alibi_slopes, torch.float32, (h,))):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
    tensors = [t for t, _ in want.values()] + [t for t in (segment_ids, alibi_slopes)
                                               if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash attention: tensors on {t.device} and {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention kernel takes contiguous 16-byte aligned tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dims(q, k, causal, window):
    b, s, h, d = q.shape
    return b, s, h, k.shape[2], d, int(bool(causal)), int(window or 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")


def flash_attention_fwd(q, k, v, *, causal=True, segment_ids=None,
                        alibi_slopes=None, window=0):
    """K3: (out (B, S, H, D), lse (B, H, S) f32) of scaled q against k, v.
    ``segment_ids`` (B, S) int32, ``alibi_slopes`` (H,) f32, ``window`` > 0
    a causal sliding window (0: none). CUDA launches count in
    ``flash_attention_fwd.launches``."""
    kw = dict(causal=causal, segment_ids=segment_ids, alibi_slopes=alibi_slopes,
              window=window)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    _require_cuda(q, "flash_attention_fwd")
    _check(q, k, v, segment_ids, alibi_slopes, {})
    b, s, h, _, _, _, _ = dims = _dims(q, k, causal, window)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fn("ds_flash_fwd", 7)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 _ptr(alibi_slopes), _ptr(segment_ids),
                                 out.data_ptr(), lse.data_ptr(), *dims, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention fwd kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_check(q, k, v, do, lse, delta, segment_ids, alibi_slopes):
    b, s, h, d = q.shape
    _check(q, k, v, segment_ids, alibi_slopes, {"do": (do, (b, s, h, d))})
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous float32 {(b, h, s)} on {q.device}")


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=True, segment_ids=None,
                       alibi_slopes=None, window=0):
    """K4: dq (B, S, H, D) from the saved ``lse`` and ``delta`` (B, H, S)
    f32. CUDA launches count in ``flash_attention_dq.launches``."""
    kw = dict(causal=causal, segment_ids=segment_ids, alibi_slopes=alibi_slopes,
              window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)[0]
    _require_cuda(q, "flash_attention_dq")
    _bwd_check(q, k, v, do, lse, delta, segment_ids, alibi_slopes)
    dq = torch.empty_like(q)
    err = _fn("ds_flash_dq", 9)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), _ptr(alibi_slopes),
                                _ptr(segment_ids), dq.data_ptr(),
                                *_dims(q, k, causal, window), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention dq kernel launch failed: cudaError {err}")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=True, segment_ids=None,
                        alibi_slopes=None, window=0):
    """K5: (dk, dv) (B, S, KVH, D), each summed over its group of query
    heads in f32. CUDA launches count in ``flash_attention_dkv.launches``."""
    kw = dict(causal=causal, segment_ids=segment_ids, alibi_slopes=alibi_slopes,
              window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    _require_cuda(q, "flash_attention_dkv")
    _bwd_check(q, k, v, do, lse, delta, segment_ids, alibi_slopes)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _fn("ds_flash_dkv", 10)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), _ptr(alibi_slopes),
                                  _ptr(segment_ids), dk.data_ptr(), dv.data_ptr(),
                                  *_dims(q, k, causal, window), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention dk/dv kernel launch failed: cudaError {err}")
    flash_attention_dkv.launches += 1
    return dk, dv


for _f in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
    _f.launches = 0

_KINDS = {"fwd": 0, "dq": 1, "dkv": 2}


def kernel_info(kind, d):
    """The CUDA kernel that the ``kind`` ("fwd", "dq" or "dkv") wrapper
    launches at head dim ``d``, as the built library reports it: its
    ``variant`` ("wgmma" for the Hopper forward, and for dq and dk/dv at
    head dims 64 and 128; "wmma" for dq and dk/dv at 256),
    ``smem_bytes`` (dynamic shared memory a block) and ``threads`` a block.
    Builds the library if needed."""
    info = (ctypes.c_int * 3)()
    fn = op_builder.load("flash_attention").ds_flash_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(_KINDS[kind], int(d), info) != 0:
        raise ValueError(f"flash attention: no {kind} kernel at head dim {d}")
    return {"variant": "wgmma" if info[0] else "wmma", "smem_bytes": info[1],
            "threads": info[2]}


class _FlashAttention(torch.autograd.Function):
    """Scale-free core (q arrives scaled): the JAX ``_flash_bhsd`` custom_vjp.
    Slopes and segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, seg, causal, window):
        kw = dict(causal=causal, segment_ids=seg, alibi_slopes=slopes, window=window)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, slopes, seg)
        ctx.kw = (causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, slopes, seg = ctx.saved_tensors
        causal, window = ctx.kw
        kw = dict(causal=causal, segment_ids=seg, alibi_slopes=slopes, window=window)
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, segment_ids=None, scale=None,
                    alibi_slopes=None, window=None):
    """q: (B, S, H, D); k/v: (B, S, KVH, D) -> (B, S, H, D), differentiable
    in q, k and v.

    ``window``: a static positive int, causal only (the JAX contract).
    ``alibi_slopes``: (H,) per-head slopes, the bias built in-kernel; not
    differentiated. The softmax scale (default D^-0.5) is folded into q in
    q's dtype before the kernels, as the JAX wrapper does."""
    if window is not None:
        if not causal:
            raise NotImplementedError("flash sliding window is causal-only")
        if not isinstance(window, int) or window <= 0:
            raise ValueError("flash window must be a static positive int")
    b, s, h, d = q.shape
    if k.shape != (b, s, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)} with the same sequence length")
    scale = scale if scale is not None else d ** -0.5
    qs = q * torch.tensor(scale, dtype=q.dtype)
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    return _FlashAttention.apply(qs.contiguous(), k.contiguous(), v.contiguous(),
                                 alibi_slopes, segment_ids, bool(causal), int(window or 0))
