"""Ring attention with the flash continuation kernels.

Mirrors ``deepspeed_tpu/sequence/ring_flash.py``. Each of the ``seq``
sequence shards holds its queries; K/V shards travel around the ring, and
at every step each query shard folds the visiting K/V shard into its
online-softmax carry (m, l, acc) with one kernel launch (K13), so scores
exist only as tiles inside the kernel. Masks come from global positions
(``q_off``, ``k_off``): causal, a static sliding window, ALiBi
``slope * (col - row)`` and segment ids, which travel with their K/V shard.
The backward is a second ring: dq accumulates locally (K14), and the f32
dK/dV accumulators travel with their K/V shard, each step adding its share
(K15) before the rotation, so after ``seq`` steps every accumulator is home
with every shard's contribution.

The ring's transport. JAX places one shard on each device of the mesh's
``seq`` axis, and one JAX process may drive several of those devices. The
port's counterpart: a process holds ``seq / world size`` consecutive shards
(its local shards) on its own device. ``RingTransport.rotate`` shifts the
process's list of shards by one place; with a process group it also sends
its last shard's tensors to the next process and receives the previous
process's in one ``batch_isend_irecv``. One process (group None) holds
every shard, and each kernel launch has the shapes and global offsets that
one rank of a ring over ``seq`` cards would launch.

Three wrappers, one per kernel, take the tensors' device as the choice of
implementation: on CUDA tensors they launch the hand-written Hopper kernels
(``ops/csrc/ring_flash.cu``; K13 is a wgmma kernel on
``ops/csrc/flash_fwd_wgmma.cuh`` at every head dim, K14 and K15 are wgmma
kernels at head dims 64 and 128 and wmma ones at 256, ``kernel_info`` says
which) or raise; on CPU tensors they run the plain
versions ``ring_fwd_step_plain`` / ``ring_bwd_step_plain`` (dense f32 math
of one ring step with the same masks). Every kernel and plain version
updates its f32 outputs in place: the forward carry, and the dq, dk and dv
accumulators (JAX aliases the carry and adds the step's gradients outside
the kernels). The accumulators take the layout of the tensor they belong
to: acc and dq (B, Sq, H, D), dk and dv (B, Sk, KVH, D).
"""

import ctypes

import torch

from ..comm import comm
from ..ops import op_builder

NEG_INF = -1e30

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
KERNEL_HEAD_DIMS = (64, 128, 256)   # the kernels' compiled head dims; they take bf16


def _cdiv(a, b):
    return -(-a // b)


def _clip(x, lo, hi):
    return max(lo, min(x, hi))


def _global_q_ranges(rows_base, k_off, block_q, block_k, num_kv, window):
    """KV-block loop bounds for the q block starting at GLOBAL row
    ``rows_base`` against a kv shard starting at GLOBAL col ``k_off``:
    (kv_lo, full_lo, full_hi, kv_hi); [full_lo, full_hi) is mask-free. The
    CUDA kernels walk the same ranges (``key_range``, ``tile_masked``)."""
    kv_hi = _clip(_cdiv(rows_base + block_q - k_off, block_k), 0, num_kv)
    n_full = _clip((rows_base - k_off) // block_k, 0, num_kv)
    if window is None:
        return 0, 0, n_full, kv_hi
    kv_lo = _clip((rows_base - window + 1 - k_off) // block_k, 0, num_kv)
    full_lo = _clip(_cdiv(rows_base + block_q - window - k_off, block_k), kv_lo, kv_hi)
    full_hi = _clip(n_full, full_lo, kv_hi)
    return kv_lo, full_lo, full_hi, kv_hi


def _step_sees_any(q_off, k_off, sq, sk, window):
    """Whether any row of the query shard sees a key of the kv shard: the
    bounds of ``_global_q_ranges`` with the whole shards as one block."""
    kv_lo, _, _, kv_hi = _global_q_ranges(q_off, k_off, sq, sk, 1, window or None)
    return kv_lo < kv_hi


def ring_flash_supported(sq_local, sk_local, d, window, block_q=DEFAULT_BLOCK_Q,
                         block_k=DEFAULT_BLOCK_K) -> bool:
    """The JAX eligibility rule, kept as the port's: shard sizes must tile
    by the TPU kernel's blocks, D in {64, 128, 256}, and the window a static
    int (a tensor window takes the einsum ring)."""
    bq = min(block_q, sq_local)
    bk = min(block_k, sk_local)
    if sq_local % bq or sk_local % bk:
        return False
    if d not in KERNEL_HEAD_DIMS:
        return False
    if window is not None and not isinstance(window, int):
        return False
    return True


# ---------------------------------------------------------------- plain versions

def _head_scores(q, k, kh, g, *, q_off, k_off, slopes, qseg, kseg, window):
    """f32 scores (B, G, Sq, Sk) of kv head ``kh``'s group of query heads
    against its keys, with the ALiBi term, and the (B, 1, Sq, Sk)
    visibility mask from global positions."""
    sq, sk = q.shape[1], k.shape[1]
    heads = slice(kh * g, (kh + 1) * g)
    qh = q[:, :, heads].float().permute(0, 2, 1, 3).contiguous()         # (B, G, Sq, D)
    kf = k[:, :, kh].float().contiguous()                                 # (B, Sk, D)
    s = qh @ kf.transpose(-1, -2)[:, None]
    rows = q_off + torch.arange(sq, device=q.device)[:, None]
    cols = k_off + torch.arange(sk, device=q.device)[None, :]
    if slopes is not None:
        s = s + slopes[heads].float()[None, :, None, None] * (cols - rows).float()
    mask = rows >= cols
    if window:
        mask = mask & (rows - cols < window)
    mask = mask[None, None]
    if qseg is not None:
        mask = mask & (qseg[:, None, :, None] == kseg[:, None, None, :])
    return qh, s, mask


def ring_fwd_step_plain(q, k, v, m, l, acc, *, q_off, k_off, slopes=None, qseg=None,
                        kseg=None, window=0):
    """The plain K13: fold the kv shard into the carry, in place. q (B, Sq,
    H, D) already scaled, k/v (B, Sk, KVH, D); m, l (B, H, Sq) f32, acc
    (B, Sq, H, D) f32. p is rounded to v's dtype before the P.V product,
    as the kernel does. One kv head's group at a time."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if not _step_sees_any(q_off, k_off, sq, sk, window):
        return m, l, acc                     # alpha = 1, p = 0: the carry as it is
    g = h // kvh
    kw = dict(q_off=q_off, k_off=k_off, slopes=slopes, qseg=qseg, kseg=kseg, window=window)
    for kh in range(kvh):
        heads = slice(kh * g, (kh + 1) * g)
        _, s, mask = _head_scores(q, k, kh, g, **kw)
        s = s.masked_fill(~mask, float("-inf"))
        m_old = m[:, heads]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l[:, heads] = l[:, heads] * alpha + p.sum(dim=-1)
        pv = p.to(v.dtype).float() @ v[:, :, kh].float().contiguous()[:, None]   # (B, G, Sq, D)
        acc[:, :, heads] = (acc[:, :, heads] * alpha.transpose(1, 2)[..., None]
                            + pv.transpose(1, 2))
        m[:, heads] = m_new
    return m, l, acc


def ring_bwd_step_plain(q, k, v, do, lse, delta, dq=None, dk=None, dv=None, *, q_off, k_off,
                        slopes=None, qseg=None, kseg=None, window=0):
    """The plain K14 and K15: add one step's gradients into the f32
    accumulators given (dq (B, Sq, H, D); dk, dv (B, Sk, KVH, D), summed over
    each group of query heads), in place, from the saved ``lse`` and
    ``delta`` (B, H, Sq) f32. ds is rounded to q's dtype and p to do's
    before their products, as the kernels do."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if not _step_sees_any(q_off, k_off, sq, sk, window):
        return dq, dk, dv
    g = h // kvh
    kw = dict(q_off=q_off, k_off=k_off, slopes=slopes, qseg=qseg, kseg=kseg, window=window)
    for kh in range(kvh):
        heads = slice(kh * g, (kh + 1) * g)
        qh, s, mask = _head_scores(q, k, kh, g, **kw)
        p = torch.where(mask, torch.exp(s - lse[:, heads, :, None]), 0.0)
        dof = do[:, :, heads].float().permute(0, 2, 1, 3).contiguous()      # (B, G, Sq, D)
        dp = dof @ v[:, :, kh].float().contiguous().transpose(-1, -2)[:, None]
        ds = (p * (dp - delta[:, heads, :, None])).to(q.dtype).float()
        if dq is not None:
            dq[:, :, heads] += (ds @ k[:, :, kh].float().contiguous()[:, None]).transpose(1, 2)
        if dv is not None:
            dv[:, :, kh] += (p.to(do.dtype).float().transpose(-1, -2) @ dof).sum(dim=1)
        if dk is not None:
            dk[:, :, kh] += (ds.transpose(-1, -2) @ qh).sum(dim=1)
    return dq, dk, dv


# ---------------------------------------------------------------- kernel wrappers

def _check(q, k, v, carry, extra, qseg, kseg, slopes):
    """Raise unless the kernels take these CUDA tensors. ``carry``: the f32
    tensors read and written in place, {name: (tensor, shape)}, contiguous;
    ``extra``: further bf16 inputs laid out like q."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"ring flash attention: no kernel for {q.device}")
    bf16 = {"q": (q, (b, sq, h, d)), "k": (k, (b, sk, kvh, d)), "v": (v, (b, sk, kvh, d))}
    bf16.update(extra)
    for name, (t, shape) in bf16.items():
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the ring flash kernels are bf16; {name} is {t.dtype}, not ported yet "
                "(ROADMAP.md section B)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ring flash kernel: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if b > 65535 or max(sq, sk) * max(h, kvh) * d >= 2 ** 31:
        raise ValueError(f"ring flash kernel: shapes {tuple(q.shape)} / {tuple(k.shape)} too large")
    for name, (t, shape) in bf16.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)}, expected {shape}")
        if (t.stride(3) != 1 or t.stride(2) != d or t.stride(0) % 8 or t.stride(1) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernels read 16-byte aligned rows of contiguous heads")
    for name, (t, shape) in carry.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected contiguous "
                             f"float32 {shape}")
    if (qseg is None) != (kseg is None):
        raise ValueError("qseg and kseg come together")
    for name, t, shape, dtype in (("qseg", qseg, (b, sq), torch.int32),
                                  ("kseg", kseg, (b, sk), torch.int32),
                                  ("slopes", slopes, (h,), torch.float32)):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected contiguous "
                             f"{dtype} {shape}")
    tensors = [t for t, _ in list(bf16.values()) + list(carry.values())]
    for t in tensors + [t for t in (qseg, kseg, slopes) if t is not None]:
        if t.device != q.device:
            raise ValueError(f"ring flash attention: tensors on {t.device} and {q.device}")


def _fn(name, n_ptrs, n_outs):
    fn = getattr(op_builder.load("ring_flash"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (n_ptrs + n_outs) + [ctypes.c_void_p]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(*ts):
    """Batch and row strides of q, k, v and do (0 for an absent do)."""
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1)] if t is not None else [0, 0]
    return (ctypes.c_longlong * 8)(*vals)


def _dims(q, k, q_off, k_off, window):
    b, sq, h, d = q.shape
    return b, sq, k.shape[1], h, k.shape[2], d, int(q_off), int(k_off), int(window or 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ring_fwd_step(q, k, v, m, l, acc, *, q_off, k_off, slopes=None, qseg=None, kseg=None,
                  window=0):
    """K13: fold one kv shard into the carry (m, l (B, H, Sq) and acc
    (B, Sq, H, D), f32, updated in place). q (B, Sq, H, D) already scaled
    and k/v (B, Sk, KVH, D) may be views with strided batch and rows;
    ``q_off`` / ``k_off`` are the shards' first global positions; qseg
    (B, Sq) / kseg (B, Sk) int32 and slopes (H,) f32 optional; ``window``
    > 0 a causal sliding window. CUDA launches count in
    ``ring_fwd_step.launches``."""
    kw = dict(q_off=q_off, k_off=k_off, slopes=slopes, qseg=qseg, kseg=kseg, window=window)
    if q.device.type == "cpu":
        return ring_fwd_step_plain(q, k, v, m, l, acc, **kw)
    b, sq, h, d = q.shape
    _check(q, k, v, {"m": (m, (b, h, sq)), "l": (l, (b, h, sq)), "acc": (acc, (b, sq, h, d))},
           {}, qseg, kseg, slopes)
    err = _fn("ds_ring_fwd", 6, 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(slopes), _ptr(qseg), _ptr(kseg),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), _strides(q, k, v, None),
        *_dims(q, k, q_off, k_off, window), _stream(q))
    if err != 0:
        raise RuntimeError(f"ring flash fwd kernel launch failed: cudaError {err}")
    ring_fwd_step.launches += 1
    return m, l, acc


def _bwd_carry(q, k, lse, delta, outs):
    b, sq, h, d = q.shape
    carry = {"lse": (lse, (b, h, sq)), "delta": (delta, (b, h, sq))}
    for name, t in outs.items():
        carry[name] = (t, (b, sq, h, d) if name == "dq" else tuple(k.shape))
    return carry


def ring_dq_step(q, k, v, do, lse, delta, dq, *, q_off, k_off, slopes=None, qseg=None,
                 kseg=None, window=0):
    """K14: add one step's dq into the f32 accumulator ``dq`` (B, Sq, H, D)
    in place, from the saved ``lse`` and ``delta`` (B, H, Sq) f32. CUDA
    launches count in ``ring_dq_step.launches``."""
    kw = dict(q_off=q_off, k_off=k_off, slopes=slopes, qseg=qseg, kseg=kseg, window=window)
    if q.device.type == "cpu":
        return ring_bwd_step_plain(q, k, v, do, lse, delta, dq, **kw)[0]
    _check(q, k, v, _bwd_carry(q, k, lse, delta, {"dq": dq}),
           {"do": (do, tuple(q.shape))}, qseg, kseg, slopes)
    err = _fn("ds_ring_dq", 9, 1)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(slopes), _ptr(qseg), _ptr(kseg), dq.data_ptr(),
        _strides(q, k, v, do), *_dims(q, k, q_off, k_off, window), _stream(q))
    if err != 0:
        raise RuntimeError(f"ring flash dq kernel launch failed: cudaError {err}")
    ring_dq_step.launches += 1
    return dq


def ring_dkv_step(q, k, v, do, lse, delta, dk, dv, *, q_off, k_off, slopes=None, qseg=None,
                  kseg=None, window=0):
    """K15: add one step's dk and dv, each summed over its group of query
    heads, into the f32 accumulators ``dk``, ``dv`` (B, Sk, KVH, D) in
    place. CUDA launches count in ``ring_dkv_step.launches``."""
    kw = dict(q_off=q_off, k_off=k_off, slopes=slopes, qseg=qseg, kseg=kseg, window=window)
    if q.device.type == "cpu":
        return ring_bwd_step_plain(q, k, v, do, lse, delta, None, dk, dv, **kw)[1:]
    _check(q, k, v, _bwd_carry(q, k, lse, delta, {"dk": dk, "dv": dv}),
           {"do": (do, tuple(q.shape))}, qseg, kseg, slopes)
    err = _fn("ds_ring_dkv", 9, 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(slopes), _ptr(qseg), _ptr(kseg), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do), *_dims(q, k, q_off, k_off, window), _stream(q))
    if err != 0:
        raise RuntimeError(f"ring flash dk/dv kernel launch failed: cudaError {err}")
    ring_dkv_step.launches += 1
    return dk, dv


for _f in (ring_fwd_step, ring_dq_step, ring_dkv_step):
    _f.launches = 0

_KINDS = {"fwd": 0, "dq": 1, "dkv": 2}


def kernel_info(kind, d):
    """The CUDA kernel that the ``kind`` ("fwd", "dq" or "dkv") wrapper
    launches at head dim ``d``, as the built library reports it: its
    ``variant`` ("wgmma" for the Hopper forward, and for dq and dk/dv at D 64
    and 128; "wmma" otherwise), ``smem_bytes`` (dynamic shared memory a block) and
    ``threads`` a block. Builds the library if needed."""
    info = (ctypes.c_int * 3)()
    fn = op_builder.load("ring_flash").ds_ring_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(_KINDS[kind], int(d), info) != 0:
        raise ValueError(f"ring flash: no {kind} kernel at head dim {d}")
    return {"variant": "wgmma" if info[0] else "wmma", "smem_bytes": info[1],
            "threads": info[2]}


def _bwd_step(q, k, v, do, lse, delta, dq, dk, dv, **kw):
    """One step's gradients into the three accumulators: K14 and K15 on the
    card, the plain backward once on the CPU."""
    if q.device.type == "cpu":
        return ring_bwd_step_plain(q, k, v, do, lse, delta, dq, dk, dv, **kw)
    ring_dq_step(q, k, v, do, lse, delta, dq, **kw)
    ring_dkv_step(q, k, v, do, lse, delta, dk, dv, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------- the ring

class _RingShift(torch.autograd.Function):
    """One ring exchange to the next process, differentiable: the gradients
    travel the other way round."""

    @staticmethod
    def forward(ctx, group, *tensors):
        out = tuple(comm.ring_send_recv(tensors, group, 1))
        ctx.ring = (group, [(o.shape, o.dtype, o.device) for o in out])
        return out

    @staticmethod
    def backward(ctx, *grads):
        group, out = ctx.ring
        grads = [torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
                 for g, (shape, dtype, dev) in zip(grads, out)]
        return (None, *comm.ring_send_recv(grads, group, -1))


class RingTransport:
    """The ring over ``size`` sequence shards. A process holds ``size /
    world size`` consecutive shards of it; ``ranks`` are their global ring
    ranks, in order. ``group``: the process group the ring spans (None: one
    process holds every shard)."""

    def __init__(self, size, group=None):
        procs = comm.get_world_size(group) if group is not None else 1
        if size < 1 or size % procs:
            raise ValueError(f"a ring of {size} shards does not split over {procs} processes")
        local = size // procs
        first = (comm.get_rank(group) if group is not None else 0) * local
        self.size, self.group, self.procs = size, group, procs
        self.ranks = list(range(first, first + local))

    def rotate(self, shards):
        """``shards``: one tuple of tensors (or None) per local shard, in
        ring order. Every tuple moves one place around the ring: local shard
        i takes the tuple of shard i - 1, and the first local shard the last
        one of the previous process (by one ``comm.ring_send_recv``; the
        process's own last one when it holds the whole ring)."""
        edge = shards[-1]
        if self.procs > 1:
            present = [t for t in edge if t is not None]
            moved = iter(_RingShift.apply(self.group, *present))
            edge = tuple(None if t is None else next(moved) for t in edge)
        return [edge] + list(shards[:-1])


def _shards(x, n):
    """``n`` equal views of x along its sequence dim (dim 1), or Nones."""
    return [None] * n if x is None else list(x.chunk(n, dim=1))


def _ring_fwd_local(q, k, v, seg, slopes, transport, window):
    """This process's part of the ring forward. q (B, S_p, H, D)
    pre-scaled, k/v (B, S_p, KVH, D), seg (B, S_p) int32 or None, where
    S_p is the local shards' tokens. Returns (out (B, S_p, H, D),
    lse (L, B, H, Sq) f32 for the L local shards)."""
    n, local = transport.size, len(transport.ranks)
    b, sp, h, d = q.shape
    sq, sk = sp // local, k.shape[1] // local
    qs, segs = _shards(q, local), [None if s is None else s.contiguous()
                                   for s in _shards(seg, local)]
    kv = list(zip(_shards(k, local), _shards(v, local), segs))
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((local, b, h, sq), NEG_INF, **f32)
    l = torch.zeros((local, b, h, sq), **f32)
    acc = [torch.zeros((b, sq, h, d), **f32) for _ in range(local)]
    for step in range(n):
        for i, rank in enumerate(transport.ranks):
            k_blk, v_blk, kseg_blk = kv[i]
            ring_fwd_step(qs[i], k_blk, v_blk, m[i], l[i], acc[i], q_off=rank * sq,
                          k_off=(rank - step) % n * sk, slopes=slopes, qseg=segs[i],
                          kseg=kseg_blk, window=window)
        if step < n - 1:
            kv = transport.rotate(kv)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.cat([(a / ls.transpose(1, 2)[..., None]).to(q.dtype)
                     for a, ls in zip(acc, l_safe)], dim=1)
    return out, m + torch.log(l_safe)


class _RingFlash(torch.autograd.Function):
    """The JAX ``_ring_flash_local`` custom_vjp: q arrives scaled; slopes
    and segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, slopes, transport, window):
        out, lse = _ring_fwd_local(q, k, v, seg, slopes, transport, window)
        ctx.save_for_backward(q, k, v, seg, slopes, out, lse)
        ctx.ring = (transport, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, slopes, out, lse = ctx.saved_tensors
        transport, window = ctx.ring
        n, local = transport.size, len(transport.ranks)
        b, sp, h, d = q.shape
        sq, sk = sp // local, k.shape[1] // local
        do = g.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)                 # (B, S_p, H)
        deltas = [t.transpose(1, 2).contiguous() for t in _shards(delta, local)]
        qs, dos = _shards(q, local), _shards(do, local)
        segs = [None if s is None else s.contiguous() for s in _shards(seg, local)]
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = [torch.zeros((b, sq, h, d), **f32) for _ in range(local)]
        kvg = [(kb, vb, sg, torch.zeros(kb.shape, **f32), torch.zeros(kb.shape, **f32))
               for kb, vb, sg in zip(_shards(k, local), _shards(v, local), segs)]
        for step in range(n):
            for i, rank in enumerate(transport.ranks):
                k_blk, v_blk, kseg_blk, dk_acc, dv_acc = kvg[i]
                _bwd_step(qs[i], k_blk, v_blk, dos[i], lse[i], deltas[i], dq[i], dk_acc, dv_acc,
                          q_off=rank * sq, k_off=(rank - step) % n * sk, slopes=slopes,
                          qseg=segs[i], kseg=kseg_blk, window=window)
            # add BEFORE rotating: each accumulator collects every shard's
            # share as it travels and is home after n rotations
            kvg = transport.rotate(kvg if step < n - 1 else
                                   [(None, None, None, t[3], t[4]) for t in kvg])
        dk = torch.cat([t[3] for t in kvg], dim=1).to(k.dtype)
        dv = torch.cat([t[4] for t in kvg], dim=1).to(v.dtype)
        return torch.cat(dq, dim=1).to(q.dtype), dk, dv, None, None, None, None


def ring_flash_body(q, k, v, seg=None, *, transport, scale, window, slopes):
    """Ring attention through the flash kernels over this process's local
    shards: q (B, S_p, H, D), k/v (B, S_p, KVH, D), seg (B, S_p) or None ->
    (B, S_p, H, D). ``window``: None or a static positive int; ``slopes``:
    (H,) f32 ALiBi slopes on q's device or None (not differentiated). q is
    scaled in its
    dtype first, the scale rounded to it (as JAX's
    ``q * jnp.asarray(scale, q.dtype)``)."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    if seg is not None:
        seg = seg.to(device=q.device, dtype=torch.int32)
    return _RingFlash.apply(qs, k, v, seg, slopes, transport, int(window or 0))
