"""Fused Adam step over flat f32 buffers.

Mirrors ``deepspeed_tpu/ops/pallas/fused_adam.py``: one pass updates the
params and both moments of one buffer. The port's ``FusedAdam``
(``ops/optimizers.py``) runs its AdamW update through it, one call per
contiguous parameter leaf, in place of the fused elementwise kernel XLA
makes of the JAX ``tree_map`` update.

``fused_adam_flat`` takes the tensors' device as the choice of
implementation: on CUDA tensors it launches the hand-written Hopper kernel
(``csrc/fused_adam.cu``) or raises; on CPU tensors it runs
``fused_adam_flat_plain``. Unlike the TPU kernel it takes any length: the
``n % 128`` split of the JAX wrapper is a TPU tiling limit.
"""

import ctypes

import torch

from . import op_builder


def fused_adam_flat_plain(params, grads, exp_avg, exp_avg_sq, *, step, lr,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    """The plain PyTorch version, in place: the TPU kernel's arithmetic with
    every hyperparameter and the step as an f32 scalar."""
    f32 = torch.float32
    dev = params.device
    lr_, b1, b2, eps_, wd, st = (torch.tensor(x, dtype=f32, device=dev)
                                 for x in (lr, betas[0], betas[1], eps,
                                           weight_decay, step))
    g = grads.to(f32)
    m = b1 * exp_avg + (1.0 - b1) * g
    v = b2 * exp_avg_sq + (1.0 - b2) * g * g
    bc1 = 1.0 - torch.pow(b1, st)
    bc2 = 1.0 - torch.pow(b2, st)
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps_) + wd * params
    params.copy_(params - lr_ * update)
    exp_avg.copy_(m)
    exp_avg_sq.copy_(v)
    return params, exp_avg, exp_avg_sq


def _lib():
    fn = op_builder.load("fused_adam").ds_fused_adam
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_adam_flat(params, grads, exp_avg, exp_avg_sq, *, step, lr,
                    betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    """One AdamW step (bias-corrected, weight decay added to the update) of
    ``params`` with ``grads``, updating ``params``, ``exp_avg`` and
    ``exp_avg_sq`` in place; returns the three. All four are contiguous f32
    tensors of one size (any shape).

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in ``fused_adam_flat.launches``. A tensor that is not
    contiguous (a strided view of a ZeRO shard) raises on either device:
    the kernel reads each buffer as flat memory."""
    for name, t in (("params", params), ("grads", grads), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        if not t.is_contiguous():
            raise ValueError(f"fused_adam_flat: {name} must be contiguous")
    if params.device.type == "cpu":
        return fused_adam_flat_plain(params, grads, exp_avg, exp_avg_sq,
                                     step=step, lr=lr, betas=betas, eps=eps,
                                     weight_decay=weight_decay)
    if params.device.type != "cuda":
        raise ValueError(f"fused_adam_flat: no kernel for {params.device}")
    for name, t in (("params", params), ("grads", grads), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_adam_flat kernel: {name} is {t.dtype}, expected float32")
        if t.device != params.device:
            raise ValueError(f"fused_adam_flat: {name} on {t.device}, params on {params.device}")
        if t.numel() != params.numel():
            raise ValueError(f"fused_adam_flat: {name} has {t.numel()} elements, "
                             f"params {params.numel()}")
    err = _lib()(params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(),
                 exp_avg_sq.data_ptr(), params.numel(), float(lr), float(betas[0]),
                 float(betas[1]), float(eps), float(weight_decay), float(step),
                 torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused adam kernel launch failed: cudaError {err}")
    fused_adam_flat.launches += 1
    return params, exp_avg, exp_avg_sq


fused_adam_flat.launches = 0
