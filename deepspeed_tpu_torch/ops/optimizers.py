"""Fused optimizers: Adam and AdamW.

Mirrors the Adam part of ``deepspeed_tpu/ops/optimizers.py`` with the same
functional protocol over nested dicts of tensors:

    opt = FusedAdam(lr=..., ...)
    state = opt.init(params)                  # {"step": 0, "slots": tree}
    params, state = opt.apply(grads, state, params, lr=lr)

Where JAX returns new trees, the port updates the parameters and the slots
in place (no second copy of 16 bytes per parameter) and returns the same
trees. Under ZeRO the trees are the rank's shards (``runtime/zero/
partition.py``): ``init`` makes each slot, ``master`` included, at its
leaf's shard shape, and ``apply`` updates each shard in place; a shard is
a contiguous tensor of its own, and a strided one raises in the kernel's
wrapper on either device. Update math is f32 whatever the parameter dtype; with
``master_weights`` each low-precision leaf keeps an f32 master in its slot
dict, updated there and cast back into the leaf.

On CUDA every leaf's update is one launch of the fused Adam kernel K10
(``ops/fused_adam.py``) over its contiguous f32 param/m/v. That kernel
computes AdamW with bias correction: ``amsgrad``, ``bias_correction=False``
and L2 weight decay (``adam_w_mode=False`` with a non-zero decay) raise
``NotImplementedError`` on CUDA and run the plain PyTorch update on the
CPU. ``DeepSpeedCPUAdam`` (``cpuadam``, the name the engine gives Adam
under optimizer offload) is Adam's math: the engine places its state
(``runtime/zero/offload_host.py``). LAMB, Lion, Adagrad, SGD, the CPU
Adagrad and Lion and the 1-bit optimizers of the JAX registry are not
ported yet (ROADMAP.md section A, item 16).
"""

from typing import Any, Dict, Optional

import torch

from ..utils.tree import tree_leaves, tree_map
from .fused_adam import fused_adam_flat

NOT_PORTED = "is not ported yet (ROADMAP.md section A, item 16)"


class Optimizer:
    """Base: subclasses define ``_init_slot(p)`` and
    ``_update_one(g, p, slots, ctx)``, which updates ``p`` and ``slots`` in
    place. ``master_weights`` is set by the engine for bf16/fp16 training."""

    name = "base"
    defaults: Dict[str, Any] = {}
    master_weights = False

    def __init__(self, **hyper):
        unknown = set(hyper) - set(self.defaults)
        if unknown:
            raise TypeError(f"{type(self).__name__} got unknown hyperparameters {sorted(unknown)}")
        self.hyper = {**self.defaults, **hyper}

    def _needs_master(self, p):
        return self.master_weights and p.dtype != torch.float32

    def init(self, params):
        """``{"step": 0, "slots": tree}``; a ``None`` leaf (one another
        optimizer updates: Twin-Flow's host half) gets a ``None`` slot."""
        def slot(p):
            if p is None:
                return None
            s = self._init_slot(p)
            if self._needs_master(p):
                s["master"] = p.detach().float().clone()
            return s
        return {"step": 0, "slots": tree_map(slot, params)}

    @torch.no_grad()
    def apply(self, grads, state, params, lr: Optional[float] = None):
        state["step"] += 1
        ctx = dict(self.hyper)
        if lr is not None:
            ctx["lr"] = lr
        ctx["step"] = float(state["step"])
        for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["slots"], is_leaf=is_slot)):
            if p is None:
                continue
            p_eff = s["master"] if "master" in s else p
            self._update_one(g.float(), p_eff, s, ctx)
            if "master" in s:
                p.copy_(p_eff)
        return params, state

    def _init_slot(self, p):
        raise NotImplementedError

    def _update_one(self, g, p, slots, ctx):
        raise NotImplementedError


def is_slot(node):
    """A slot dict (stops ``tree_leaves`` at the per-leaf slots)."""
    return isinstance(node, dict) and "m" in node


class FusedAdam(Optimizer):
    """Adam/AdamW (the JAX ``FusedAdam``)."""

    name = "adam"
    defaults = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                    adam_w_mode=True, bias_correction=True, amsgrad=False)

    def _init_slot(self, p):
        self._refuse_off_cpu(p.device)
        slot = {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        if self.hyper["amsgrad"]:
            slot["vmax"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return slot

    def kernel_computes(self, ctx=None):
        """True when the fused kernel computes this configuration's update:
        bias-corrected Adam with decoupled (or no) weight decay."""
        ctx = self.hyper if ctx is None else ctx
        return (not ctx["amsgrad"] and ctx["bias_correction"]
                and (ctx["adam_w_mode"] or ctx["weight_decay"] == 0.0))

    def _refuse_off_cpu(self, device, ctx=None):
        """Raise when the update would leave the CPU and the kernel does not
        compute it (checked at ``init`` and again at each update)."""
        if device.type != "cpu" and not self.kernel_computes(ctx):
            raise NotImplementedError(
                "the fused Adam kernel computes bias-corrected Adam with decoupled "
                "weight decay; amsgrad, bias_correction=False and L2 weight decay "
                f"(adam_w_mode=False) on the card {NOT_PORTED}")

    def _update_one(self, g, p, slots, ctx):
        if self.kernel_computes(ctx):
            fused_adam_flat(p, g, slots["m"], slots["v"], step=ctx["step"], lr=ctx["lr"],
                            betas=ctx["betas"], eps=ctx["eps"],
                            weight_decay=ctx["weight_decay"] if ctx["adam_w_mode"] else 0.0)
            return
        self._refuse_off_cpu(p.device, ctx)
        self._update_plain(g, p, slots, ctx)

    def _update_plain(self, g, p, slots, ctx):
        """``FusedAdam._update_one`` of the JAX package, in place, for the
        configurations the kernel does not compute (CPU only)."""
        b1, b2 = ctx["betas"]
        if ctx["weight_decay"] != 0.0 and not ctx["adam_w_mode"]:
            g = g + ctx["weight_decay"] * p
        m = b1 * slots["m"] + (1 - b1) * g
        v = b2 * slots["v"] + (1 - b2) * torch.square(g)
        step = torch.tensor(ctx["step"], dtype=torch.float32)
        if ctx["bias_correction"]:
            mh = m / (1 - torch.pow(torch.tensor(b1, dtype=torch.float32), step))
            vh = v / (1 - torch.pow(torch.tensor(b2, dtype=torch.float32), step))
        else:
            mh, vh = m, v
        if self.hyper["amsgrad"]:
            slots["vmax"].copy_(torch.maximum(slots["vmax"], vh))
            vh = slots["vmax"]
        update = mh / (torch.sqrt(vh) + ctx["eps"])
        if ctx["weight_decay"] != 0.0 and ctx["adam_w_mode"]:
            update = update + ctx["weight_decay"] * p
        p.copy_(p - ctx["lr"] * update)
        slots["m"].copy_(m)
        slots["v"].copy_(v)


class FusedAdamW(FusedAdam):
    name = "adamw"
    defaults = {**FusedAdam.defaults, "adam_w_mode": True}


class DeepSpeedCPUAdam(FusedAdam):
    """Adam under optimizer offload (the JAX ``DeepSpeedCPUAdam``): the same
    math; with ``offload_optimizer.native`` the host Adam of
    ``runtime/zero/offload_host.py`` runs it, otherwise this update over
    state the engine keeps in host memory or on NVMe."""

    name = "cpu_adam"


OPTIMIZER_REGISTRY = {
    "adam": FusedAdam,
    "adamw": FusedAdamW,
    "fusedadam": FusedAdam,
    "fusedadamw": FusedAdamW,
    "deepspeedcpuadam": DeepSpeedCPUAdam,
    "cpuadam": DeepSpeedCPUAdam,
}

# the rest of the JAX registry, by config name
NOT_PORTED_OPTIMIZERS = (
    "lamb", "fusedlamb", "lion", "fusedlion",
    "deepspeedcpulion", "cpulion", "adagrad", "deepspeedcpuadagrad", "cpuadagrad",
    "sgd", "onebitadam", "onebitlamb", "zerooneadam")


def build_optimizer(name: str, params_dict: Optional[dict] = None) -> Optimizer:
    """Instantiate by DeepSpeed config name (the JAX ``build_optimizer``)."""
    key = name.lower().replace("_", "").replace("-", "")
    if key in NOT_PORTED_OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} {NOT_PORTED}")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer {name!r}; known: {sorted(OPTIMIZER_REGISTRY)}")
    hyper = dict(params_dict or {})
    if "betas" in hyper:
        hyper["betas"] = tuple(hyper["betas"])
    hyper.pop("torch_adam", None)
    hyper.pop("fused", None)
    return OPTIMIZER_REGISTRY[key](**hyper)
