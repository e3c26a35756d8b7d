"""DeepSpeedEngine: the training runtime of the port, one process a card.

Mirrors ``deepspeed_tpu/runtime/engine.py``: ``__init__`` (parameters from
a ``torch.Generator`` seeded with the config's ``seed``, optimizer, loss
scaler, lr schedule), ``_maybe_override_model_dtype``,
``_configure_optimizer``, ``_apply_update`` (unscale, global-norm clipping
with ``min(1, clip / (norm + 1e-6))``, the fp16 overflow skip),
``train_batch`` (gradient accumulation over ``gas`` micro-batches and the
``/gas`` divisor), ``forward``/``backward``/``step``, ``eval_batch``,
``load_module_state_dict``, ``_next_lr`` and ``_post_step``.

Where the JAX engine compiles one step function, the port runs eagerly:
each micro-batch's ``model.loss`` is differentiated by autograd and the
gradients accumulate in each leaf's ``.grad`` (in the leaf's dtype: f32 for
every preset's ``param_dtype``); the update then runs in place, one fused
Adam kernel launch per parameter leaf on the card (``ops/optimizers.py``).
Nothing in a step reads a device value back to the host, except the
overflow flag when the overflow check is on (fp16, or
``bf16.check_grad_overflow``): the eager update must know whether to run.
``_post_step`` fetches the loss and the gradient norm once per
``steps_per_print`` steps.

Data parallelism: in a process group of N ranks (one a card, joined by
``initialize``) the ``data`` axis spans the world, ``train_batch_size =
micro * gas * N``, and every rank gets the same global batch and trains on
its own rows of each micro-batch (JAX's contiguous batch sharding). Each
rank's loss is weighted by its share of the micro-batch's valid labels, so
the gradients summed over the group and the loss every rank reports are
JAX's global masked mean. ZeRO stages 1-3 split the optimizer state, the
gradients and (stage 3) the parameters over the ranks as the JAX engine's
shardings do (``runtime/zero/partition.py``); every rank takes the same
overflow decision and the same global gradient norm. A world of one runs
no collective: stages 0-3 then hold the same full state.

ZeRO-Offload of the optimizer (``zero_optimization.offload_optimizer``;
JAX ``engine.py:195-257``, ``:962-1068``): with ``device: cpu`` and
``native`` (the default) the f32 masters and moments of this rank's
optimizer-layout shards live on the host and the host Adam updates them
(``zero/offload_host.py``): the step accumulates the gradients on the card,
cuts them to the optimizer layout, takes one f32 norm squared over the
group for the overflow check and the clipping, streams the host-bound
gradients to the host and the updated masters back, and refreshes the
parameters (``ZeroPartition.refresh``). An overflow skips the update, the
lr schedule's step with it, as JAX's host path does. Twin-Flow
(``ratio`` < 1) hosts the largest whole leaves up to ``ratio`` of the
elements and updates the rest on the card with K10. ``native: false``
keeps the optimizer state in host memory and stages it through the card
around K10's update; ``device: nvme`` parks it in files between steps
(``swap_tensor.OptimizerSwapper``).

Checkpoints (JAX ``engine.py:1578-1692``): ``save_checkpoint`` writes
``<dir>/<tag>/`` through ``checkpoint_engine.TorchCheckpointEngine`` (each
rank its own shards, rank 0 ``ds_meta.json`` and ``latest``) and
``load_checkpoint`` restores a step exactly at the same layout;
``checkpoint/universal.py`` moves state across degrees, stages and the two
packages, and ``utils/zero_to_fp32.py`` consolidates a checkpoint.

A ``mesh.seq`` above 1 in a world of one is sequence parallelism within
this one process: the ``seq`` shards of ``utils.groups``, which
``attn_impl="ring"`` models run ring attention over. Parameter offload and
ZeRO-Infinity's streaming, ZeRO++ and MiCS, the 1-bit optimizers, Adagrad
and Lion under offload, async checkpoint saves, sparse gradients,
pipeline, tensor and expert parallelism, and sequence parallelism across
processes raise ``NotImplementedError`` (ROADMAP.md section A, item 16).
"""

import logging
import math
import os
import tempfile

import numpy as np
import torch

from ..accelerator import get_device
from ..comm import comm
from ..models.transformer import CausalLM
from ..ops.optimizers import Optimizer, build_optimizer, is_slot
from ..utils import groups
from ..utils.timer import NoopTimer, ThroughputTimer
from ..utils.tree import tree_from_paths, tree_leaves, tree_map, tree_paths
from .checkpoint_engine import TorchCheckpointEngine
from .config import DeepSpeedConfig
from .fp16.loss_scaler import (LossScaleState, StaticLossScaler, create_loss_scaler,
                               has_overflow)
from .lr_schedules import build_lr_schedule
from .swap_tensor.swapper import OptimizerSwapper
from .zero.offload_host import HostOffloadOptimizer
from .zero.partition import GlobalSum, LayerGather, ZeroPartition

logger = logging.getLogger(__name__)

NOT_PORTED = "is not ported yet (ROADMAP.md section A, item 16)"
MESH_AXES = ("data", "tensor", "pipe", "seq", "expert", "zrep")
# optimizer names under offload: the same math, the engine places the state
OFFLOAD_NAMES = {"adam": "cpuadam", "adamw": "cpuadam", "fusedadam": "cpuadam",
                 "adagrad": "cpuadagrad", "lion": "cpulion"}


def _twinflow_host_mask(sizes, ratio):
    """Which leaves (by whole-leaf element counts, in tree order) carry host
    optimizer state under Twin-Flow: largest first until ``ratio`` of all
    elements (JAX ``_twinflow_host_mask``; whole sizes, so every rank and
    JAX pick the same leaves)."""
    target = ratio * sum(sizes)
    mask = [False] * len(sizes)
    acc = 0
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        if acc >= target:
            break
        mask[i] = True
        acc += sizes[i]
    return mask


class DeepSpeedEngine:
    """Eager training engine: one process, one device, a rank of the
    data-parallel group."""

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None, collate_fn=None,
                 config=None, dont_change_device=False, device=None):
        """``device``: the current CUDA device by default, which raises
        without a GPU (pass ``device="cpu"`` for the CPU)."""
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._acc_count = 0
        self._pending_overflow = []
        self._last_grad_norm = None
        self._checkpoint_engine = None

        self.device = get_device(device)
        self._config = config if isinstance(config, DeepSpeedConfig) else \
            DeepSpeedConfig(config)
        self._refuse_unported(training_data)
        self.dp_world_size = groups.get_data_parallel_world_size()
        self.dp_rank = groups.get_data_parallel_rank()
        if self._config.world_size is None:
            self._config._configure_train_batch_size(self.dp_world_size)
            self._config.world_size = self.dp_world_size
        elif self._config.world_size != self.dp_world_size:
            raise ValueError(f"the config's world size {self._config.world_size} is not the "
                             f"data-parallel world of {self.dp_world_size}")

        if not isinstance(model, CausalLM):
            raise TypeError("the port's engine trains a deepspeed_tpu_torch CausalLM "
                            f"(models.build_model), got {type(model).__name__}")
        self.model = model
        self._maybe_override_model_dtype()
        self.zero_stage = self._config.zero_optimization_stage
        self.partition = None
        if self.dp_world_size > 1:
            self.partition = ZeroPartition(self.model, self.zero_stage, self.dp_world_size,
                                           self.dp_rank, self._persistence_threshold())
            self._split_params = any(d is not None for _, d, _, _ in self.partition.dims())
            # the scalar whose gradient makes autograd run stage 3's gathers'
            # backward (partition.LayerGather)
            self._anchor = torch.zeros((), device=self.device, requires_grad=True)

        # ---- parameters ----
        gen = torch.Generator(device=self.device).manual_seed(self._config.seed)
        self.module_params = self.model.init(
            gen, device=self.device,
            cut=self.partition.cut_init if self.partition is not None else None)
        for p in tree_leaves(self.module_params):
            p.requires_grad_(True)
        if self.partition is not None:
            self.partition.tag(self.module_params)
            # one collective on every rank before the first step (NCCL makes
            # its communicators at the first)
            self.partition.all_reduce(torch.zeros(1, device=self.device))

        # ---- optimizer (on the card, or offloaded), precision, lr schedule ----
        off = self._config.zero_config.offload_optimizer
        self.offload_optimizer = off is not None and off.device != "none"
        self.optimizer = self._configure_optimizer(optimizer)
        self._host_optimizer = self._twinflow = self._opt_swapper = None
        self._opt_on_host = False
        if self.offload_optimizer and off.device == "cpu" and off.native:
            self._init_host_offload(off)
            self.opt_state = None
        else:
            self.opt_state = self.optimizer.init(self._opt_params())
            if self.offload_optimizer:
                self._park_opt_state_init(off)
        self.loss_scaler = create_loss_scaler(self._config.fp16, self._config.precision_dtype)
        self.scaler_state = self.loss_scaler.init_state()
        self.gradient_clipping = float(self._config.gradient_clipping or 0.0)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.client_lr_scheduler = lr_scheduler
        self.training_dataloader = None

        self.timers = NoopTimer()     # wall_clock_breakdown timers are not ported
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size(),
                                          steps_per_output=self._config.steps_per_print)
        logger.info(f"DeepSpeedEngine ready: device={self.device} zero_stage={self.zero_stage} "
                    f"micro_bs={self.train_micro_batch_size_per_gpu()} "
                    f"gas={self.gradient_accumulation_steps()} "
                    f"dtype={self._config.precision_dtype}")

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def _refuse_unported(self, training_data):
        """Raise for what the port does not run, then set the parallel state
        of ``utils.groups`` from the config's ``mesh`` block and the world."""
        cfg = self._config
        zc = cfg.zero_config
        if training_data is not None:
            raise NotImplementedError(f"training_data (the engine's dataloader) {NOT_PORTED}")
        if zc.offload_param is not None and zc.offload_param.device != "none":
            raise NotImplementedError(
                f"zero_optimization.offload_param to {zc.offload_param.device} (ZeRO-Infinity's "
                f"layer streaming) {NOT_PORTED}")
        if (zc.zero_quantized_weights or zc.zero_quantized_gradients
                or zc.zero_hpz_partition_size > 1 or zc.mics_shard_size > 0):
            raise NotImplementedError(f"ZeRO++ and MiCS {NOT_PORTED}")
        if cfg.sparse_gradients_enabled:
            raise NotImplementedError(f"sparse_gradients {NOT_PORTED}")
        if cfg.wall_clock_breakdown:
            raise NotImplementedError(f"wall_clock_breakdown timers {NOT_PORTED}")
        wide = {a: cfg.mesh[a] for a in MESH_AXES
                if isinstance(cfg.mesh.get(a), int) and cfg.mesh[a] > 1}
        data = wide.pop("data", 1)
        seq = wide.pop("seq", 1)
        world = comm.get_world_size()
        if wide or (seq > 1 and max(world, data) > 1):
            raise NotImplementedError(
                f"training over mesh {cfg.mesh} in a world of {world}: tensor, pipeline and "
                f"expert parallelism, ZeRO replication groups, and sequence parallelism "
                f"beside data parallelism or across processes, {NOT_PORTED}")
        dp = groups.resolve_data_degree(cfg.mesh, world)
        # sequence shards held by this one process (utils/groups.py)
        groups.set_sequence_parallel(seq)
        groups.set_data_parallel(dp)

    def _persistence_threshold(self) -> int:
        """``param_persistence_threshold`` where the config sets it (the JAX
        engine reads it only then), else 0."""
        zo = self._config._param_dict.get("zero_optimization", {})
        explicit = ("stage3_param_persistence_threshold" in zo
                    or "param_persistence_threshold" in zo)
        return int(self._config.zero_config.param_persistence_threshold or 0) if explicit else 0

    def _maybe_override_model_dtype(self):
        target = self.model
        name = {torch.float16: "float16",
                torch.bfloat16: "bfloat16"}.get(self._config.precision_dtype)
        if name and target.cfg.dtype != name:
            target.cfg = target.cfg.replace(dtype=name)
        ac = self._config.activation_checkpointing
        if ac.policy != "none" and target.cfg.remat == "none":
            target.cfg = target.cfg.replace(remat=ac.policy)
        if ac.cpu_checkpointing and target.cfg.remat in ("none", "dots", "dots_no_batch"):
            target.cfg = target.cfg.replace(remat="dots_offload")
        if ac.partition_activations and not target.cfg.partition_activations:
            target.cfg = target.cfg.replace(partition_activations=True)
        if target.cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"activation checkpointing policy {target.cfg.remat!r} "
                                      f"(the port has 'none' and 'full') {NOT_PORTED}")

    def _configure_optimizer(self, client_optimizer) -> Optimizer:
        opt = self._build_base_optimizer(client_optimizer)
        dt = self._config.precision_dtype
        if dt == torch.bfloat16:
            opt.master_weights = self._config.bf16.master_weights
        elif dt == torch.float16:
            opt.master_weights = not self._config.fp16.fp16_master_weights_and_grads
        return opt

    def _build_base_optimizer(self, client_optimizer) -> Optimizer:
        if isinstance(client_optimizer, Optimizer):
            return client_optimizer
        if isinstance(client_optimizer, str):
            return build_optimizer(client_optimizer, {})
        opt_cfg = self._config.optimizer
        if opt_cfg.type is None:
            return build_optimizer("adamw", {"lr": 1e-3})
        name = opt_cfg.type
        if self.offload_optimizer:
            key = name.lower().replace("_", "").replace("-", "")
            name = OFFLOAD_NAMES.get(key, name)
        return build_optimizer(name, dict(opt_cfg.params))

    def _init_host_offload(self, off):
        """The host optimizer over this rank's optimizer layout (JAX
        ``engine.py:195-245``); under Twin-Flow the leaves it does not host
        get a device optimizer state (K10's update)."""
        opt_params = tree_paths(self._opt_params())
        mask = [True] * len(opt_params)
        if float(off.ratio) < 1.0:
            full = dict(tree_paths(self.partition.full_shapes if self.partition else
                                   tree_map(lambda p: tuple(p.shape), self.module_params)))
            mask = _twinflow_host_mask([math.prod(full[k]) for k, _ in opt_params],
                                       float(off.ratio))
        self._host_optimizer = HostOffloadOptimizer(
            self.optimizer.hyper,
            tree_from_paths((k, p if m else None) for (k, p), m in zip(opt_params, mask)),
            gradient_clipping=float(self._config.gradient_clipping or 0.0),
            optimizer_name=self.optimizer.name, pin_memory=off.pin_memory,
            world_size=self.dp_world_size)
        if not all(mask):
            dev = tree_from_paths((k, None if m else p) for (k, p), m in zip(opt_params, mask))
            self._twinflow = {"mask": mask, "dev_state": self.optimizer.init(dev)}
        logger.info(f"ZeRO-Offload: {self._host_optimizer.local_element_count():,} optimizer "
                    f"elements on this process's host (ratio {off.ratio})")

    def _park_opt_state_init(self, off):
        """Optimizer state outside the card (JAX ``engine.py:249-257`` and
        its host memory kind): ``nvme`` swaps it out to files until a step
        needs it; ``cpu`` with ``native: false`` keeps it in host memory
        (on the CPU it is there already)."""
        if off.device == "nvme":
            base = off.nvme_path or os.path.join(tempfile.gettempdir(), "ds_tpu_nvme")
            sub = ("optimizer" if self.dp_world_size == 1
                   else os.path.join("optimizer", f"rank{self.dp_rank}"))
            self._opt_swapper = OptimizerSwapper(os.path.join(base, sub))
            self._opt_on_host = True
            self._swap_out_opt_state()
        elif self.device.type != "cpu":
            pin = bool(off.pin_memory)
            self.opt_state = {"step": self.opt_state["step"], "slots": tree_map(
                lambda t: t.to("cpu").pin_memory() if pin else t.to("cpu"),
                self.opt_state["slots"])}
            self._opt_on_host = True

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler
        sched_cfg = self._config.scheduler
        if sched_cfg.type is None:
            return None
        return build_lr_schedule(sched_cfg.type, sched_cfg.params, self.optimizer.hyper.get("lr"))

    @property
    def _needs_overflow_check(self) -> bool:
        """fp16 skips the step on inf/nan gradients; for bf16/fp32 the check
        is off unless ``bf16.check_grad_overflow`` asks for it."""
        if self._config.precision_dtype == torch.float16:
            return True
        return bool(self._config.bf16.check_grad_overflow)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _scaled_backward(self, loss, retain_graph=False):
        scale = self.scaler_state.scale
        (loss if scale == 1.0 else loss * scale).backward(retain_graph=retain_graph)

    def _opt_params(self):
        """The parameter tree the optimizer updates: the module's, or under
        data parallelism each leaf in the optimizer's layout."""
        if self.partition is None:
            return self.module_params
        return self.partition.opt_params(self.module_params)

    def _update(self, grad_divisor):
        """The update at a boundary: the host optimizer's under native
        offload, else the device optimizer's (the lr schedule steps first)."""
        if self._host_optimizer is not None:
            return self._offload_update(grad_divisor)
        return self._apply_update(self._next_lr(), grad_divisor)

    def _reduced_grads(self):
        """Every leaf's accumulated gradient in the optimizer layout, f32,
        summed over the group."""
        if self.partition is None:
            return tree_map(lambda p: (p.grad if p.grad is not None
                                       else torch.zeros_like(p)).float(), self.module_params)
        return self.partition.reduce_grads(self.module_params)

    @torch.no_grad()
    def _apply_update(self, lr, grad_divisor):
        """Unscale, overflow-check, clip and apply the optimizer to the
        accumulated gradients of every leaf (or skip on overflow); clears the
        gradients. Under data parallelism the gradients are first summed over
        the group into the optimizer's layout, the overflow flag is the
        group's, and the norm sums the blocks' squares over the group and
        counts each whole leaf once. Returns (overflow, global grad norm as a
        device scalar or None without clipping)."""
        part = self.partition
        grad_tree = self._reduced_grads()
        grads = tree_leaves(grad_tree)
        static_one = (isinstance(self.loss_scaler, StaticLossScaler)
                      and self.loss_scaler.scale == 1.0 and grad_divisor == 1)
        if not static_one:
            torch._foreach_mul_(grads, 1.0 / (self.scaler_state.scale * grad_divisor))
        overflow = False
        if self._needs_overflow_check:
            flag = has_overflow(grads)
            if part is not None:
                flag = part.all_reduce(flag.float(), torch.distributed.ReduceOp.MAX)
            overflow = bool(flag)
        grad_norm = None
        if self.gradient_clipping > 0.0:
            if part is None:
                grad_norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            else:
                sq = torch.stack([torch.linalg.vector_norm(g) for g in grads]).square()
                split = torch.tensor(part.split, device=sq.device)
                blocks = part.all_reduce(torch.where(split, sq, 0.0).sum())
                grad_norm = torch.sqrt(blocks + torch.where(split, 0.0, sq).sum())
            coef = torch.clamp(self.gradient_clipping / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, coef)
        if not overflow:
            opt_params = self._opt_params()
            state = self._staged_opt_state()
            self.optimizer.apply(grad_tree, state, opt_params, lr=lr)
            self._park_opt_state(state)
            if part is not None:
                part.refresh(self.module_params, opt_params)
        self.scaler_state = self.loss_scaler.update(self.scaler_state, overflow)
        self.zero_grad()
        return overflow, grad_norm

    @torch.no_grad()
    def _offload_update(self, grad_divisor):
        """Native ZeRO-Offload's update (JAX ``_host_offload_train_batch``):
        one f32 norm squared of the loss-scaled gradients on the card (over
        the group, each whole leaf once) decides the overflow and the
        clipping; on overflow the step, the lr schedule's with it, is
        skipped and the loss scale shrinks; otherwise Twin-Flow's device
        half runs K10 first, then the host Adam updates its leaves and
        writes the masters back into the card's parameters. Returns
        (overflow, the unscaled global gradient norm: a float, nan on
        overflow)."""
        part = self.partition
        pairs = tree_paths(self._reduced_grads())
        grads = [g for _, g in pairs]
        sq = torch.stack([torch.dot(g.reshape(-1), g.reshape(-1)) for g in grads])
        if part is None:
            gsq = sq.sum()
        else:
            split = torch.tensor(part.split, device=sq.device)
            gsq = part.all_reduce(torch.where(split, sq, 0.0).sum()) + \
                torch.where(split, 0.0, sq).sum()
        gsq = float(gsq)
        divisor = self.scaler_state.scale * grad_divisor
        overflow = not math.isfinite(gsq)
        self.scaler_state = self.loss_scaler.update(self.scaler_state, overflow)
        grad_norm = float("nan")
        if not overflow:
            lr = self._next_lr()
            unscaled = gsq / (divisor * divisor)
            grad_norm = math.sqrt(unscaled)
            opt_params = tree_paths(self._opt_params())
            tf = self._twinflow
            mask = tf["mask"] if tf is not None else [True] * len(pairs)
            if tf is not None:
                scale_inv = 1.0 / divisor
                if self.gradient_clipping > 0.0:
                    scale_inv *= min(1.0, self.gradient_clipping / (grad_norm + 1e-6))
                torch._foreach_mul_([g for g, m in zip(grads, mask) if not m], scale_inv)
                self.optimizer.apply(
                    tree_from_paths((k, None if m else g) for (k, g), m in zip(pairs, mask)),
                    tf["dev_state"],
                    tree_from_paths((k, None if m else p) for (k, p), m in zip(opt_params, mask)),
                    lr=lr)
            self._host_optimizer.step(
                tree_from_paths((k, g if m else None) for (k, g), m in zip(pairs, mask)),
                grad_divisor=divisor, lr=lr, grad_norm_sq=unscaled,
                out=tree_from_paths((k, p if m else None) for (k, p), m in zip(opt_params, mask)))
            if part is not None:
                part.refresh(self.module_params, tree_from_paths(opt_params))
        self._last_grad_norm = grad_norm
        self.zero_grad()
        return overflow, grad_norm

    # -- optimizer state outside the card (native: false, nvme) --

    def _swap_in_opt_state(self):
        """NVMe: read the parked state back into host memory (a no-op while
        it is resident)."""
        if self._opt_swapper is not None and self.opt_state is None:
            self.opt_state = self._opt_swapper.swap_in_optimizer()

    def _swap_out_opt_state(self):
        if self._opt_swapper is not None and self.opt_state is not None:
            self._opt_swapper.swap_out_optimizer(self.opt_state)
            self.opt_state = None

    def _staged_opt_state(self):
        """The optimizer state on the update's device: as it is, or copied
        from host memory to the card."""
        self._swap_in_opt_state()
        st = self.opt_state
        if not self._opt_on_host or self.device.type == "cpu":
            return st
        return {"step": st["step"], "slots": tree_map(
            lambda t: t.to(self.device, non_blocking=True), st["slots"])}

    def _park_opt_state(self, state):
        """Write the updated state back where it lives (host memory; then
        the NVMe files)."""
        if state is not self.opt_state:
            for h, d in zip(tree_leaves(self.opt_state["slots"]), tree_leaves(state["slots"])):
                h.copy_(d, non_blocking=True)
            self.opt_state["step"] = state["step"]
            torch.cuda.synchronize(self.device)
        self._swap_out_opt_state()

    def _stage_leaf(self, x):
        """One batch leaf on the device as (gas, micro_bs * dp, ...): the
        global micro-batches."""
        gas = self.gradient_accumulation_steps()
        rows = self.train_micro_batch_size_per_gpu() * self.dp_world_size
        t = torch.as_tensor(x, device=self.device)
        if t.dim() >= 1 and t.shape[0] == gas * rows:
            return t.reshape((gas, rows) + tuple(t.shape[1:]))
        if t.dim() >= 2 and t.shape[0] == gas:
            return t
        want = "gas*micro_bs" if self.dp_world_size == 1 else "gas*micro_bs*dp"
        raise ValueError(f"train_batch leaf has leading dim {t.shape[0]}; expected "
                         f"{want}={gas * rows} or a (gas, ...) layout")

    def _put_batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _rows(self, t):
        """This rank's rows of a global micro-batch leaf: the r-th of dp
        contiguous blocks (JAX's batch sharding over ``data``)."""
        n = t.shape[0] // self.dp_world_size
        if n * self.dp_world_size != t.shape[0]:
            raise ValueError(f"a micro-batch of {t.shape[0]} rows does not split over "
                             f"{self.dp_world_size} data-parallel ranks")
        return t[self.dp_rank * n:(self.dp_rank + 1) * n]

    def _micro_loss(self, micro):
        """The loss of one global micro-batch for this rank's backward: the
        model's loss on one device; under data parallelism the loss of this
        rank's rows weighted by their share of the valid labels, so that the
        group's sum of the terms (and of their gradients) is the micro-batch's
        global masked mean (JAX ``masked_token_nll`` over the sharded
        batch)."""
        if self.partition is None:
            return self.model.loss(self.module_params, micro)
        local = {k: self._rows(v) for k, v in micro.items()}
        gather = None
        if self._split_params:
            gather = LayerGather(self.partition, self.module_params, self._anchor,
                                 self.model.cfg.act_dtype, self.model.cfg.num_layers)
        loss = self.model.loss(self.module_params, local, gather=gather)
        mask = micro.get("loss_mask")
        if mask is None:
            return loss / self.dp_world_size
        share = (local["loss_mask"].float().sum().clamp_min(1.0)
                 / mask.float().sum().clamp_min(1.0))
        return loss * share

    def train_batch(self, batch):
        """One optimizer step over a full batch: ``batch`` leaves are
        (gas * micro_bs * dp, ...) or (gas, micro_bs * dp, ...), the same
        global batch on every rank. Returns the mean micro-batch loss as a
        device scalar (the global one on every rank)."""
        if self._acc_count:
            raise RuntimeError("train_batch() while forward()/backward() gradients of "
                               f"{self._acc_count} micro-batch(es) await step()")
        gas = self.gradient_accumulation_steps()
        staged = {k: self._stage_leaf(v) for k, v in batch.items()}
        self.tput_timer.start()
        loss_sum = None
        for i in range(gas):
            loss = self._micro_loss({k: v[i] for k, v in staged.items()})
            self._scaled_backward(loss)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if self.partition is not None:
            loss_sum = self.partition.all_reduce(loss_sum)
        overflow, grad_norm = self._update(1 if gas == 1 else float(gas))
        self.micro_steps += gas
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        loss = loss_sum / gas
        self._post_step(overflow, grad_norm, loss)
        self.tput_timer.stop(global_step=True)
        return loss

    def forward(self, batch=None, **kwargs):
        """The micro-batch loss, differentiable for the paired ``backward``:
        under data parallelism ``batch`` is the global micro-batch and the
        loss its global value, whose backward gives this rank's rows'
        gradients."""
        if batch is None:
            batch = kwargs
        loss = self._micro_loss(self._put_batch(batch))
        if self.partition is None:
            return loss
        return GlobalSum.apply(loss)

    __call__ = forward

    def backward(self, loss, allreduce_gradients=True, retain_graph=False):
        """Accumulate the (loss-scaled) micro-batch gradients."""
        self._scaled_backward(loss, retain_graph)
        self._acc_count += 1
        self.micro_steps += 1
        return loss

    def step(self, lr_kwargs=None):
        """Apply the update at a gradient-accumulation boundary."""
        if self.micro_steps % self.gradient_accumulation_steps() != 0:
            return
        if not self._acc_count:
            raise RuntimeError("step() without accumulated gradients")
        overflow, grad_norm = self._update(float(self._acc_count))
        self._acc_count = 0
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._post_step(overflow, grad_norm)

    def eval_batch(self, batch):
        """The loss of a global batch, without gradients."""
        with torch.no_grad():
            loss = self._micro_loss(self._put_batch(batch))
            if self.partition is not None:
                loss = self.partition.all_reduce(loss)
            return loss

    def _next_lr(self):
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
            return self.lr_scheduler.get_lr()[0]
        return self.optimizer.hyper.get("lr", 1e-3)

    def _post_step(self, overflow, grad_norm, loss=None):
        """Bookkeeping at the update boundary. Device values are not read
        per step: once per ``steps_per_print`` window the loss and gradient
        norm are fetched and logged."""
        self._pending_overflow.append(overflow)
        spp = max(1, int(self._config.steps_per_print or 10 ** 9))
        if self.global_steps % spp != 0:
            return
        n_over = sum(self._pending_overflow)
        self._pending_overflow.clear()
        self.skipped_steps += n_over
        if n_over:
            logger.warning(f"step={self.global_steps} {n_over} OVERFLOW step(s) in window, "
                           f"scale -> {self.scaler_state.scale}")
        if grad_norm is not None:
            self._last_grad_norm = float(grad_norm)
        lval = float(loss) if loss is not None else None
        logger.info(f"step={self.global_steps} loss={lval} lr={self.get_lr()[0]} "
                    f"grad_norm={self._last_grad_norm} "
                    f"samples/s={self.tput_timer.avg_samples_per_sec():.4g}")

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def train_batch_size(self):
        return self._config.train_batch_size

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def get_lr(self):
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "get_lr"):
            return self.lr_scheduler.get_lr()
        return [self.optimizer.hyper.get("lr", 0.0)]

    def zero_grad(self):
        for p in tree_leaves(self.module_params):
            p.grad = None
        if self.partition is not None:
            self.partition.grad_shards.clear()

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def load_module_state_dict(self, state_dict, strict: bool = True):
        """Copy a params tree of whole tensors (tensors or numpy arrays, the
        JAX package's leaf names) into the engine's parameters, each rank
        keeping its shard of a split leaf, and re-seed every f32 master (the
        host optimizer's, Twin-Flow's device half, the device slots; sharded
        like the optimizer state), so the next update starts from the loaded
        weights. With ``strict`` the tree must match leaf for leaf, whole
        shapes included."""
        self._load_module(state_dict, strict)
        self._resync_masters_from_params()

    def _load_module(self, state_dict, strict):
        own = dict(tree_paths(self.module_params))
        got = dict(tree_paths(state_dict))
        dims = dict(tree_paths(self.partition.param_dims)) if self.partition else {}
        if strict:
            full = dict(tree_paths(self.partition.full_shapes)) if self.partition else None
            want = {k: tuple(full[k] if full else v.shape) for k, v in own.items()}
            have = {k: tuple(v.shape) for k, v in got.items()}
            if want != have:
                raise ValueError(f"state_dict tree mismatch: expected {want}, got {have}")
        with torch.no_grad():
            for path, src in got.items():
                if path in own:
                    t = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
                    if dims.get(path) is not None:
                        t = self.partition.cut(t, dims[path])
                    own[path].copy_(t)

    @torch.no_grad()
    def _resync_masters_from_params(self):
        """Every f32 master tracks the module's weights (JAX
        ``_resync_masters_from_params``): the host optimizer's masters, and
        the ``master`` slots of the device state (Twin-Flow's device half,
        or the whole state, swapped in first from NVMe)."""
        pairs = tree_paths(self._opt_params())
        if self._host_optimizer is not None:
            mask = self._twinflow["mask"] if self._twinflow else [True] * len(pairs)
            self._host_optimizer.reset_masters(
                tree_from_paths((k, p if m else None) for (k, p), m in zip(pairs, mask)))
            state = self._twinflow["dev_state"] if self._twinflow else None
        elif any(self.optimizer._needs_master(p) for _, p in pairs):
            self._swap_in_opt_state()
            state = self.opt_state
        else:
            return
        if state is None:
            return
        for (_, p), slot in zip(pairs, tree_leaves(state["slots"], is_leaf=is_slot)):
            if slot is not None and "master" in slot:
                slot["master"].copy_(p.float())

    # ------------------------------------------------------------------
    # checkpoints (JAX engine.py:1578-1692)
    # ------------------------------------------------------------------

    def _ckpt_engine(self):
        if self._checkpoint_engine is None:
            self._checkpoint_engine = TorchCheckpointEngine()
        return self._checkpoint_engine

    def _layout(self):
        """How this rank's tensors are cut: the degree, rank and stage, and
        each leaf's split dim of the parameters and of the optimizer state
        (None: whole)."""
        part = self.partition
        none = tree_map(lambda _: None, self.module_params)
        return {"world": self.dp_world_size, "rank": self.dp_rank, "stage": self.zero_stage,
                "param_dims": dict(tree_paths(part.param_dims if part else none)),
                "opt_dims": dict(tree_paths(part.opt_dims if part else none))}

    def _optimizer_state(self):
        """The optimizer's ``{"step", "slots"}`` of this rank (host offload:
        the host optimizer's, Twin-Flow's host half)."""
        if self._host_optimizer is not None:
            return self._host_optimizer.state_dict()
        self._swap_in_opt_state()
        return self.opt_state

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Write ``<save_dir>/<tag>/`` (default tag ``global_step<N>``): each
        rank its parameters, optimizer state (host-offloaded and NVMe-parked
        state included), Twin-Flow's device half and the loss scaler as
        ``checkpoint_engine.TorchCheckpointEngine`` lays them out; rank 0
        ``ds_meta.json`` (the step counters, the lr schedule, the stage,
        ``client_state``) and, with ``save_latest``, ``<save_dir>/latest``.
        Every rank of the group calls it."""
        if self._config.checkpoint_config.async_save:
            raise NotImplementedError(f"checkpoint.async_save {NOT_PORTED}")
        tag = tag or f"global_step{self.global_steps}"
        state = {
            "module": tree_map(lambda p: p.detach(), self.module_params),
            "optimizer": self._optimizer_state(),
            **({"twinflow_device": self._twinflow["dev_state"]} if self._twinflow else {}),
            "scaler": self.scaler_state._asdict(),
            "layout": self._layout(),
            "meta": {
                "global_steps": self.global_steps,
                "global_samples": self.global_samples,
                "micro_steps": self.micro_steps,
                "skipped_steps": self.skipped_steps,
                "lr_scheduler": (self.lr_scheduler.state_dict()
                                 if self.lr_scheduler is not None
                                 and hasattr(self.lr_scheduler, "state_dict") else None),
                "zero_stage": self.zero_stage,
                "client_state": client_state or {},
            },
        }
        self._ckpt_engine().save(state, os.path.join(save_dir, str(tag)))
        if save_latest and comm.get_rank() == 0:
            with open(os.path.join(save_dir, "latest"), "w") as f:
                f.write(str(tag))
        comm.barrier()
        return True

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore ``<load_dir>/<tag>/`` (default: the tag in ``latest``) saved
        at this engine's degree and stage; returns ``(path, client_state)``,
        or ``(None, {})`` without ``latest``. ``load_module_only`` takes the
        parameters and re-seeds the masters from them, as does
        ``load_optimizer_states=False`` (the JAX engine leaves the masters as
        they were there: the next update would undo the load)."""
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag))
        state = self._ckpt_engine().load(path, self._layout())
        saved = dict(tree_paths(state["module"]))
        for k, p in tree_paths(self.module_params):
            t = saved.get(k)
            if t is None or tuple(t.shape) != tuple(p.shape):
                if load_module_strict:
                    raise ValueError(f"{path}: parameter {k} saved as "
                                     f"{None if t is None else tuple(t.shape)}, this rank "
                                     f"holds {tuple(p.shape)}")
                continue
            p.copy_(t)
        meta = state["meta"]
        if load_module_only:
            self._resync_masters_from_params()
            return path, meta.get("client_state", {})
        if load_optimizer_states:
            if self._host_optimizer is not None:
                self._restore_host_optimizer_state(state["optimizer"],
                                                   state.get("twinflow_device"))
            else:
                self._load_opt_state(state["optimizer"])
        else:
            self._resync_masters_from_params()
        self.scaler_state = LossScaleState(**state["scaler"])
        self.global_steps = int(meta["global_steps"])
        self.global_samples = int(meta["global_samples"])
        self.micro_steps = int(meta["micro_steps"])
        self.skipped_steps = int(meta.get("skipped_steps", 0))
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler") is not None
                and hasattr(self.lr_scheduler, "load_state_dict")):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        return path, meta.get("client_state", {})

    def _load_opt_state(self, saved):
        """Copy a saved ``{"step", "slots"}`` of this rank's layout into the
        device optimizer's state (swapped in first, when parked)."""
        self._swap_in_opt_state()
        _copy_state(self.opt_state, saved, "optimizer")

    def _restore_host_optimizer_state(self, opt_tree, twinflow_dev=None):
        """Route a saved optimizer tree into the host optimizer (and
        Twin-Flow's device half), then write the restored masters into the
        host-owned parameters (JAX ``_restore_host_optimizer_state``): every
        later host update starts from the masters."""
        self._host_optimizer.load_state_dict(opt_tree)
        if self._twinflow is not None and twinflow_dev is not None:
            _copy_state(self._twinflow["dev_state"], twinflow_dev, "twinflow_device")
        pairs = tree_paths(self._opt_params())
        masters = dict(tree_paths(self._host_optimizer.params()))
        for k, p in pairs:
            if masters.get(k) is not None:
                p.copy_(masters[k])
        if self.partition is not None:
            self.partition.refresh(self.module_params, tree_from_paths(pairs))

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """The parameters gathered whole into one ``torch.save`` file of
        dotted names (JAX ``save_16bit_model``): f32 leaves cast to the
        training dtype when it is bf16 / fp16. Every rank calls it; rank 0
        writes. Returns the file's path."""
        dt = self.model.cfg.act_dtype
        flat = {}
        for k, t in tree_paths(self.module_state_dict()):
            t = t.detach().to("cpu")
            flat[k] = t.to(dt) if t.dtype == torch.float32 and dt != torch.float32 else t
        path = os.path.join(save_dir, save_filename)
        if comm.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            torch.save(flat, path)
        comm.barrier()
        return path

    def module_state_dict(self):
        """The parameters as whole tensors (split leaves gathered over the
        data-parallel group, which every rank must call together; whole
        leaves are the engine's own tensors, detached). The JAX engine's
        ``save_16bit_model`` walks the same tree."""
        if self.partition is None:
            return tree_map(lambda p: p.detach(), self.module_params)
        return tree_map(lambda p, d: self.partition.gather(p.detach(), d),
                        self.module_params, self.partition.param_dims)

    def get_global_grad_norm(self):
        return self._last_grad_norm

    def zero_optimization(self):
        return self.zero_stage > 0

    def zero_optimization_stage(self):
        return self.zero_stage

    @property
    def params(self):
        return self.module_params


def _copy_state(dst, src, what):
    """Copy a saved ``{"step", "slots"}`` into a live one of the same
    layout, leaf by leaf (a missing or misshapen leaf raises)."""
    dst["step"] = int(src["step"])
    want = tree_paths(dst["slots"])
    got = dict(tree_paths(src["slots"]))
    for path, t in want:
        if t is None:
            continue
        s = got.get(path)
        if s is None or tuple(s.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {path} saved as "
                             f"{None if s is None else tuple(s.shape)}, expected {tuple(t.shape)}")
        t.copy_(s)
