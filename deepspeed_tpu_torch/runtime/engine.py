"""DeepSpeedEngine: the training runtime of the port, one process on one card.

Mirrors ``deepspeed_tpu/runtime/engine.py`` for the single-device path:
``__init__`` (parameters from a ``torch.Generator`` seeded with the config's
``seed``, optimizer, loss scaler, lr schedule), ``_maybe_override_model_dtype``,
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

ZeRO stages 0, 1 and 2 are accepted: on one process they hold the same full
state as stage 0 (there is no data-parallel group to shard over). Stage 3,
parameter or optimizer offload (CPU or NVMe), ZeRO++ and MiCS, the 1-bit
optimizers, sparse gradients, pipeline and data parallelism over more than
one card raise ``NotImplementedError`` (ROADMAP.md section A, item 16).
"""

import logging

import numpy as np
import torch

from ..accelerator import get_device
from ..models.transformer import CausalLM
from ..ops.optimizers import Optimizer, build_optimizer, is_slot
from ..utils.timer import NoopTimer, ThroughputTimer
from ..utils.tree import tree_leaves, tree_map, tree_paths
from .config import DeepSpeedConfig
from .fp16.loss_scaler import StaticLossScaler, create_loss_scaler, has_overflow
from .lr_schedules import build_lr_schedule

logger = logging.getLogger(__name__)

NOT_PORTED = "is not ported yet (ROADMAP.md section A, item 16)"
MESH_AXES = ("data", "tensor", "pipe", "seq", "expert", "zrep")


class DeepSpeedEngine:
    """Eager training engine over one device."""

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

        self.device = get_device(device)
        self._config = config if isinstance(config, DeepSpeedConfig) else \
            DeepSpeedConfig(config, world_size=1)
        if self._config.world_size is None:
            self._config._configure_train_batch_size(1)
            self._config.world_size = 1
        self._refuse_unported(training_data)

        if not isinstance(model, CausalLM):
            raise TypeError("the port's engine trains a deepspeed_tpu_torch CausalLM "
                            f"(models.build_model), got {type(model).__name__}")
        self.model = model
        self._maybe_override_model_dtype()
        self.zero_stage = self._config.zero_optimization_stage

        # ---- parameters ----
        gen = torch.Generator(device=self.device).manual_seed(self._config.seed)
        self.module_params = self.model.init(gen, device=self.device)
        for p in tree_leaves(self.module_params):
            p.requires_grad_(True)

        # ---- optimizer, precision, lr schedule ----
        self.optimizer = self._configure_optimizer(optimizer)
        self.opt_state = self.optimizer.init(self.module_params)
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
        cfg = self._config
        zc = cfg.zero_config
        if training_data is not None:
            raise NotImplementedError(f"training_data (the engine's dataloader) {NOT_PORTED}")
        if zc.stage == 3:
            raise NotImplementedError(f"ZeRO stage 3 {NOT_PORTED}")
        for name in ("offload_param", "offload_optimizer"):
            off = getattr(zc, name)
            if off is not None and off.device != "none":
                raise NotImplementedError(
                    f"zero_optimization.{name} to {off.device} {NOT_PORTED}")
        if (zc.zero_quantized_weights or zc.zero_quantized_gradients
                or zc.zero_hpz_partition_size > 1 or zc.mics_shard_size > 0):
            raise NotImplementedError(f"ZeRO++ and MiCS {NOT_PORTED}")
        if cfg.sparse_gradients_enabled:
            raise NotImplementedError(f"sparse_gradients {NOT_PORTED}")
        if cfg.wall_clock_breakdown:
            raise NotImplementedError(f"wall_clock_breakdown timers {NOT_PORTED}")
        wide = {a: cfg.mesh[a] for a in MESH_AXES
                if isinstance(cfg.mesh.get(a), int) and cfg.mesh[a] > 1}
        dist = torch.distributed
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if wide or world > 1:
            raise NotImplementedError(
                f"training over more than one device (mesh {wide}, world size {world}): "
                f"data, tensor, pipeline and sequence parallelism {NOT_PORTED}")

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
        return build_optimizer(opt_cfg.type, dict(opt_cfg.params))

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

    @torch.no_grad()
    def _apply_update(self, lr, grad_divisor):
        """Unscale, overflow-check, clip and apply the optimizer to the
        accumulated ``.grad`` of every leaf (or skip on overflow); clears the
        gradients. Returns (overflow, global grad norm as a device scalar or
        None without clipping)."""
        grad_tree = tree_map(lambda p: (p.grad if p.grad is not None
                                        else torch.zeros_like(p)).float(),
                             self.module_params)
        grads = tree_leaves(grad_tree)
        static_one = (isinstance(self.loss_scaler, StaticLossScaler)
                      and self.loss_scaler.scale == 1.0 and grad_divisor == 1)
        if not static_one:
            torch._foreach_mul_(grads, 1.0 / (self.scaler_state.scale * grad_divisor))
        overflow = bool(has_overflow(grads)) if self._needs_overflow_check else False
        grad_norm = None
        if self.gradient_clipping > 0.0:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            coef = torch.clamp(self.gradient_clipping / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, coef)
        if not overflow:
            self.optimizer.apply(grad_tree, self.opt_state, self.module_params, lr=lr)
        self.scaler_state = self.loss_scaler.update(self.scaler_state, overflow)
        self.zero_grad()
        return overflow, grad_norm

    def _stage_leaf(self, x):
        """One batch leaf on the device as (gas, micro_bs, ...)."""
        gas = self.gradient_accumulation_steps()
        mb = self.train_micro_batch_size_per_gpu()
        t = torch.as_tensor(x, device=self.device)
        if t.dim() >= 1 and t.shape[0] == gas * mb:
            return t.reshape((gas, mb) + tuple(t.shape[1:]))
        if t.dim() >= 2 and t.shape[0] == gas:
            return t
        raise ValueError(f"train_batch leaf has leading dim {t.shape[0]}; expected "
                         f"gas*micro_bs={gas * mb} or a (gas, ...) layout")

    def _put_batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def train_batch(self, batch):
        """One optimizer step over a full batch: ``batch`` leaves are
        (gas * micro_bs, ...) or (gas, micro_bs, ...). Returns the mean
        micro-batch loss as a device scalar."""
        if self._acc_count:
            raise RuntimeError("train_batch() while forward()/backward() gradients of "
                               f"{self._acc_count} micro-batch(es) await step()")
        gas = self.gradient_accumulation_steps()
        staged = {k: self._stage_leaf(v) for k, v in batch.items()}
        self.tput_timer.start()
        lr = self._next_lr()
        loss_sum = None
        for i in range(gas):
            loss = self.model.loss(self.module_params, {k: v[i] for k, v in staged.items()})
            self._scaled_backward(loss)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        overflow, grad_norm = self._apply_update(lr, 1 if gas == 1 else float(gas))
        self.micro_steps += gas
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        loss = loss_sum / gas
        self._post_step(overflow, grad_norm, loss)
        self.tput_timer.stop(global_step=True)
        return loss

    def forward(self, batch=None, **kwargs):
        """The micro-batch loss, differentiable for the paired ``backward``."""
        if batch is None:
            batch = kwargs
        return self.model.loss(self.module_params, self._put_batch(batch))

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
        lr = self._next_lr()
        overflow, grad_norm = self._apply_update(lr, float(self._acc_count))
        self._acc_count = 0
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._post_step(overflow, grad_norm)

    def eval_batch(self, batch):
        with torch.no_grad():
            return self.model.loss(self.module_params, self._put_batch(batch))

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

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def load_module_state_dict(self, state_dict, strict: bool = True):
        """Copy a params tree (tensors or numpy arrays, the JAX package's
        leaf names) into the engine's parameters and re-seed any f32 master
        copies, so the next update starts from the loaded weights. With
        ``strict`` the tree must match leaf for leaf, shapes included."""
        own = dict(tree_paths(self.module_params))
        got = dict(tree_paths(state_dict))
        if strict:
            want = {k: tuple(v.shape) for k, v in own.items()}
            have = {k: tuple(v.shape) for k, v in got.items()}
            if want != have:
                raise ValueError(f"state_dict tree mismatch: expected {want}, got {have}")
        with torch.no_grad():
            for path, src in got.items():
                if path in own:
                    own[path].copy_(src if torch.is_tensor(src)
                                    else torch.from_numpy(np.array(src)))
            for p, slot in zip(tree_leaves(self.module_params),
                               tree_leaves(self.opt_state["slots"], is_leaf=is_slot)):
                if "master" in slot:
                    slot["master"].copy_(p.float())

    def get_global_grad_norm(self):
        return self._last_grad_norm

    def zero_optimization(self):
        return self.zero_stage > 0

    def zero_optimization_stage(self):
        return self.zero_stage

    @property
    def params(self):
        return self.module_params
