"""The training slice of the PyTorch port against the JAX package.

- ``CausalLM.loss`` and its gradients for ``tiny``, ``tiny-gpt2`` and a
  ``tiny`` that takes the other attention branches (ALiBi, a sliding
  window, parallel block, q/k norm, sandwich norms, softcap) on the same
  weights and batch (f32; loss rtol 1e-5, gradients rtol 1e-4 and atol
  1e-5: one f32 summation order against another through two layers).
- A JAX engine (one-device mesh) and a port engine (``device="cpu"``)
  started from the same weights, fp32, ``train_batch_size`` 16 with
  gradient accumulation 2, AdamW + WarmupLR + clipping: three
  ``train_batch`` steps give the same losses (rtol 1e-5) and parameters
  (atol 2e-6: three Adam steps of at most lr each, computed in f32 in two
  orders).
- ``forward``/``backward``/``step`` equal ``train_batch`` exactly; a bf16
  run's loss falls; fp16 overflow skips the update; ZeRO stages 0-2 agree;
  what the port does not run raises; and the config, the lr schedules and
  the loss scaler match the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.runtime import lr_schedules as port_sched
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as port_scaler
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, bs=16, seq=32, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, (bs, seq)).astype(np.int32)
    return {"input_ids": ids, "labels": np.roll(ids, -1, axis=1)}


def _config(**over):
    cfg = {
        "train_batch_size": 16,
        "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                     "warmup_type": "linear"}},
        "gradient_clipping": 1.0,
        "steps_per_print": 10 ** 9,
        "seed": 7,
    }
    cfg.update(over)
    return cfg


def _port_engine(preset="tiny-gpt2", **over):
    engine, _, _, _ = tds.initialize(model=build_model(preset), config=_config(**over),
                                     device="cpu")
    return engine


MODEL_VARIANTS = {
    "tiny": ("tiny", {}),
    "tiny-gpt2": ("tiny-gpt2", {}),
    "tiny_branches": ("tiny", {"position": "alibi", "sliding_window": 10,
                               "parallel_block": True, "qk_norm": "head_dim",
                               "sandwich_norm": True, "attn_softcap": 20.0}),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_model_loss_and_grads_match_jax(variant):
    preset, over = MODEL_VARIANTS[variant]
    jmodel, model = jax_build_model(preset, **over), build_model(preset, **over)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    params = params_from_numpy(model.cfg, jparams, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _batch(2, bs=2, seq=24)
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = model.loss(params, tbatch)
    tg = torch.autograd.grad(tl, tree_leaves(params))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for (path, _), a, b in zip(tree_paths(params), tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    # full recompute (torch.utils.checkpoint per layer) gives the same gradients
    model.cfg = model.cfg.replace(remat="full")
    tr = torch.autograd.grad(model.loss(params, tbatch), tree_leaves(params))
    for a, b in zip(tr, tg):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_engine_matches_jax_engine():
    groups.set_mesh(groups.build_mesh(devices=jax.devices()[:1], data=1))
    jengine, _, _, _ = jds.initialize(model=jax_build_model("tiny-gpt2"), config=_config())
    engine = _port_engine()
    engine.load_module_state_dict(jax.tree.map(np.asarray, jengine.module_params))
    for step in range(3):
        batch = _batch(10 + step)
        jl = float(jengine.train_batch(batch))
        tl = engine.train_batch(batch).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {step}")
    assert engine.global_steps == 3 and engine.micro_steps == 6
    assert engine.get_lr() == jengine.get_lr()
    for (path, t), j in zip(tree_paths(engine.module_params),
                            jax.tree.leaves(jengine.module_params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=2e-6,
                                   err_msg=path)


def test_forward_backward_step_equals_train_batch():
    ref, engine = _port_engine(), _port_engine()
    for i in range(2):
        batch = _batch(20 + i)
        ref.train_batch(batch)
        for g in range(2):
            loss = engine.forward({k: v[g * 8:(g + 1) * 8] for k, v in batch.items()})
            engine.backward(loss)
            engine.step()
    assert engine.global_steps == ref.global_steps == 2
    for a, b in zip(tree_leaves(engine.module_params), tree_leaves(ref.module_params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_loss_falls():
    engine = _port_engine(bf16={"enabled": True})
    assert engine.model.cfg.act_dtype == torch.bfloat16
    batch = _batch(30)
    losses = [engine.train_batch(batch).item() for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05, losses


def test_fp16_overflow_skips_step():
    engine = _port_engine(preset="tiny",
                          fp16={"enabled": True, "initial_scale_power": 4, "hysteresis": 1})
    before = [p.detach().clone() for p in tree_leaves(engine.module_params)]
    for p in tree_leaves(engine.module_params):
        p.grad = torch.full_like(p, float("inf"))
    engine._acc_count = 1
    engine.micro_steps = engine.gradient_accumulation_steps()
    engine.step()
    for a, b in zip(tree_leaves(engine.module_params), before):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    assert engine.scaler_state.scale < 2 ** 4 and engine.opt_state["step"] == 0


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_stages_hold_the_full_state_on_one_card(stage):
    batch = _batch(40)
    ref = _port_engine().train_batch(batch).item()
    engine = _port_engine(zero_optimization={"stage": stage})
    assert engine.zero_optimization_stage() == stage
    assert engine.train_batch(batch).item() == ref


NOT_PORTED = {
    "zero3_offload_param": {"zero_optimization": {"stage": 3,
                                                  "offload_param": {"device": "cpu"}}},
    "offload_optimizer": {"zero_optimization": {"stage": 2,
                                                "offload_optimizer": {"device": "cpu"}}},
    "nvme_params": {"zero_optimization": {"stage": 2, "offload_param": {"device": "nvme"}}},
    "zeropp": {"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
    "onebit": {"optimizer": {"type": "OneBitAdam", "params": {}}},
    "sparse_gradients": {"sparse_gradients": True},
    "pipeline": {"mesh": {"pipe": 2}},
    "tensor_parallel": {"mesh": {"tensor": 2}},
    "remat_dots": {"activation_checkpointing": {"policy": "dots"}},
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_configurations_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(**NOT_PORTED[name])


def test_data_mesh_must_match_the_world():
    """A ``mesh.data`` other than the world's process count is a config
    error (JAX ``build_mesh``'s MeshBuildError), not a refusal."""
    with pytest.raises(ValueError, match="world of 1"):
        _port_engine(mesh={"data": 4})


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: initialize() runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.initialize(model=build_model("tiny"), config=_config())
    with pytest.raises(NotImplementedError):
        tds.initialize(model=build_model("tiny"), config=_config(), training_data=[1],
                       device="cpu")


BATCH_CONFIGS = {
    "all_three": {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
                  "gradient_accumulation_steps": 2},
    "batch_and_micro": {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    "batch_and_gas": {"train_batch_size": 24, "gradient_accumulation_steps": 3},
    "micro_and_gas": {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 5},
    "batch_only": {"train_batch_size": 6},
    "micro_only": {"train_micro_batch_size_per_gpu": 3},
    "mismatch": {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 3,
                 "gradient_accumulation_steps": 2},
    "none": {},
    "fp16_and_bf16": {"train_batch_size": 4, "fp16": {"enabled": True},
                      "bf16": {"enabled": True}},
}


@pytest.mark.parametrize("name", sorted(BATCH_CONFIGS))
def test_config_matches_jax(name):
    d = BATCH_CONFIGS[name]

    def parse(cls):
        try:
            c = cls(dict(d), world_size=1)
        except (AssertionError, ValueError) as e:
            return type(e)
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps, c.fp16.enabled, c.bf16.enabled,
                c.zero_optimization_stage)
    assert parse(PortConfig) == parse(JaxConfig)


def test_config_blocks_match_jax():
    d = {"train_batch_size": 8,
         "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 12,
                  "hysteresis": "auto"},
         "zero_optimization": {"stage": 2, "stage3_max_live_parameters": 5,
                               "offload_optimizer": {"device": "cpu", "ratio": 0.5},
                               "unknown_key": 1},
         "activation_checkpointing": {"policy": "full"}}
    j, t = JaxConfig(d, world_size=1), PortConfig(d, world_size=1)
    for block in ("fp16", "bf16", "zero_config", "activation_checkpointing"):
        jb, tb = getattr(j, block), getattr(t, block)
        for name in ("enabled", "initial_scale_power", "hysteresis", "dynamic_loss_scale",
                     "stage", "max_live_parameters", "overlap_comm", "policy",
                     "master_weights"):
            if hasattr(jb, name):
                assert getattr(tb, name) == getattr(jb, name), (block, name)
    assert t.zero_config.offload_optimizer.ratio == 0.5
    assert t.precision_dtype == torch.float16
    with pytest.raises(ValueError):
        PortConfig({"train_batch_size": 8, "zero_optimization": {"stage": 4}})


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_num_steps": 7}),
    ("WarmupLR", {"warmup_num_steps": 7, "warmup_type": "linear", "warmup_min_lr": 1e-5}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 4}),
    ("LRRangeTest", {"lr_range_test_step_size": 3, "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_first_step_size": 4, "decay_lr_rate": 0.1, "decay_step_size": 2}),
])
def test_lr_schedules_match_jax(name, params):
    j = jax_sched.build_lr_schedule(name, params, default_lr=2e-3)
    t = port_sched.build_lr_schedule(name, params, default_lr=2e-3)
    assert [t.step() for _ in range(25)] == [j.step() for _ in range(25)]
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("consecutive", [False, True])
def test_dynamic_loss_scaler_matches_jax(consecutive):
    kw = dict(init_scale=2 ** 8, scale_window=3, min_scale=2.0, delayed_shift=2,
              consecutive_hysteresis=consecutive)
    j, t = jax_scaler.DynamicLossScaler(**kw), port_scaler.DynamicLossScaler(**kw)
    js, ts = j.init_state(), t.init_state()
    for overflow in [False, True, False, True, True, False, False, False, True, True,
                     True, True, True, True, True, True, False]:
        js = j.update(js, jnp.asarray(overflow))
        ts = t.update(ts, overflow)
        assert (ts.scale, ts.good_steps, ts.hysteresis, ts.overflows) == \
            (float(js.scale), int(js.good_steps), int(js.hysteresis), int(js.overflows))
    assert port_scaler.StaticLossScaler(4.0).update(
        port_scaler.StaticLossScaler(4.0).init_state(), True).overflows == 1
