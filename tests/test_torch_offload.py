"""ZeRO-Offload of the port's optimizer against the JAX package.

The host kernels: the port's ``cpu_adam`` / ``cpu_adagrad`` / ``cpu_lion``
(its own copy of ``csrc/adam/cpu_adam.cpp``, built by ``g++`` with JAX's
flags) give JAX's ``ops/cpu_adam_native.py`` bits on seeded inputs, on one
thread and split over three; the port's host Adam sits within 1e-6 of K10's
plain version.

One process: a JAX engine and a port engine from the same weights (carried
by ``load_module_state_dict``) take the same three steps (gas 2, clipping
1.0, AdamW + WarmupLR) with ``offload_optimizer`` on the host (native),
Twin-Flow at ratio 0.5 (the same leaves hosted as JAX's), and ``native:
false``: the losses within rtol 1e-5, the parameters within atol 2e-6 (as
``tests/test_torch_zero.py``), and the host masters and moments against
JAX's. An fp16 step whose gradients are non-finite is skipped by both, the
lr schedule's step with it. NVMe parks the state between steps and trains
as the runs without offload do (JAX's own NVMe path is not run: its aio
engine can lose a wakeup, ROADMAP.md section C). The parts of item 16 that
are not ported raise. Every engine is f32 on ``tiny``, torch on one thread.
"""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu as jds
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.ops import cpu_adam_native as jax_host
from deepspeed_tpu.utils import groups as jax_groups
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import cpu_adam_native as host
from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat_plain
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths

STEPS = 3
OFFLOAD = {"host": {"device": "cpu"},
           "twinflow": {"device": "cpu", "ratio": 0.5},
           "native_false": {"device": "cpu", "native": False}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(offload=None, stage=0, **over):
    cfg = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9, "seed": 7,
           "zero_optimization": {"stage": stage}}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
    cfg.update(over)
    return cfg


def _batches():
    out = []
    for step in range(STEPS):
        ids = np.random.default_rng(10 + step).integers(0, 256, (16, 32)).astype(np.int32)
        out.append({"input_ids": ids, "labels": np.roll(ids, -1, axis=1)})
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_paths(tree)}


def _port(cfg, init=None):
    e, _, _, _ = tds.initialize(model=build_model("tiny"), config=cfg, device="cpu")
    if init is not None:
        e.load_module_state_dict(init)
    return e


def _jax(cfg, init=None):
    jax_groups.set_mesh(jax_groups.build_mesh(devices=jax.devices()[:1], data=1))
    e, _, _, _ = jds.initialize(model=jax_build_model("tiny"), config=cfg)
    if init is not None:
        e.load_module_state_dict(jax.tree.map(np.asarray, init))
    return e


@pytest.fixture(scope="module")
def jax_init():
    """JAX's initial weights of ``tiny`` (seed 7), as numpy."""
    return jax.tree.map(np.asarray, _jax(_config()).module_params)


# ---------------------------------------------------------------------------
# the host kernels
# ---------------------------------------------------------------------------

def _kernel_inputs(n=40_003, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return p, m, v, grads


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("kind", ["adam", "adamw_l2", "adagrad", "lion"])
def test_host_kernels_match_jax_bit_for_bit(kind, threads, monkeypatch):
    """Three steps of each host kernel on seeded inputs: the port's buffers
    equal JAX's bit for bit, whole or split over three threads (small runs
    so that a 40,003-element buffer splits)."""
    monkeypatch.setattr(host, "MIN_RUN", 4096)
    p, m, v, grads = _kernel_inputs()
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    jp, jm, jv = p.copy(), m.copy(), v.copy()
    for step, g in enumerate(grads, 1):
        tg = torch.from_numpy(g)
        if kind in ("adam", "adamw_l2"):
            kw = dict(weight_decay=0.1, adamw_mode=kind == "adam")
            host.cpu_adam_step(tp, tg, tm, tv, step, 1e-2, threads=threads, **kw)
            jax_host.cpu_adam_step(jp, g, jm, jv, step, 1e-2, **kw)
        elif kind == "adagrad":
            host.cpu_adagrad_step(tp, tg, tv, 1e-2, weight_decay=0.01, threads=threads)
            jax_host.cpu_adagrad_step(jp, g, jv, 1e-2, weight_decay=0.01)
        else:
            host.cpu_lion_step(tp, tg, tm, 1e-3, weight_decay=0.01, threads=threads)
            jax_host.cpu_lion_step(jp, g, jm, 1e-3, weight_decay=0.01)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_host_adam_matches_k10_plain():
    """The host Adam against K10's plain version (``fused_adam_flat_plain``),
    three steps: within 1e-6."""
    p, m, v, grads = _kernel_inputs(seed=1)
    a = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    b = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    for step, g in enumerate(grads, 1):
        g = torch.from_numpy(g)
        host.cpu_adam_step(a[0], g, a[1], a[2], step, 1e-2, weight_decay=0.1)
        fused_adam_flat_plain(b[0], g, b[1], b[2], step=step, lr=1e-2, weight_decay=0.1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_host_kernel_refuses_bad_buffers():
    t = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous float32"):
        host.cpu_adam_step(t.double(), t, t, t, 1, 1e-3)
    with pytest.raises(ValueError, match="elements"):
        host.cpu_adam_step(t, torch.zeros(9), t, t, 1, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        host.cpu_adam_step(torch.zeros(8, 2)[:, 0], t, t, t, 1, 1e-3)


# ---------------------------------------------------------------------------
# one process: offload against JAX
# ---------------------------------------------------------------------------

def _jax_host_slots(e):
    """JAX's host optimizer state (world of one) as {path: {master, m, v}}."""
    slots = e._host_optimizer.state_dict()["slots"]
    return {k[:-len(".master")]: {f: np.asarray(_node(slots, k[:-len(".master")])[f])
                                  for f in ("master", "m", "v")}
            for k, _ in tree_paths(slots) if k.endswith(".master")}


def _node(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def offload_runs(jax_init):
    """Each offload case (and no offload) run by both packages: losses,
    parameters, host state, Twin-Flow masks."""
    out = {}
    for name, off in [("none", None)] + sorted(OFFLOAD.items()):
        je, te = _jax(_config(off), jax_init), _port(_config(off), jax_init)
        jl = [float(je.train_batch(b)) for b in _batches()]
        tl = [te.train_batch(b).item() for b in _batches()]
        out[name] = dict(jax_loss=jl, port_loss=tl, jax=je, port=te,
                         jax_params=_flat(jax.tree.map(np.asarray, je.module_params)))
    return out


@pytest.mark.parametrize("name", ["none"] + sorted(OFFLOAD))
def test_offload_matches_jax(offload_runs, name):
    run = offload_runs[name]
    np.testing.assert_allclose(run["port_loss"], run["jax_loss"], rtol=1e-5)
    for key, p in tree_paths(run["port"].module_params):
        np.testing.assert_allclose(p.detach().numpy(), run["jax_params"][key], rtol=0,
                                   atol=2e-6, err_msg=key)


@pytest.mark.parametrize("name", ["host", "twinflow"])
def test_host_state_matches_jax(offload_runs, name):
    """The port's host masters and moments against JAX's host optimizer's
    (and Twin-Flow's device half against JAX's), after three steps."""
    run = offload_runs[name]
    te, je = run["port"], run["jax"]
    assert te.optimizer.name == je.optimizer.name == "cpu_adam"
    assert te._host_optimizer._step == je._host_optimizer._step == STEPS
    want = _jax_host_slots(je)
    got = te._host_optimizer.state_dict()["slots"]
    hosted = [k for k, s in tree_paths(got, is_leaf=lambda n: "m" in n) if s is not None]
    assert sorted(hosted) == sorted(want)
    for k in hosted:
        for f in ("master", "m", "v"):
            np.testing.assert_allclose(_node(got, k)[f].numpy(), want[k][f], rtol=0,
                                       atol=2e-6, err_msg=f"{k}.{f}")
    if name == "twinflow":
        assert te._twinflow["mask"] == je._twinflow["mask"]
        assert any(te._twinflow["mask"]) and not all(te._twinflow["mask"])
        dev = te._twinflow["dev_state"]
        jdev = je._twinflow["dev_state"]
        assert dev["step"] == int(jdev["step"]) == STEPS
        for (k, s), m in zip(tree_paths(dev["slots"], is_leaf=lambda n: "m" in n),
                             te._twinflow["mask"]):
            assert (s is None) == m
            if s is not None:
                for f in ("m", "v"):
                    np.testing.assert_allclose(s[f].numpy(), np.asarray(_node(jdev["slots"], k)[f]),
                                               rtol=0, atol=1e-6, err_msg=f"{k}.{f}")


def test_native_false_keeps_a_device_state(offload_runs):
    """``native: false``: Adam's math through the device optimizer over the
    state kept in host memory (on the CPU it is there already)."""
    te = offload_runs["native_false"]["port"]
    assert te._host_optimizer is None and te.opt_state["step"] == STEPS
    assert te.optimizer.name == "cpu_adam"


def _poison_first_step(e, port):
    """Make the first update's gradients non-finite: JAX's grad-accumulate
    output, the port's first parameter gradient (a hook)."""
    if port:
        p = tree_leaves(e.module_params)[0]
        calls = []

        def hook(g):
            calls.append(1)
            return torch.full_like(g, float("inf")) if len(calls) == 1 else g
        p.register_hook(hook)
        return
    fn = e._grad_accum_fn
    calls = []

    def poisoned(*a, **kw):
        loss, acc, gsq = fn(*a, **kw)
        calls.append(1)
        if len(calls) == 1:
            return loss, acc, gsq * float("inf")
        return loss, acc, gsq
    e._grad_accum_fn = poisoned


def test_fp16_overflow_skips_as_jax(jax_init):
    """fp16 with host offload: an overflowing first step is skipped by both
    packages (no host update, the lr schedule not stepped, the loss scale
    halved), and the next two steps match."""
    cfg = _config(OFFLOAD["host"], fp16={"enabled": True, "initial_scale_power": 8,
                                         "hysteresis": 1})
    je, te = _jax(cfg, jax_init), _port(cfg, jax_init)
    _poison_first_step(je, port=False)
    _poison_first_step(te, port=True)
    batches = _batches()
    je.train_batch(batches[0])
    te.train_batch(batches[0])
    assert te._host_optimizer._step == je._host_optimizer._step == 0
    assert te.lr_scheduler.last_batch_iteration == je.lr_scheduler.last_batch_iteration == -1
    assert te.scaler_state.scale == float(je.scaler_state.scale) == 2 ** 7
    assert te.global_steps == je.global_steps == 1
    for key, p in tree_paths(te.module_params):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(_node(jax_init, key)))
    jl = [float(je.train_batch(b)) for b in batches[1:]]
    tl = [te.train_batch(b).item() for b in batches[1:]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert te._host_optimizer._step == je._host_optimizer._step == 2


def test_nvme_matches_runs_without_offload(offload_runs, jax_init, tmp_path):
    """``device: nvme``: the state is parked in files between steps (none
    resident after a step) and the run equals the port's without offload bit
    for bit, and JAX's within the gates."""
    te = _port(_config({"device": "nvme", "nvme_path": str(tmp_path)}), jax_init)
    assert te.opt_state is None and te.optimizer.name == "cpu_adam"
    losses = [te.train_batch(b).item() for b in _batches()]
    assert te.opt_state is None
    assert sorted(p.name for p in (tmp_path / "optimizer").iterdir())[0].startswith("opt_")
    plain = offload_runs["none"]
    assert losses == plain["port_loss"]
    for (k, p), q in zip(tree_paths(te.module_params), tree_leaves(plain["port"].module_params)):
        assert torch.equal(p, q), k
    np.testing.assert_allclose(losses, plain["jax_loss"], rtol=1e-5)


def test_decomposed_api_under_host_offload_equals_train_batch(jax_init):
    """forward / backward / step under host offload give train_batch's
    parameters bit for bit."""
    a, b = _port(_config(OFFLOAD["host"]), jax_init), _port(_config(OFFLOAD["host"]), jax_init)
    for batch in _batches():
        a.train_batch(batch)
        for g in range(2):
            loss = b.forward({k: v[g * 8:(g + 1) * 8] for k, v in batch.items()})
            b.backward(loss)
            b.step()
    for (k, p), q in zip(tree_paths(a.module_params), tree_leaves(b.module_params)):
        assert torch.equal(p, q), k


def test_load_module_state_dict_reseeds_the_host_masters(jax_init):
    """After two steps, loading the initial weights re-seeds the host
    masters (and Twin-Flow's device half): the next step starts from the
    loaded weights, not from the stale masters."""
    for off in (OFFLOAD["host"], OFFLOAD["twinflow"]):
        e = _port(_config(off), jax_init)
        for b in _batches()[:2]:
            e.train_batch(b)
        e.load_module_state_dict(jax_init)
        for k, m in tree_paths(e._host_optimizer.params()):
            if m is not None:
                np.testing.assert_array_equal(m.numpy(), np.asarray(_node(jax_init, k)))
        for k, p in tree_paths(e.module_params):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(_node(jax_init, k)))


UNPORTED = {
    "offload_param_cpu": dict(zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}}),
    "offload_param_nvme": dict(zero_optimization={"stage": 3,
                                                  "offload_param": {"device": "nvme"}}),
    "adagrad_offload": dict(optimizer={"type": "Adagrad", "params": {"lr": 1e-2}},
                            zero_optimization={"stage": 2,
                                               "offload_optimizer": {"device": "cpu"}}),
    "lion_offload": dict(optimizer={"type": "Lion", "params": {"lr": 1e-4}},
                         zero_optimization={"stage": 2,
                                            "offload_optimizer": {"device": "cpu"}}),
    "zeropp": dict(zero_optimization={"stage": 3, "zero_quantized_weights": True}),
    "mics": dict(zero_optimization={"stage": 3, "mics_shard_size": 2}),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_parts_of_item_16_raise(name):
    over = UNPORTED[name]
    cfg = _config(**{k: v for k, v in over.items()})
    with pytest.raises(NotImplementedError, match="item 16"):
        _port(cfg)


def test_remote_device_init_and_async_save_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 16"):
        zero.Init(remote_device="cpu")
    e = _port(_config(OFFLOAD["host"], checkpoint={"async_save": True}))
    with pytest.raises(NotImplementedError, match="item 16"):
        e.save_checkpoint(str(tmp_path))
