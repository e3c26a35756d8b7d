"""Checkpoints of the port's training engine, and against the JAX package.

Save / load (``runtime/checkpoint_engine``): after a load, step 3 is the
unbroken run's bit for bit, on the card's optimizer (stage 0), under host
offload, Twin-Flow, NVMe and fp16 (the loss scaler's state); ``latest``,
tags, ``client_state``, ``load_module_only``, the lr schedule and the
scaler; a checkpoint of another degree or stage is refused.

Universal (``checkpoint/universal.py``), across the packages: a JAX engine
writes after step 2 and a port engine loads it, a port engine writes and a
JAX engine loads it, and step 3 after either load matches JAX's unbroken
step 3 within rtol 1e-5 (no lr schedule: a universal checkpoint carries
none, in either package); the two indexes list the same entries, shapes
and dtypes, Twin-Flow's masked leaves included. Across degrees see
``tests/test_torch_zero.py``.

``zero_to_fp32``: the port's on a port checkpoint equals JAX's on a JAX
checkpoint after the same steps (the same keys, atol 2e-6). Every engine is
f32 on ``tiny``, torch on one thread.
"""

import json

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint import universal as jax_universal
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu.utils import zero_to_fp32 as jax_z2f
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import ds_to_universal, load_universal_checkpoint
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.utils import zero_to_fp32
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths

OFFLOAD = {"dev": None, "host": {"device": "cpu"},
           "twinflow": {"device": "cpu", "ratio": 0.5}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(offload=None, schedule=True, **over):
    cfg = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9, "seed": 7,
           "zero_optimization": {"stage": 0}}
    if schedule:
        cfg["scheduler"] = {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                          "warmup_type": "linear"}}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
    cfg.update(over)
    return cfg


def _batches():
    out = []
    for step in range(3):
        ids = np.random.default_rng(10 + step).integers(0, 256, (16, 32)).astype(np.int32)
        out.append({"input_ids": ids, "labels": np.roll(ids, -1, axis=1)})
    return out


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


def _params(e):
    return {k: p.detach().clone() for k, p in tree_paths(e.module_params)}


@pytest.fixture(scope="module")
def jax_init():
    return jax.tree.map(np.asarray, _jax(_config()).module_params)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

RESUME = {"dev": _config(), "host": _config(OFFLOAD["host"]),
          "twinflow": _config(OFFLOAD["twinflow"]),
          "nvme": _config({"device": "nvme"}),
          "fp16_dev": _config(fp16={"enabled": True, "initial_scale_power": 8})}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_save_load_resumes_bit_identical(name, tmp_path):
    """Two steps, save, a third step; a fresh engine loads and takes the
    third step: the same loss and parameters bit for bit, and the same
    counters, lr and loss scale."""
    cfg = json.loads(json.dumps(RESUME[name]))
    if name == "nvme":
        cfg["zero_optimization"]["offload_optimizer"]["nvme_path"] = str(tmp_path / "a")
    batches = _batches()
    a = _port(cfg)
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ckpt"))
    saved_scaler = a.scaler_state
    want_loss = a.train_batch(batches[2]).item()
    if name == "nvme":
        cfg["zero_optimization"]["offload_optimizer"]["nvme_path"] = str(tmp_path / "b")
    b = _port(cfg)
    path, client = b.load_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith("global_step2") and client == {}
    assert (b.global_steps, b.global_samples, b.micro_steps) == (2, 32, 4)
    assert b.scaler_state == saved_scaler
    assert b.train_batch(batches[2]).item() == want_loss
    assert b.get_lr() == a.get_lr() and b.scaler_state == a.scaler_state
    for k, p in _params(a).items():
        assert torch.equal(p, _params(b)[k]), k


def test_latest_tags_and_client_state(tmp_path):
    e = _port(_config(OFFLOAD["host"]))
    assert e.load_checkpoint(str(tmp_path)) == (None, {})
    batches = _batches()
    e.train_batch(batches[0])
    e.save_checkpoint(str(tmp_path), tag="first", client_state={"epoch": 1})
    e.train_batch(batches[1])
    e.save_checkpoint(str(tmp_path), client_state={"epoch": 2})
    assert (tmp_path / "latest").read_text() == "global_step2"
    meta = json.loads((tmp_path / "global_step2" / "ds_meta.json").read_text())
    assert sorted(meta) == ["client_state", "global_samples", "global_steps", "lr_scheduler",
                            "micro_steps", "skipped_steps", "zero_stage"]
    f = _port(_config(OFFLOAD["host"]))
    assert f.load_checkpoint(str(tmp_path))[1] == {"epoch": 2} and f.global_steps == 2
    path, client = f.load_checkpoint(str(tmp_path), tag="first")
    assert path.endswith("first") and client == {"epoch": 1} and f.global_steps == 1
    e.save_checkpoint(str(tmp_path), tag="other", save_latest=False)
    assert (tmp_path / "latest").read_text() == "global_step2"


def test_load_module_only_and_without_optimizer_states(tmp_path):
    """``load_module_only`` takes the weights and re-seeds the host masters
    from them (the next update starts there), nothing else;
    ``load_optimizer_states=False`` keeps the fresh optimizer state and
    re-seeds it too."""
    batches = _batches()
    a = _port(_config(OFFLOAD["host"]))
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path))
    for kw in ({"load_module_only": True}, {"load_optimizer_states": False}):
        b = _port(_config(OFFLOAD["host"]))
        b.load_checkpoint(str(tmp_path), **kw)
        assert b._host_optimizer._step == 0
        assert b.global_steps == (0 if "load_module_only" in kw else 2)
        for k, m in tree_paths(b._host_optimizer.params()):
            assert torch.equal(m, _params(a)[k]), k
        b.train_batch(batches[2])
        assert b._host_optimizer._step == 1


def test_lr_schedule_and_loss_scaler_restored(tmp_path):
    """An fp16 run whose first step overflows: the shrunk scale, its counters
    and the schedule's position come back; ``load_lr_scheduler_states=False``
    leaves the fresh schedule."""
    cfg = _config(fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 1})
    a = _port(cfg)
    p = tree_leaves(a.module_params)[0]
    p.register_hook(lambda g: torch.full_like(g, float("inf")) if a.global_steps == 0 else g)
    for b in _batches()[:2]:
        a.train_batch(b)
    a._post_step(False, None)     # flush the overflow window into skipped_steps
    a.save_checkpoint(str(tmp_path))
    assert a.scaler_state.scale == 2 ** 7 and a.scaler_state.overflows == 1
    b = _port(cfg)
    b.load_checkpoint(str(tmp_path))
    assert b.scaler_state == a.scaler_state and b.skipped_steps == a.skipped_steps
    assert b.lr_scheduler.last_batch_iteration == a.lr_scheduler.last_batch_iteration == 1
    c = _port(cfg)
    c.load_checkpoint(str(tmp_path), load_lr_scheduler_states=False)
    assert c.lr_scheduler.last_batch_iteration == -1 and c.global_steps == 2


def test_port_checkpoint_at_another_layout_raises(tmp_path):
    a = _port(_config())
    a.save_checkpoint(str(tmp_path))
    b = _port(_config(zero_optimization={"stage": 2}))
    with pytest.raises(ValueError, match="universal"):
        b.load_checkpoint(str(tmp_path))


def test_save_16bit_model(tmp_path):
    e = _port(_config(bf16={"enabled": True}))
    path = e.save_16bit_model(str(tmp_path))
    sd = torch.load(path)
    assert sorted(sd) == sorted(k for k, _ in tree_paths(e.module_params))
    for k, p in tree_paths(e.module_params):
        assert sd[k].dtype == torch.bfloat16 and torch.equal(sd[k], p.detach().bfloat16())


# ---------------------------------------------------------------------------
# universal, across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def universal_runs(jax_init, tmp_path_factory):
    """Per case: JAX's unbroken third loss; the third loss after the port
    loads JAX's universal checkpoint and after JAX loads the port's; both
    indexes."""
    tmp = tmp_path_factory.mktemp("universal")
    batches = _batches()
    out = {}
    for name, off in OFFLOAD.items():
        cfg = _config(off, schedule=False)
        je, te = _jax(cfg, jax_init), _port(cfg, jax_init)
        for b in batches[:2]:
            je.train_batch(b)
            te.train_batch(b)
        jdir, tdir = tmp / f"jax_{name}", tmp / f"port_{name}"
        jax_universal.ds_to_universal(je, str(jdir))
        ds_to_universal(te, str(tdir))
        want = float(je.train_batch(batches[2]))
        tp = _port(cfg)
        meta = load_universal_checkpoint(tp, str(jdir))
        jp = _jax(cfg)
        jax_universal.load_universal_checkpoint(jp, str(tdir))
        out[name] = dict(want=want, port_from_jax=tp.train_batch(batches[2]).item(),
                         jax_from_port=float(jp.train_batch(batches[2])), meta=meta,
                         steps=(tp.global_steps, jp.global_steps),
                         jax_index=json.loads((jdir / "universal_index.json").read_text()),
                         port_index=json.loads((tdir / "universal_index.json").read_text()),
                         port_dir=tdir)
    return out


def _entries(index):
    return sorted((e["section"], e["path"], tuple(e.get("shape", ())), e.get("dtype"),
                   e.get("file"), bool(e.get("none"))) for e in index["params"])


@pytest.mark.parametrize("name", sorted(OFFLOAD))
def test_universal_indexes_match_jax(universal_runs, name):
    run = universal_runs[name]
    assert _entries(run["port_index"]) == _entries(run["jax_index"])
    assert run["port_index"]["meta"] == run["jax_index"]["meta"]
    if name == "twinflow":
        sections = {e["section"] for e in run["port_index"]["params"]}
        assert sections == {"module", "optimizer", "twinflow"}
        assert any(e.get("none") for e in run["port_index"]["params"])


@pytest.mark.parametrize("direction", ["port_from_jax", "jax_from_port"])
@pytest.mark.parametrize("name", sorted(OFFLOAD))
def test_universal_crosses_the_packages(universal_runs, name, direction):
    run = universal_runs[name]
    np.testing.assert_allclose(run[direction], run["want"], rtol=1e-5)
    assert run["steps"] == (3, 3) and run["meta"]["global_steps"] == 2


def test_universal_twinflow_needs_its_section(universal_runs):
    """A Twin-Flow engine refuses a universal checkpoint without the device
    half's section (saved at ratio 1), as JAX does."""
    e = _port(_config(OFFLOAD["twinflow"], schedule=False))
    with pytest.raises(ValueError, match="twinflow"):
        load_universal_checkpoint(e, str(universal_runs["host"]["port_dir"]))


def test_universal_across_stages_in_one_process(universal_runs):
    """The host-offload universal checkpoint loads into a stage-3 engine on
    the card's optimizer: the host masters become its parameters, m and v
    its slots."""
    e = _port(_config(zero_optimization={"stage": 3}, schedule=False))
    load_universal_checkpoint(e, str(universal_runs["host"]["port_dir"]))
    want = universal_runs["host"]
    np.testing.assert_allclose(e.train_batch(_batches()[2]).item(), want["want"], rtol=1e-5)


# ---------------------------------------------------------------------------
# zero_to_fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dev", "host"])
def test_zero_to_fp32_matches_jax(name, jax_init, tmp_path):
    cfg = _config(OFFLOAD[name])
    je, te = _jax(cfg, jax_init), _port(cfg, jax_init)
    for b in _batches()[:2]:
        je.train_batch(b)
        te.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"))
    te.save_checkpoint(str(tmp_path / "port"))
    want = jax_z2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "jax"))
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6, err_msg=k)
    if name == "host":
        out = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
            str(tmp_path / "port"), str(tmp_path / "fp32.npz"), tag="global_step2")
        with np.load(out) as f:
            assert sorted(f.files) == sorted(got)
