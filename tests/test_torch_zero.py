"""Data parallelism and ZeRO stages 0-3 of the port against the JAX package.

One process: each leaf's ZeRO dims against JAX's ``tree_specs`` under
``zero_rules`` / ``optimizer_state_rules`` on data meshes of 2, 3 and 4
forced CPU devices; a world of one, where stage 3 trains bit for bit as
stage 0 and every collective is the identity; the refusals.

Across two processes (``python -c`` children over gloo, each killed after
``CHILD_TIMEOUT_S``; one spawn runs the whole battery): JAX engines on a
data mesh of 2 start from the same weights as the children's port
engines (carried by ``load_module_state_dict``) and take the same three
steps (gas 2, clipping 1.0, AdamW + WarmupLR, the second step with a
``loss_mask`` that gives the two ranks unequal counts of valid labels) at
stages 0-3 on ``tiny`` and ``tiny-gpt2`` (biases, a tied embedding): the
losses (rtol 1e-5), the gathered parameters (atol 2e-6, as
``tests/test_torch_train.py``) and each rank's m / v shard against JAX's
shard on that rank, the same shape (atol 1e-6). Also: an fp16 step whose
gradients overflow on one rank only is skipped by both, as JAX skips it;
``forward`` / ``backward`` / ``step`` over global micro-batches equals
``train_batch`` bit for bit at stage 3; ``eval_batch`` is JAX's; stage 3's
``GatheredParameters`` and ``module_state_dict()`` give whole tensors;
``param_persistence_threshold`` keeps JAX's leaves whole; and the stage-3
init at world 2, gathered, is world 1's bit for bit.

ZeRO-Offload and checkpoints across the two ranks, in the same spawn:
stages 1-3 with the optimizer on the host (native) give JAX's losses and
parameters, and each rank's host m / v / master shard is JAX's host slice
for that rank; a stage-3 ``save_checkpoint`` / ``load_checkpoint`` resumes
step 3 bit for bit, and ``zero_to_fp32`` joins the ranks' shards into the
gathered parameters; a universal checkpoint written at dp 2, stage 3 loads
at dp 1, and one written at dp 1 loads at dp 2, stage 3, each continuing
within rtol 1e-5 of the writer's own step 3. Every engine is f32 on tiny
models, torch on one thread.
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import deepspeed_tpu as jds
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel import sharding as JS
from deepspeed_tpu.utils import groups as jax_groups
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.parallel import sharding as TS
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.checkpoint import ds_to_universal, load_universal_checkpoint
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120
PRESETS = ("tiny", "tiny-gpt2")
STAGES = (0, 1, 2, 3)
OFFLOAD_STAGES = (1, 2, 3)
DP = 2
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    groups.reset()


def _config(stage=0, dp=DP, **over):
    cfg = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8 // dp,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                        "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9, "seed": 7,
           "zero_optimization": {"stage": stage}}
    cfg.update(over)
    return cfg


def _batches(masked=True):
    """Three global batches of 16 rows (2 micro-batches of 8: rank 0 takes
    rows 0-3 of each, rank 1 rows 4-7). ``masked``: each carries a
    loss_mask (one compiled JAX step): all ones; about a fifth of rank 0's
    labels and most of rank 1's; none of rank 0's in the first
    micro-batch."""
    out = []
    for step in range(STEPS):
        ids = np.random.default_rng(10 + step).integers(0, 256, (16, 32)).astype(np.int32)
        b = {"input_ids": ids, "labels": np.roll(ids, -1, axis=1)}
        if masked:
            keep = np.where((np.arange(16) % 8 < 4)[:, None], 0.2, 0.9)
            mask = np.random.default_rng(40 + step).random((16, 32)) < keep
            b["loss_mask"] = [np.ones_like(mask), mask,
                              mask & (np.arange(16) >= 4)[:, None]][step].astype(np.float32)
        out.append(b)
    return out


def _dims(spec_tree):
    """A JAX PartitionSpec tree as the port's: each leaf's "data" dim or None."""
    def one(p):
        for i, part in enumerate(p):
            if part == "data" or (isinstance(part, tuple) and "data" in part):
                return i
        return None
    return jax.tree.map(one, spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_paths(tree)}


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("dp", [2, 3, 4])
def test_zero_dims_match_jax(preset, dp):
    """Each leaf's split dim of parameters and optimizer state at stages
    0-3 is JAX's on a data mesh of ``dp`` (dp 3 divides no embed dim)."""
    jm, tm = jax_build_model(preset), build_model(preset)
    mesh = jax_groups.build_mesh(devices=jax.devices()[:dp], data=dp)
    for stage in STAGES:
        for jrules, trules in ((JS.zero_rules(stage), TS.zero_rules(stage)),
                               (JS.optimizer_state_rules(stage),
                                TS.optimizer_state_rules(stage))):
            want = _dims(JS.tree_specs(jm.abstract_params(), jm.logical_axes(), jrules, mesh))
            got = TS.zero_specs(tm.abstract_params(), tm.logical_axes(), trules, dp)
            assert got == want, (stage, trules)


def test_world_of_one_stage3_is_stage0_bit_for_bit():
    """In a world of one every stage holds the full state and runs no
    collective: stage 3 trains as stage 0, losses and parameters equal."""
    runs = []
    for stage in (0, 3):
        e, _, _, _ = tds.initialize(model=build_model("tiny-gpt2"), device="cpu",
                                    config=_config(stage, dp=1))
        assert e.dp_world_size == 1 and e.partition is None
        runs.append(([e.train_batch(b).item() for b in _batches()], e.module_params))
    (l0, p0), (l3, p3) = runs
    assert l0 == l3
    for a, b in zip(tree_leaves(p0), tree_leaves(p3)):
        assert torch.equal(a, b)


def test_world_of_one_collectives_and_gathers_are_the_identity():
    x = torch.arange(12.0).reshape(3, 4)
    assert comm.reduce_scatter_tensor(x, dim=1) is x
    assert groups.resolve_data_degree({}, 1) == 1
    assert groups.resolve_data_degree({"data": "auto"}, 4) == 4
    with pytest.raises(ValueError, match="world of 2"):
        groups.resolve_data_degree({"data": 4}, 2)
    with zero.GatheredParameters([x]) as full:
        assert full[0] is x
    assert zero.unwrap_model_for_generation(x) is x
    with zero.Init():
        pass
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zero.Init(remote_device="cpu")


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

CHILD = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.optimizers import is_slot
from deepspeed_tpu_torch.checkpoint import ds_to_universal, load_universal_checkpoint
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.utils import zero_to_fp32
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths

comm.init_distributed(dist_backend="gloo")
rank = comm.get_rank()
spec = json.load(open(sys.argv[1]))
out_path = sys.argv[2]
def as_batches(bs):
    return [{k: np.asarray(v, np.float32 if k == "loss_mask" else np.int32)
             for k, v in b.items()} for b in bs]


batches = as_batches(spec["batches"])
init = {p: dict(np.load(spec["init"][p])) for p in spec["presets"]}
out = {}


def nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def engine(preset, cfg, load=True):
    e, _, _, _ = tds.initialize(model=build_model(preset), config=cfg, device="cpu")
    if load:
        e.load_module_state_dict(nest(init[preset]))
    return e


def save(prefix, e, losses=None):
    if losses is not None:
        out[prefix + "/loss"] = np.asarray(losses)
    for k, v in tree_paths(e.module_state_dict()):
        out[f"{prefix}/param/{k}"] = v.numpy()
    slots = tree_leaves(e.opt_state["slots"], is_leaf=is_slot)
    for (k, _), s in zip(tree_paths(e.module_params), slots):
        out[f"{prefix}/m/{k}"] = s["m"].numpy()
        out[f"{prefix}/v/{k}"] = s["v"].numpy()


for preset in spec["presets"]:
    for stage in spec["stages"]:
        cfg = spec["config"][str(stage)]
        e = engine(preset, cfg)
        save(f"{preset}/{stage}", e, [e.train_batch(b).item() for b in batches])
        if preset == "tiny" and stage == 3:
            # forward/backward/step over the global micro-batches
            f = engine(preset, cfg)
            losses = []
            for b in batches:
                micro = []
                for g in range(2):
                    loss = f.forward({k: v[g * 8:(g + 1) * 8] for k, v in b.items()})
                    f.backward(loss)
                    f.step()
                    micro.append(loss.item())
                losses.append(sum(micro) / 2)
            save("fbs", f, losses)
            out["eval"] = np.asarray(e.eval_batch(batches[0]).item())
            with zero.GatheredParameters(e.module_params) as full:
                gathered = {k: v.detach().numpy() for k, v in tree_paths(full)}
            state = {k: v.numpy() for k, v in tree_paths(e.module_state_dict())}
            out["gathered_equal"] = np.asarray(all(
                np.array_equal(gathered[k], state[k]) for k in state))
            out["local_shapes"] = np.asarray(json.dumps(
                {k: list(v.shape) for k, v in tree_paths(e.module_params)}))

    # the seeded init at world 2, gathered
    e = engine(preset, spec["config"]["3"], load=False)
    for k, v in tree_paths(e.module_state_dict()):
        out[f"init/{preset}/{k}"] = v.numpy()

# stage 3 with the persistence threshold: small leaves stay whole
e = engine("tiny-gpt2", spec["persist_config"])
out["persist/whole"] = np.asarray(json.dumps(
    {k: getattr(v, "ds_dim", None) is None for k, v in tree_paths(e.module_params)}))
save("persist", e, [e.train_batch(b).item() for b in as_batches(spec["plain_batches"])])

# fp16: one rank's gradients overflow, both ranks skip
e = engine("tiny", spec["fp16_config"])
before = [p.detach().clone() for p in tree_leaves(e.module_params)]
for i, p in enumerate(tree_leaves(e.module_params)):
    p.grad = torch.zeros_like(p)
    if rank == 0 and i == 0:
        p.grad.fill_(float("inf"))
e._acc_count = 1
e.micro_steps = e.gradient_accumulation_steps()
e.step()
out["fp16/unchanged"] = np.asarray(all(torch.equal(a.detach(), b) for a, b in
                                       zip(tree_leaves(e.module_params), before)))
out["fp16/scale"] = np.asarray(e.scaler_state.scale)
out["fp16/opt_step"] = np.asarray(e.opt_state["step"])

# host offload at stages 1-3: each rank's host shards
for stage in spec["offload_stages"]:
    e = engine("tiny", spec["offload_config"][str(stage)])
    losses = [e.train_batch(b).item() for b in batches]
    out[f"offload/{stage}/loss"] = np.asarray(losses)
    for k, v in tree_paths(e.module_state_dict()):
        out[f"offload/{stage}/param/{k}"] = v.numpy()
    for k, t in tree_paths(e._host_optimizer.state_dict()["slots"]):
        out[f"offload/{stage}/host/{k}"] = t.numpy()

# stage 3: a port-format save and load, zero_to_fp32, universal at dp 2
cfg3 = spec["config"]["3"]
e = engine("tiny", cfg3)
for b in batches[:2]:
    e.train_batch(b)
saved = {k: v.numpy().copy() for k, v in tree_paths(e.module_state_dict())}
e.save_checkpoint(spec["ckpt_dir"])
ds_to_universal(e, spec["uni_dp2"])
out["ckpt/loss3"] = np.asarray(e.train_batch(batches[2]).item())
full = {k: v.numpy() for k, v in tree_paths(e.module_state_dict())}
f = engine("tiny", cfg3, load=False)
f.load_checkpoint(spec["ckpt_dir"])
out["ckpt/resumed_loss3"] = np.asarray(f.train_batch(batches[2]).item())
out["ckpt/resumed_equal"] = np.asarray(all(
    np.array_equal(v.numpy(), full[k]) for k, v in tree_paths(f.module_state_dict())))
fp32 = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(spec["ckpt_dir"])
out["ckpt/fp32_equal"] = np.asarray(sorted(fp32) == sorted(saved) and all(
    np.array_equal(fp32[k], saved[k]) for k in saved))

# the universal checkpoint written at dp 1 (by the test process), at dp 2, stage 3
u = engine("tiny", cfg3, load=False)
load_universal_checkpoint(u, spec["uni_dp1"])
out["uni/from_dp1_loss3"] = np.asarray(u.train_batch(batches[2]).item())
out["uni/from_dp1_steps"] = np.asarray(u.global_steps)

np.savez(out_path, **out)
print("done", rank)
'''


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(spec_path, out_dir):
    env = {**os.environ, "PYTHONPATH": str(REPO), "WORLD_SIZE": str(DP),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", CHILD, str(spec_path),
                              str(out_dir / f"rank{r}.npz")],
                             cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             env={**env, "RANK": str(r)}) for r in range(DP)]


def _collect(children, out_dir):
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        outs = [c.communicate(timeout=max(1.0, deadline - time.monotonic())) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    for rank, (c, (_, err)) in enumerate(zip(children, outs)):
        assert c.returncode == 0, f"rank {rank}: {err[-3000:]}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(DP)]


def _jax_mesh():
    jax_groups.set_mesh(jax_groups.build_mesh(devices=jax.devices()[:DP], data=DP))


JAX_MODELS = {p: jax_build_model(p) for p in PRESETS}


def _jax_engine(preset, cfg, init):
    """A JAX engine on the data mesh of 2 from ``init``'s weights (one model
    object a preset: engines of the same shardings share compiled inits)."""
    e, _, _, _ = jds.initialize(model=JAX_MODELS[preset], config=cfg)
    if init is not None:
        e.load_module_state_dict(jax.tree.map(np.asarray, init))
    return e


def _shard(arr, rank):
    """JAX's shard of ``arr`` on data rank ``rank`` (the mesh's device
    ``rank``)."""
    dev = jax.devices()[rank]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def _jax_host_shards(e, keys):
    """JAX's host optimizer slices by (rank, field, dotted path): each data
    rank's device's slice of each leaf (``keys``: the leaves' paths in tree
    order)."""
    out = {}
    for key, leaf in zip(keys, e._host_optimizer._leaves):
        for dev, idx, _ in leaf["devices"]:
            for f in ("master", "m", "v"):
                out[(jax.devices().index(dev), f, key)] = leaf["slices"][idx][f]
    return out


def _offload_config(stage):
    cfg = _config(stage)
    cfg["zero_optimization"]["offload_optimizer"] = {"device": "cpu"}
    return cfg


def _jax_run_host(e, batches):
    losses = [float(e.train_batch(b)) for b in batches]
    params = _flat(jax.tree.map(np.asarray, e.module_params))
    return {"loss": losses, "params": params, "host": _jax_host_shards(e, list(params))}


def _jax_run(e, batches):
    losses = [float(e.train_batch(b)) for b in batches]
    params = _flat(jax.tree.map(np.asarray, e.module_params))
    slots = {}
    for rank in range(DP):
        for key, leaf in zip(params, jax.tree.leaves(
                e.opt_state["slots"], is_leaf=lambda x: isinstance(x, dict) and "m" in x)):
            slots[(rank, "m", key)] = _shard(leaf["m"], rank)
            slots[(rank, "v", key)] = _shard(leaf["v"], rank)
    return {"loss": losses, "params": params, "slots": slots}


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """The children's results and the JAX references: JAX's initial weights
    first (the children load them), the rest while the children run, four
    JAX engines at a time (their compiles overlap)."""
    tmp = tmp_path_factory.mktemp("zero")
    batches, plain = _batches(), _batches(masked=False)
    _jax_mesh()
    inits, stage0 = {}, {}
    for preset in PRESETS:
        stage0[preset] = _jax_engine(preset, _config(0), None)
        inits[preset] = jax.tree.map(np.asarray, stage0[preset].module_params)
        np.savez(tmp / f"init_{preset}.npz", **_flat(inits[preset]))
    persist = _config(3, zero_optimization={"stage": 3,
                                            "stage3_param_persistence_threshold": 10000})
    fp16 = _config(2, fp16={"enabled": True, "initial_scale_power": 4, "hysteresis": 1})
    # a universal checkpoint written at dp 1 (stage 3 in a world of one), for
    # the children to load at dp 2
    one = tds.initialize(model=build_model("tiny"), device="cpu", config=_config(3, dp=1))[0]
    one.load_module_state_dict(inits["tiny"])
    for b in batches[:2]:
        one.train_batch(b)
    ds_to_universal(one, str(tmp / "uni_dp1"))
    dp1_loss3 = one.train_batch(batches[2]).item()
    del one
    groups.reset()
    spec = {"presets": PRESETS, "stages": STAGES,
            "offload_stages": OFFLOAD_STAGES,
            "offload_config": {str(s): _offload_config(s) for s in OFFLOAD_STAGES},
            "ckpt_dir": str(tmp / "ckpt"), "uni_dp2": str(tmp / "uni_dp2"),
            "uni_dp1": str(tmp / "uni_dp1"),
            "batches": [{k: v.tolist() for k, v in b.items()} for b in batches],
            "plain_batches": [{k: v.tolist() for k, v in b.items()} for b in plain],
            "init": {p: str(tmp / f"init_{p}.npz") for p in PRESETS},
            "config": {str(s): _config(s) for s in STAGES},
            "persist_config": persist, "fp16_config": fp16}
    (tmp / "spec.json").write_text(json.dumps(spec))

    def run(job):
        if job == "persist":
            e = _jax_engine("tiny-gpt2", persist, inits["tiny-gpt2"])
            whole = {k: s.is_fully_replicated for k, s in
                     tree_paths(jax.tree.map(lambda a: a.sharding, e.module_params))}
            return {**_jax_run(e, plain), "whole": whole}
        if job == "fp16":
            e = _jax_engine("tiny", fp16, inits["tiny"])
            e._acc_grads = jax.tree.map(lambda p: jax.numpy.full(p.shape, jax.numpy.inf),
                                        e.module_params)
            e._acc_count = 1
            e.micro_steps = e.gradient_accumulation_steps()
            e.step()
            return {"scale": float(e.scaler_state.scale), "step": int(e.opt_state["step"])}
        if job[0] == "offload":
            # its own model object: the fp16 job recasts the shared one's dtype
            e, _, _, _ = jds.initialize(model=jax_build_model("tiny"),
                                        config=_offload_config(job[1]))
            e.load_module_state_dict(jax.tree.map(np.asarray, inits["tiny"]))
            return _jax_run_host(e, batches)
        preset, stage = job
        e = stage0[preset] if stage == 0 else _jax_engine(preset, _config(stage), inits[preset])
        out = _jax_run(e, batches)
        if job == ("tiny", 3):
            out["eval"] = float(e.eval_batch(batches[0]))
        return out

    jobs = [(p, s) for p in PRESETS for s in STAGES] + ["persist", "fp16"] + \
        [("offload", s) for s in OFFLOAD_STAGES]
    children = _spawn(tmp / "spec.json", tmp)
    try:
        with ThreadPoolExecutor(4) as pool:
            refs = dict(zip(jobs, pool.map(run, jobs)))
    finally:
        results = _collect(children, tmp)
    refs["dp1_loss3"] = dp1_loss3
    refs["uni_dp2"] = str(tmp / "uni_dp2")
    return results, refs


def _check_run(results, prefix, ref):
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r[prefix + "/loss"], ref["loss"], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        for key, want in ref["params"].items():
            np.testing.assert_allclose(r[f"{prefix}/param/{key}"], want, rtol=0, atol=2e-6,
                                       err_msg=f"rank {rank} {key}")
            for slot in ("m", "v"):
                got, jx = r[f"{prefix}/{slot}/{key}"], ref["slots"][(rank, slot, key)]
                assert got.shape == jx.shape, (rank, slot, key)
                np.testing.assert_allclose(got, jx, rtol=0, atol=1e-6,
                                           err_msg=f"rank {rank} {slot} {key}")


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("stage", STAGES)
def test_dp2_matches_jax(battery, preset, stage):
    """Three steps at stage ``stage`` over two ranks (one with a loss_mask
    of unequal counts) give JAX's losses, parameters and m / v shards."""
    results, refs = battery
    _check_run(results, f"{preset}/{stage}", refs[(preset, stage)])


def test_dp2_persistence_threshold_keeps_small_leaves_whole(battery):
    results, refs = battery
    whole = refs["persist"]["whole"]
    for r in results:
        assert json.loads(str(r["persist/whole"])) == whole
    assert not all(whole.values()) and any(whole.values())
    _check_run(results, "persist", refs["persist"])


def test_dp2_forward_backward_step_equals_train_batch(battery):
    """The decomposed API over global micro-batches gives train_batch's
    parameters bit for bit (stage 3), and its loss to f32 rounding (the
    mean of two global micro-batch losses against the global mean of the
    ranks' sums)."""
    results, _ = battery
    for r in results:
        np.testing.assert_allclose(r["fbs/loss"], r["tiny/3/loss"], rtol=1e-6)
        for key in [k for k in r if k.startswith("tiny/3/param/")]:
            np.testing.assert_array_equal(r[key.replace("tiny/3", "fbs")], r[key])


def test_dp2_eval_batch_matches_jax(battery):
    results, refs = battery
    for r in results:
        np.testing.assert_allclose(float(r["eval"]), refs[("tiny", 3)]["eval"], rtol=1e-5)


def test_dp2_stage3_gathers_whole_tensors(battery):
    """GatheredParameters and module_state_dict give the whole tensors;
    each rank holds half of every split leaf."""
    results, refs = battery
    full = refs[("tiny", 3)]["params"]
    for r in results:
        assert bool(r["gathered_equal"])
        local = json.loads(str(r["local_shapes"]))
        assert {k: tuple(r[f"tiny/3/param/{k}"].shape) for k in full} == \
            {k: v.shape for k, v in full.items()}
        assert any(tuple(local[k]) != full[k].shape for k in full)


def test_dp2_fp16_overflow_on_one_rank_skips_on_both(battery):
    results, refs = battery
    for r in results:
        assert bool(r["fp16/unchanged"])
        assert float(r["fp16/scale"]) == refs["fp16"]["scale"] < 2 ** 4
        assert int(r["fp16/opt_step"]) == refs["fp16"]["step"] == 0


@pytest.mark.parametrize("preset", PRESETS)
def test_dp2_stage3_init_is_world_one_init(battery, preset):
    """Every rank draws the seeded init whole and keeps its shard: gathered,
    the parameters are a world-1 engine's, bit for bit."""
    results, _ = battery
    e, _, _, _ = tds.initialize(model=build_model(preset), device="cpu",
                                config=_config(3, dp=1))
    for r in results:
        for key, want in tree_paths(e.module_params):
            np.testing.assert_array_equal(r[f"init/{preset}/{key}"], want.detach().numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("stage", OFFLOAD_STAGES)
def test_dp2_host_offload_matches_jax(battery, stage):
    """Host offload over two ranks at stage ``stage``: JAX's losses and
    parameters, and each rank's host master / m / v shard is JAX's host
    slice on that rank (the same shape)."""
    results, refs = battery
    ref = refs[("offload", stage)]
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r[f"offload/{stage}/loss"], ref["loss"], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        for key, want in ref["params"].items():
            np.testing.assert_allclose(r[f"offload/{stage}/param/{key}"], want, rtol=0,
                                       atol=2e-6, err_msg=f"rank {rank} {key}")
            for f in ("master", "m", "v"):
                got, jx = r[f"offload/{stage}/host/{key}.{f}"], ref["host"][(rank, f, key)]
                assert got.shape == jx.shape, (rank, f, key)
                np.testing.assert_allclose(got, jx, rtol=0, atol=2e-6 if f == "master" else 1e-6,
                                           err_msg=f"rank {rank} {f} {key}")


def test_dp2_stage3_checkpoint_resumes_bit_identical(battery):
    """A stage-3 save after step 2 and a fresh engine's load: step 3 is the
    unbroken run's bit for bit on both ranks; ``zero_to_fp32`` joins the
    ranks' shards into the gathered parameters."""
    results, _ = battery
    for r in results:
        assert float(r["ckpt/resumed_loss3"]) == float(r["ckpt/loss3"])
        assert bool(r["ckpt/resumed_equal"]) and bool(r["ckpt/fp32_equal"])


def test_dp2_universal_loads_at_dp1(battery):
    """The universal checkpoint the two stage-3 ranks wrote after step 2
    loads into a one-process engine, whose step 3 is theirs within 1e-5."""
    results, refs = battery
    e, _, _, _ = tds.initialize(model=build_model("tiny"), device="cpu",
                                config=_config(3, dp=1))
    meta = load_universal_checkpoint(e, refs["uni_dp2"])
    assert meta["zero_stage"] == 3 and e.global_steps == 2
    np.testing.assert_allclose(e.train_batch(_batches()[2]).item(),
                               float(results[0]["ckpt/loss3"]), rtol=1e-5)


def test_dp1_universal_loads_at_dp2(battery):
    """A universal checkpoint written by one process loads into two
    stage-3 ranks, whose step 3 is the writer's within 1e-5."""
    results, refs = battery
    for r in results:
        assert int(r["uni/from_dp1_steps"]) == 3
        np.testing.assert_allclose(float(r["uni/from_dp1_loss3"]), refs["dp1_loss3"], rtol=1e-5)
