"""Adam of the PyTorch port against the JAX package.

``fused_adam_flat_plain`` (the plain version of the port's kernel K10) is
held to the JAX ``fused_adam_flat`` (the Pallas kernel in interpret mode
for a length that is a multiple of 128, its XLA branch otherwise), and the
port's ``FusedAdam``/``FusedAdamW.apply`` to the JAX ``apply`` over three
steps, with and without f32 master weights. f32 throughout; tolerance
1e-6 absolute and relative (one f32 evaluation of the same formula against
another: ``pow`` and the fused multiply-adds may round one ulp apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optimizers as jax_opt
from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_flat as jax_fused_adam_flat
from deepspeed_tpu_torch.ops import optimizers as port_opt
from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat, fused_adam_flat_plain
from deepspeed_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 1e-6


@pytest.mark.parametrize("n", [4096, 1000])
def test_fused_adam_flat_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32) * 0.01
    kw = dict(step=5, lr=3e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    want = jax_fused_adam_flat(*(jnp.asarray(a) for a in (p, g, m, v)), **kw)
    got = [torch.from_numpy(a.copy()) for a in (p, g, m, v)]
    fused_adam_flat(*got, **kw)       # CPU tensors: the plain version, in place
    for w, t in zip(want, (got[0], got[2], got[3])):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_cpu_tensors_do_not_count_launches():
    before = fused_adam_flat.launches
    t = [torch.ones(8) for _ in range(4)]
    fused_adam_flat(*t, step=1, lr=1e-3)
    assert fused_adam_flat.launches == before
    assert fused_adam_flat_plain is not fused_adam_flat


def _tree(rng):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32)
    return make(shapes)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


CONFIGS = {
    "adamw_decay": ("adamw", {"lr": 2e-3, "weight_decay": 0.1, "betas": (0.9, 0.95)}),
    "adam": ("adam", {"lr": 1e-3}),
    "adam_l2_decay": ("adam", {"lr": 1e-3, "weight_decay": 0.05, "adam_w_mode": False}),
    "amsgrad": ("adamw", {"lr": 1e-3, "amsgrad": True}),
    "no_bias_correction": ("fusedadam", {"lr": 1e-3, "bias_correction": False}),
}


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_apply_matches_jax_over_three_steps(config, masters):
    name, hyper = CONFIGS[config]
    rng = np.random.default_rng(len(config) + masters)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if masters else (jnp.float32, torch.float32)

    jo = jax_opt.build_optimizer(name, dict(hyper))
    jo.master_weights = masters
    jp = _to(params, lambda a: jnp.asarray(a, jdt))
    js = jo.init(jp)
    to = port_opt.build_optimizer(name, dict(hyper))
    to.master_weights = masters
    tp = _to(params, lambda a: torch.from_numpy(a).to(tdt))
    ts = to.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        jp, js = jo.apply(_to(g, jnp.asarray), js, jp, lr=lr)
        to.apply(_to(g, torch.from_numpy), ts, tp, lr=lr)
    assert ts["step"] == int(js["step"]) == 3
    jleaves, tleaves = jax.tree.leaves(jp), tree_leaves(tp)
    for jl, tl in zip(jleaves, tleaves):
        assert tl.dtype == tdt
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   rtol=TOL, atol=TOL)
    jslots = jax.tree.leaves(js["slots"])
    tslots = [t for s in tree_leaves(ts["slots"], is_leaf=port_opt.is_slot)
              for t in (s[k] for k in sorted(s))]
    assert len(jslots) == len(tslots)
    for jl, tl in zip(jslots, tslots):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


def test_kernel_configs_and_registry():
    assert port_opt.build_optimizer("AdamW", {"lr": 1.0}).kernel_computes()
    assert not port_opt.build_optimizer("adam", {"amsgrad": True}).kernel_computes()
    assert port_opt.build_optimizer("adam", {"adam_w_mode": False}).kernel_computes()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_opt.build_optimizer("Lamb")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_opt.build_optimizer("OneBitAdam")
    with pytest.raises(ValueError):
        port_opt.build_optimizer("no-such-optimizer")
    with pytest.raises(TypeError):
        port_opt.build_optimizer("adam", {"momentum": 0.9})
    # a configuration the kernel does not compute raises off the CPU
    opt = port_opt.build_optimizer("adam", {"amsgrad": True})
    p = {"w": torch.empty(4, device="meta")}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.init(p)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.apply({"w": torch.empty(4, device="meta")},
                  port_opt.build_optimizer("adam").init(p), p)
