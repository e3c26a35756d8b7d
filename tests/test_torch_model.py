"""Model layer of the PyTorch port against the JAX package.

Configs must match field for field (the port keeps its own copy), the layer
functions must compute what the JAX ones do on the same numpy inputs (f32,
atol 1e-5: one f32 evaluation order against another), and the weights
bridge must carry every leaf of a JAX params tree over unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.models import config as jax_config
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.models import config as port_config
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.module_inject import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ATOL = 1e-5


def _np(t):
    return np.asarray(t)


def _cfgs(name, **kw):
    """The same preset in both packages (each layer function reads its
    own package's config)."""
    return jax_config.get_config(name, **kw), port_config.get_config(name, **kw)


def test_config_fields_and_presets_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.TransformerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(port_config.TransformerConfig)]
    assert jf == tf
    assert sorted(jax_config.PRESETS) == sorted(port_config.PRESETS)
    for name, jcfg in jax_config.PRESETS.items():
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(port_config.PRESETS[name]), name
    cfg = port_config.get_config("llama3-8b", dtype="float32")
    assert cfg.act_dtype == torch.float32 and cfg.p_dtype == torch.float32
    assert port_config.get_config("llama3-8b").act_dtype == torch.bfloat16
    with pytest.raises(KeyError):
        port_config.get_config("no-such-model")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jcfg, cfg = _cfgs("tiny", norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.hidden_size).astype(np.float32),
         "bias": rng.standard_normal(cfg.hidden_size).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rotary_pct,interleaved", [(1.0, False), (1.0, True),
                                                    (0.25, False), (0.25, True)])
def test_apply_rope(rotary_pct, interleaved):
    jcfg, cfg = _cfgs("tiny", head_dim=32, rotary_pct=rotary_pct, rope_theta=5e5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 5)).astype(np.int32)
    jf = JL.rope_frequencies(jcfg)
    tf = TL.rope_frequencies(cfg)
    np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf, interleaved=interleaved)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf,
                        interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("heads", [8, 12, 32, 71])
def test_alibi_slopes(heads):
    np.testing.assert_allclose(TL.alibi_slopes(heads).numpy(),
                               _np(JL.alibi_slopes(heads)), rtol=1e-7)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "gelu_exact", "relu"])
def test_apply_mlp(activation):
    jcfg, cfg = _cfgs("tiny", activation=activation, use_bias=True)
    jparams, _ = JL.init_mlp(jax.random.PRNGKey(3), jcfg)
    jparams = jax.tree.map(lambda a: a + 0.01, jparams)    # non-zero biases
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    want = JL.apply_mlp(jparams, jnp.asarray(x), jcfg)
    got = TL.apply_mlp({k: torch.from_numpy(np.array(v)) for k, v in jparams.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
def test_weights_bridge_round_trips_every_leaf(name):
    jparams = jax.tree.map(np.asarray, jax_build_model(name).init(jax.random.PRNGKey(0)))
    model = build_model(name)
    port = params_from_numpy(model.cfg, jparams, device="cpu")
    want = dict(_leaves(jparams))
    got = dict(_leaves(port))
    assert sorted(want) == sorted(got)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)
    # the port's own init lays out the same tree, leaf for leaf
    own = dict(_leaves(model.init(torch.Generator().manual_seed(0), device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    bad = dict(jparams, embed=dict(jparams["embed"], tok=np.ones((3, 3), np.float32)))
    with pytest.raises(ValueError, match="embed.tok"):
        params_from_numpy(model.cfg, bad, device="cpu")


def test_init_distributions():
    """normal(0.02) projections, output projections scaled by 1/sqrt(2L),
    the untied LM head by E^-0.5, unit norm scales."""
    model = build_model("tiny", hidden_size=256, num_heads=4, intermediate_size=512,
                        vocab_size=512)
    cfg = model.cfg
    p = model.init(torch.Generator().manual_seed(1), device="cpu")
    std = lambda t: float(t.float().std())   # noqa: E731
    assert abs(std(p["layers"]["attn"]["wq"]) / 0.02 - 1) < 0.05
    assert abs(std(p["layers"]["mlp"]["wo"]) / (0.02 / (2 * cfg.num_layers) ** 0.5) - 1) < 0.05
    assert abs(std(p["embed"]["lm_head"]) / cfg.hidden_size ** -0.5 - 1) < 0.05
    assert (p["final_norm"]["scale"] == 1).all()
    assert p["layers"]["attn"]["wq"].shape == (cfg.num_layers, 256, 4, 64)
    meta = model.abstract_params(dtype=torch.bfloat16)
    assert meta["layers"]["mlp"]["wi_gate"].device.type == "meta"
    assert meta["layers"]["mlp"]["wi_gate"].dtype == torch.bfloat16
