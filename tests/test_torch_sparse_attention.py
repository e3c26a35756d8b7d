"""Block-sparse attention of the PyTorch port against the JAX package.

The same numpy inputs go through ``deepspeed_tpu.ops.sparse_attention`` /
``deepspeed_tpu.ops.pallas.sparse_flash`` (the Pallas kernel in interpret
mode on the CPU, as tests/test_sparse_compressed.py runs it) and the port's
``ops/sparse_attention.py`` / ``ops/sparse_flash.py`` on CPU tensors, where
the kernel route runs its plain version (the same tile walk). Layouts of
all four configs and the compiled tables must be identical; the kernel
route's output agrees to 2e-5 in f32 (causal or not, GQA) and its q/k/v
gradients to 5e-4 of ``jax.grad``; the dense masked form and the route for
a sequence that is no multiple of the 128-row tile agree to 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import sparse_flash as jsf
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops import sparse_flash as tsf

S, BLOCK = 256, 16


def _configs(mod, attention):
    """The four config classes (Dense has no attention field), with
    non-default knobs where they exist."""
    return {
        "dense": mod.DenseSparsityConfig(num_heads=4, block=BLOCK),
        "fixed": mod.FixedSparsityConfig(num_heads=4, block=BLOCK, num_local_blocks=4,
                                         num_global_blocks=2, attention=attention),
        "bigbird": mod.BigBirdSparsityConfig(num_heads=4, block=BLOCK, num_random_blocks=2,
                                             attention=attention, seed=3),
        "bslongformer": mod.BSLongformerSparsityConfig(num_heads=4, block=BLOCK,
                                                       global_block_indices=(0, 7),
                                                       attention=attention),
    }


@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
def test_layouts_and_tables_identical(attention):
    jc, tc = _configs(jsa, attention), _configs(tsa, attention)
    for name in jc:
        for s in (S, 512):
            jl, tl = jc[name].make_layout(s), tc[name].make_layout(s)
            np.testing.assert_array_equal(tl, jl, err_msg=name)
            for causal in (False, True):
                for a, b in zip(tsf.compile_layout_tables(tl, BLOCK, causal),
                                jsf.compile_layout_tables(jl, BLOCK, causal)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {s} {causal}")


def test_mask_bits_round_trip():
    layout = tsa.BigBirdSparsityConfig(num_heads=1, block=BLOCK).make_layout(S)
    table, counts, masks = tsf.compile_layout_tables(layout, BLOCK, True)
    bits = tsf.pack_mask_bits(torch.from_numpy(masks))
    assert bits.dtype == torch.int32 and bits.shape == masks.shape[:3] + (4,)
    assert torch.equal(tsf.unpack_mask_bits(bits), torch.from_numpy(masks) > 0)
    token = np.repeat(np.repeat(layout, BLOCK, 0), BLOCK, 1) & np.tril(np.ones((S, S), bool))
    got = tsf.token_mask_from_tiles(torch.from_numpy(table), torch.from_numpy(counts), bits)
    np.testing.assert_array_equal(got.numpy(), token)


def _qkv(b, s, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = {  # name: (config, causal, kv heads)
    "fixed": ("fixed", False, 4),
    "fixed_causal": ("fixed", True, 4),
    "bigbird_gqa": ("bigbird", False, 2),
    "bslongformer_causal_gqa": ("bslongformer", True, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_route_matches_pallas(case):
    name, causal, kvh = CASES[case]
    layout = _configs(jsa, "bidirectional")[name].make_layout(S)
    q, k, v = _qkv(1, S, 4, kvh, 64)
    want = jsf.sparse_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout,
                                      layout_block=BLOCK, causal=causal)
    got = tsf.sparse_flash_attention(*_t(q, k, v), layout, layout_block=BLOCK, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["fixed_causal", "bigbird_gqa"])
def test_kernel_route_grads_match_jax(case):
    name, causal, kvh = CASES[case]
    layout = _configs(jsa, "bidirectional")[name].make_layout(S)
    q, k, v = _qkv(1, S, 4, kvh, 32, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jsf.sparse_flash_attention(q_, k_, v_, layout, layout_block=BLOCK,
                                                  causal=causal) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = tsf.sparse_flash_attention(qt, kt, vt, layout, layout_block=BLOCK, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref, nm in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{nm}")


@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
def test_dense_form_matches_jax(attention):
    q, k, v = _qkv(2, S, 4, 2, 32, seed=3)
    for name in ("fixed", "bslongformer"):
        want = jsa.SparseSelfAttention(_configs(jsa, attention)[name])(
            *map(jnp.asarray, (q, k, v)), use_kernel=False)
        port = tsa.SparseSelfAttention(_configs(tsa, attention)[name])
        got = port(*_t(q, k, v), use_kernel=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
        # the kernel route (plain tile walk on the CPU) computes the same function
        np.testing.assert_allclose(port(*_t(q, k, v), use_kernel=True).numpy(),
                                   np.asarray(want), atol=2e-5, rtol=2e-5)
    assert port(*_t(q, k, v)).shape == q.shape   # auto: the dense form on the CPU


def test_short_sequence_takes_the_dense_route():
    """S = 80 is no multiple of the 128-row tile: both packages take the
    dense masked form, with the layout's causal mask."""
    layout = tsa.BigBirdSparsityConfig(num_heads=2, block=BLOCK).make_layout(80)
    q, k, v = _qkv(1, 80, 2, 2, 32, seed=4)
    for causal in (False, True):
        want = jsf.sparse_flash_attention(*map(jnp.asarray, (q, k, v)), layout,
                                          layout_block=BLOCK, causal=causal)
        got = tsf.sparse_flash_attention(*_t(q, k, v), layout, layout_block=BLOCK,
                                         causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        tsa.SparseSelfAttention(tsa.DenseSparsityConfig(num_heads=2))(*_t(q[:, :70], k, v))


def test_precompiled_tables_route():
    """``tables=precompile_layout(...)`` gives the same output as a layout."""
    layout = tsa.FixedSparsityConfig(num_heads=4, block=BLOCK).make_layout(S)
    q, k, v = _t(*_qkv(1, S, 4, 4, 32, seed=5))
    tables = tsf.precompile_layout(layout, BLOCK, causal=True, device="cpu")
    assert [t.dtype for t in tables] == [torch.int32, torch.int32, torch.float32]
    for got, want in zip(tables, tsf.compile_layout_tables(layout, BLOCK, True)):
        np.testing.assert_array_equal(got.numpy(), want)
    a = tsf.sparse_flash_attention(q, k, v, tables=tables, layout_block=BLOCK)
    b = tsf.sparse_flash_attention(q, k, v, layout, layout_block=BLOCK, causal=True)
    assert torch.equal(a, b)
    # masks made elsewhere are packed on the call
    c = tsf.sparse_flash_attention(q, k, v, tables=(*tables[:2], tables[2].clone()),
                                   layout_block=BLOCK)
    assert torch.equal(c, b)


def test_kernel_refuses_other_devices():
    q = torch.zeros(1, S, 1, 64, device="meta")
    table, counts, bits = (torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, 1, 128, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsf.sparse_flash_fwd(q, q, q, table, counts, bits, 0.125)
