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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


# ---------------------------------------------------------------- key blocks
# The kernel's input form (``compile_key_blocks``): for each 128-row query
# tile, the 16-key blocks any of its rows sees, 8 to a stage, with each
# stage's mask over its 128 gathered columns.

def _tables(layout, block, causal):
    table, counts, masks = tsf.compile_layout_tables(layout, block, causal)
    return (torch.from_numpy(table), torch.from_numpy(counts),
            tsf.pack_mask_bits(torch.from_numpy(masks)))


def _random_layout_with_empty_rows():
    """The random layout of chip_smoke.py's ``random_empty_rows_d128`` case:
    whole query tiles and single block rows that see no key."""
    layout = np.random.default_rng(0).random((64, 64)) < 0.2
    layout[:8] = False
    layout[20] = False
    return layout


def _layouts():
    s = 1024
    cases = {}
    for name, cfg in (("fixed", tsa.FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=4,
                                                         num_global_blocks=1)),
                      ("bslongformer", tsa.BSLongformerSparsityConfig(num_heads=4, block=16)),
                      ("bigbird", tsa.BigBirdSparsityConfig(num_heads=4, block=16))):
        for causal in (False, True):
            cases[f"{name}_{'causal' if causal else 'bidirectional'}"] = (
                cfg.make_layout(s), 16, causal)
    for blk in (32, 64):
        cfg = tsa.FixedSparsityConfig(num_heads=4, block=blk, num_local_blocks=4,
                                      num_global_blocks=1)
        cases[f"fixed_block{blk}"] = (cfg.make_layout(s), blk, False)
    cases["random_empty_rows"] = (_random_layout_with_empty_rows(), 16, False)
    return cases


LAYOUTS = _layouts()


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_key_blocks_describe_the_token_mask(case):
    """Bit for bit the mask ``token_mask_from_tiles`` gives; every listed
    block holds a set bit, blocks ascend, padding slots are empty and come
    last; ``full`` marks the stages with every bit set; the query tiles go
    most stages first."""
    layout, block, causal = LAYOUTS[case]
    table, counts, bits = _tables(layout, block, causal)
    kb = tsf.compile_key_blocks(table, counts, bits)
    s = table.shape[0] * tsf.TILE_Q
    want = tsf.token_mask_from_tiles(table, counts, bits)
    ns = int(kb.stage_start[-1])
    assert kb.blocks.shape == (ns, tsf.STAGE_SLOTS) and kb.bits.shape == (ns, tsf.TILE_Q, 4)
    assert all(t.dtype == torch.int32 for t in kb)
    on = tsf.unpack_mask_bits(kb.bits[:, None]).reshape(ns, tsf.TILE_Q, tsf.TILE_K)
    got = torch.zeros(s, s, dtype=torch.bool)
    for t in range(table.shape[0]):
        rows = slice(t * tsf.TILE_Q, (t + 1) * tsf.TILE_Q)
        lo, hi = int(kb.stage_start[t]), int(kb.stage_start[t + 1])
        listed = kb.blocks[lo:hi].reshape(-1)
        live = listed[listed >= 0]
        assert bool((listed[:len(live)] >= 0).all()), "padding before a live slot"
        assert len(listed) - len(live) < tsf.STAGE_SLOTS
        assert bool((live[1:] > live[:-1]).all()), "blocks not strictly ascending"
        for st in range(lo, hi):
            for slot, blk in enumerate(kb.blocks[st].tolist()):
                cols = on[st, :, slot * tsf.KEY_BLOCK:(slot + 1) * tsf.KEY_BLOCK]
                if blk < 0:
                    assert not bool(cols.any()), "a padding slot has a mask bit"
                    continue
                assert bool(cols.any()), f"block {blk} listed with no bit set"
                got[rows, blk * tsf.KEY_BLOCK:(blk + 1) * tsf.KEY_BLOCK] = cols
        # every block of the tile that the mask reaches is listed
        seen = want[rows].reshape(tsf.TILE_Q, -1, tsf.KEY_BLOCK).any(dim=(0, 2))
        assert torch.equal(torch.nonzero(seen).reshape(-1), live.long())
    assert torch.equal(got, want)
    assert torch.equal(kb.full.bool(), on.reshape(ns, -1).all(dim=1))
    n_stages = kb.stage_start[1:] - kb.stage_start[:-1]
    assert sorted(kb.order.tolist()) == list(range(table.shape[0]))
    assert bool((n_stages[kb.order.long()].diff() <= 0).all())


def test_key_block_stage_counts_at_the_main_shape():
    """At bert-large's S = 4096, block 16: 70 blocks every item of Fixed (9
    stages of 8), 288 / 94 / 124 stages a (batch, head) in all."""
    s = 4096
    cfgs = {"fixed": tsa.FixedSparsityConfig(num_heads=16, block=16, num_local_blocks=4,
                                             num_global_blocks=1),
            "bslongformer": tsa.BSLongformerSparsityConfig(num_heads=16, block=16),
            "bigbird": tsa.BigBirdSparsityConfig(num_heads=16, block=16)}
    stages = {}
    for name, cfg in cfgs.items():
        kb = tsf.compile_key_blocks(*_tables(cfg.make_layout(s), 16, False))
        stages[name] = int(kb.stage_start[-1])
        if name == "fixed":
            assert ((kb.blocks >= 0).sum(dim=1).reshape(-1, 9).sum(dim=1) == 70).all()
    assert stages == {"fixed": 288, "bslongformer": 94, "bigbird": 124}


def _key_block_walk(q, k, v, kb, scale):
    """The kernel's walk in torch: each query tile over its stages of
    gathered 16-key blocks (padding slots masked), scale after the dot in
    f32, masked keys p = 0, m from -inf, p rounded to v's dtype before P.V,
    out = acc / l (0 where l = 0)."""
    b, s, h, d = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    on = tsf.unpack_mask_bits(kb.bits[:, None])[:, 0]               # (NS, TQ, 128)
    out = torch.zeros_like(qf)
    for t in range(s // tsf.TILE_Q):
        rows = slice(t * tsf.TILE_Q, (t + 1) * tsf.TILE_Q)
        m = torch.full((b, h, tsf.TILE_Q, 1), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, tsf.TILE_Q, d)
        for st in range(int(kb.stage_start[t]), int(kb.stage_start[t + 1])):
            blk = kb.blocks[st].long()
            cols = (blk.clamp(min=0)[:, None] * tsf.KEY_BLOCK
                    + torch.arange(tsf.KEY_BLOCK)).reshape(-1)
            sc = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            sc = sc.masked_fill(~on[st], float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
            p = torch.where(on[st], torch.exp(sc - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("case", ["fixed_causal", "bigbird_bidirectional", "fixed_block64",
                                  "random_empty_rows"])
def test_key_block_walk_equals_the_tile_walk(case):
    """The kernel's input contract on the CPU: its walk over the key-block
    form computes what ``sparse_flash_plain`` (the TPU kernel's tile walk)
    computes, to f32 rounding; rows that see no key output 0 in both."""
    layout, block, causal = LAYOUTS[case]
    table, counts, bits = _tables(layout, block, causal)
    q, k, v = _t(*_qkv(1, 1024, 2, 2, 32, seed=6))
    kb = tsf.compile_key_blocks(table, counts, bits)
    got = _key_block_walk(q, k, v, kb, 32 ** -0.5)
    want = tsf.sparse_flash_plain(q, k, v, table, counts, bits, 32 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=2e-5)


def test_key_blocks_compiled_once_per_tables():
    layout, block, causal = LAYOUTS["bigbird_causal"]
    table, counts, bits = _tables(layout, block, causal)
    first = tsf.key_blocks_of(table, counts, bits)
    assert tsf.key_blocks_of(table, counts, bits) is first
    assert tsf.key_blocks_of(table, counts, bits.clone()) is not first


def test_deal_gives_every_item_once_and_balances_a_long_tile():
    """The kernel's deal of its items to 132 blocks (one an H100 SM) at the
    BSLongformer main shape (B 4, 16 heads, S 4096): every item once, each
    block's items longest first; the block with the most stages holds 50
    (the mean is 45.6), where dealing rounds as a serpentine would leave a
    block with a 32-stage item 60."""
    layout = tsa.BSLongformerSparsityConfig(num_heads=16, block=16).make_layout(4096)
    kb = tsf.compile_key_blocks(*_tables(layout, 16, False))
    b, h, blocks = 4, 16, 132
    start, items = tsf.deal_items(kb.stage_start, kb.order, b, h, blocks)
    n_items = kb.order.numel() * b * h
    assert start.dtype == items.dtype == torch.int32 and start.shape == (blocks + 1,)
    assert sorted(items.tolist()) == list(range(n_items))
    n_stages = (kb.stage_start[1:] - kb.stage_start[:-1]).long()
    stages = n_stages[kb.order.long()[items.long() // (b * h)]]
    loads = [int(stages[start[x]:start[x + 1]].sum()) for x in range(blocks)]
    for x in range(blocks):
        run = stages[start[x]:start[x + 1]]
        assert bool((run[1:] <= run[:-1]).all())
    serpentine = [0] * blocks
    for i in range(n_items):
        k, x = divmod(i, blocks)
        serpentine[x if k % 2 == 0 else blocks - 1 - x] += int(n_stages[kb.order[i // (b * h)]])
    assert max(loads) == 50 and max(serpentine) == 60
    assert sum(loads) == sum(serpentine) == 94 * b * h
