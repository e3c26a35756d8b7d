"""Plain paged attention of the PyTorch port against the JAX Pallas kernel.

The same inputs, made with numpy from a seed, go through
``deepspeed_tpu.ops.pallas.paged_attention.paged_ragged_attention`` (in
interpret mode on the CPU, as tests/test_paged_attention.py runs it) and
``deepspeed_tpu_torch.ops.paged_attention.paged_ragged_attention`` on CPU
tensors (its plain version). f32 throughout; tolerance 2e-5 (one f32
summation order against another).

Rows with no visible key (pad rows, position -1) are held to the port's
contract, output 0. The Pallas kernel does not give 0 there: its online
softmax starts from m = -1e30, so a row whose every score is masked to
-1e30 takes exp(0) = 1 per masked key and outputs the mean of the V rows of
every page group it visited, which depends on its ``pages_per_step``
tiling. Callers discard those rows; the port pins them to 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_ragged_attention as jax_paged
from deepspeed_tpu_torch.ops.paged_attention import paged_ragged_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 2e-5
B, D, BS, NB, MB, L = 3, 16, 8, 16, 4, 2
# decode: a live row, a frozen (pad) row, a live row at a page boundary;
# prefill: a chunk after a cached prefix, an all-pad row, a chunk from 0
# that ends in pad rows
POSITIONS = {
    "decode": [[13], [-1], [24]],
    "prefill": [[10, 11, 12, 13, 14], [-1] * 5, [0, 1, 2, -1, -1]],
}


def _inputs(mode, h, kvh, seed):
    rng = np.random.default_rng(seed)
    pos = np.asarray(POSITIONS[mode], np.int32)
    c = pos.shape[1]
    return dict(
        q=rng.standard_normal((B, c, h, D)).astype(np.float32),
        kpool=rng.standard_normal((L, kvh, NB, BS, D)).astype(np.float32),
        vpool=rng.standard_normal((L, kvh, NB, BS, D)).astype(np.float32),
        block_tables=rng.permutation(np.arange(1, NB))[:B * MB]
        .reshape(B, MB).astype(np.int32),
        positions=pos,
        chunk_k=rng.standard_normal((B, c, kvh, D)).astype(np.float32),
        chunk_v=rng.standard_normal((B, c, kvh, D)).astype(np.float32))


def _both(x, kw, chunk=True):
    names = ["q", "kpool", "vpool", "block_tables", "positions"]
    extra = ["chunk_k", "chunk_v"] if chunk else []
    j = jax_paged(*[jnp.asarray(x[n]) for n in names],
                  *([jnp.asarray(x[n]) for n in extra] or [None, None]),
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in kw.items()})
    t = paged_ragged_attention(*[torch.from_numpy(x[n]) for n in names],
                               *([torch.from_numpy(x[n]) for n in extra] or [None, None]),
                               **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                  for k, v in kw.items()})
    return np.asarray(j), t.numpy()


def _check(x, jax_out, port_out):
    valid = x["positions"] >= 0
    np.testing.assert_allclose(port_out[valid], jax_out[valid], rtol=TOL, atol=TOL)
    assert (port_out[~valid] == 0).all(), "fully masked rows must output 0"


HEADS = {"mha": (4, 4), "gqa": (8, 2), "mqa": (4, 1)}
FEATURES = {"plain": {}, "window": {"window": 6}, "alibi": {"alibi": True},
            "softcap": {"softcap": 2.0}}


# every head layout without options, and every option on the GQA layout
# (the one whose row order r = c*G + g the options must follow)
CASES = ([(heads, "plain") for heads in sorted(HEADS)]
         + [("gqa", f) for f in sorted(FEATURES) if f != "plain"])


@pytest.mark.parametrize("heads,feature", CASES)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_plain_matches_pallas(mode, heads, feature):
    h, kvh = HEADS[heads]
    x = _inputs(mode, h, kvh, seed=len(mode) * 7 + h + kvh)
    kw = {"layer": 1, "window": FEATURES[feature].get("window", 0),
          "softcap": FEATURES[feature].get("softcap", 0.0)}
    if FEATURES[feature].get("alibi"):
        kw["alibi_slopes"] = np.linspace(0.5, 0.05, h).astype(np.float32)
    jax_out, port_out = _both(x, kw)
    _check(x, jax_out, port_out)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_plain_matches_pallas_without_chunk(heads):
    """``chunk_k=None``: the pool already holds every slot up to each
    query's position (the decode contract of the v1 fused path)."""
    h, kvh = HEADS[heads]
    x = _inputs("decode", h, kvh, seed=3)
    jax_out, port_out = _both(x, {"layer": 0}, chunk=False)
    _check(x, jax_out, port_out)


def test_single_layer_pool():
    """A 4-D (KVH, NB, bs, D) pool with ``layer=None`` reads that pool."""
    x = _inputs("prefill", 8, 2, seed=4)
    x4 = dict(x, kpool=x["kpool"][1], vpool=x["vpool"][1])
    jax_out, port_out = _both(x4, {})
    _check(x4, jax_out, port_out)
    _, port_5d = _both(x, {"layer": 1})
    np.testing.assert_array_equal(port_out, port_5d)


def test_cpu_tensors_do_not_count_launches():
    """On CPU tensors the wrapper runs the plain version: no kernel is
    launched, so the launch counter stays as it was."""
    x = _inputs("decode", 4, 2, seed=5)
    before = paged_ragged_attention.launches
    out = paged_ragged_attention(
        *[torch.from_numpy(x[n]) for n in ("q", "kpool", "vpool",
                                           "block_tables", "positions",
                                           "chunk_k", "chunk_v")], layer=0)
    assert out.shape == x["q"].shape
    assert paged_ragged_attention.launches == before


# ----------------------------------------------------- the kernel's host plan

def _visible(pos_b, r, g, window, pool_end):
    """Pool slots row r sees: [pos - window + 1, min(pos, pool_end - 1)]."""
    p = pos_b[r // g]
    lo = max(p - window + 1, 0) if window > 0 else 0
    return set(range(lo, min(p, pool_end - 1) + 1)) if p >= 0 else set()


def _pool_end(pos_b, mb, bs, has_chunk):
    live = [p for p in pos_b if p >= 0]
    if has_chunk:
        return min(mb * bs, min(live)) if live else 0
    return min(mb * bs, max(live) + 1) if live else 0


# (positions, window, bs, mb, kvh, g, has_chunk): decode at ragged contexts,
# a window, bs 16 and 128, falcon-7b's 71 query rows over one kv head, a
# chunk of 3 tokens with G 4 (one row group spans positions), no chunk
PLAN_CASES = {
    "decode_bs128": ([[99], [1999], [-1], [732], [0]], 0, 128, 16, 8, 4, True),
    "decode_bs16_window": ([[500], [37], [-1], [1200]], 256, 16, 80, 2, 4, True),
    "falcon_g71": ([[300], [-1], [64]], 0, 16, 24, 1, 71, True),
    "chunk_g4": ([[40, 41, 42], [-1, -1, -1], [0, 1, -1]], 24, 16, 4, 2, 4, True),
    "no_chunk": ([[130, 131], [5, -1]], 0, 32, 8, 2, 2, False),
}


@pytest.mark.parametrize("sms", [1, 7, 132, 264])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_covers_every_live_slot_once(name, sms):
    """Every (slot, kv head, row group) some live row sees lies in exactly
    one item; the chunk's keys its rows see are folded by exactly one; a
    row group with only pad rows gets one item with no keys; the items fit
    the launch's grid and scratch."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    positions, window, bs, mb, kvh, g, has_chunk = PLAN_CASES[name]
    items = pa.plan(positions, window, bs, mb, kvh, g, sms, has_chunk)
    rows = len(positions[0]) * g
    rgs = -(-rows // pa.ROWS)
    assert len(items) <= pa.grid_size(len(positions), rgs, kvh, sms)
    for b, pos_b in enumerate(positions):
        end = _pool_end(pos_b, mb, bs, has_chunk)
        for rg in range(rgs):
            rr = range(rg * pa.ROWS, min(rg * pa.ROWS + pa.ROWS, rows))
            seen = set().union(*(_visible(pos_b, r, g, window, end) for r in rr))
            keys = {pos_b[r // g] for r in rr if pos_b[r // g] >= 0}
            for kh in range(kvh):
                mine = [it for it in items if it[:3] == (b, rg, kh)]
                assert [it[3] for it in mine] == list(range(len(mine)))
                assert all(it[4] == len(mine) for it in mine)
                assert len(mine) <= pa.max_chunks(mb, bs, kvh, sms)
                covered = [s for it in mine for s in range(it[5], it[6])]
                assert len(covered) == len(set(covered)), "a slot in two chunks"
                assert seen <= set(covered) and all(s < end for s in covered)
                folds = [it for it in mine if it[8] > it[7]]
                if not keys:
                    assert [(it[5], it[6], it[7], it[8]) for it in mine] == [(0, 0, 0, 0)]
                    continue
                if has_chunk:
                    assert len(folds) == 1 and folds[0][3] == len(mine) - 1
                    chunk = {pos_b[c] for c in range(folds[0][7], folds[0][8])}
                    assert keys <= chunk
                else:
                    assert not folds


@pytest.mark.parametrize("name", ["decode_bs16_window", "chunk_g4"])
def test_plan_chunks_merged_in_order_match_the_pallas_kernel(name):
    """The split route's arithmetic on the CPU: each planned item's
    unnormalised (m, l, acc) over its pool slots and (last chunk) the
    chunk's keys, merged per (sequence, row group, kv head) in chunk order
    and divided by l, against the JAX kernel in interpret mode."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    positions, window, bs, mb, kvh, g, _ = PLAN_CASES[name]
    rng = np.random.default_rng(11)
    b, c, d = len(positions), len(positions[0]), D
    h, nb = kvh * g, len(positions) * mb + 1
    x = dict(q=rng.standard_normal((b, c, h, d)).astype(np.float32),
             kpool=rng.standard_normal((1, kvh, nb, bs, d)).astype(np.float32),
             vpool=rng.standard_normal((1, kvh, nb, bs, d)).astype(np.float32),
             block_tables=rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
             .astype(np.int32),
             positions=np.asarray(positions, np.int32),
             chunk_k=rng.standard_normal((b, c, kvh, d)).astype(np.float32),
             chunk_v=rng.standard_normal((b, c, kvh, d)).astype(np.float32))
    want, _ = _both(x, {"layer": 0, "window": window})
    qg = torch.from_numpy(x["q"]).reshape(b, c, kvh, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, kvh, c * g, d)
    kp, vp = torch.from_numpy(x["kpool"][0]), torch.from_numpy(x["vpool"][0])
    ck, cv = torch.from_numpy(x["chunk_k"]), torch.from_numpy(x["chunk_v"])
    parts = {}
    for bi, rg, kh, j, _, s0, s1, c0, c1 in pa.plan(positions, window, bs, mb, kvh, g, 3):
        rows = torch.arange(rg * pa.ROWS, min(rg * pa.ROWS + pa.ROWS, c * g))
        prow = torch.tensor([positions[bi][r // g] for r in rows.tolist()])[:, None]
        slots = torch.arange(s0, s1)
        pages = torch.from_numpy(x["block_tables"][bi]).long()[slots // bs]
        keys = torch.cat([kp[kh, pages, slots % bs], ck[bi, c0:c1, kh]])
        vals = torch.cat([vp[kh, pages, slots % bs], cv[bi, c0:c1, kh]])
        kpos = torch.cat([slots, torch.tensor(positions[bi][c0:c1], dtype=torch.long)])[None]
        if kpos.numel() == 0:   # a row group of pad rows: the kernel writes its zeros
            continue
        vis = (kpos >= 0) & (kpos <= prow)
        if window > 0:
            vis &= kpos > prow - window
        sc = (qg[bi, kh, rows] @ keys.T * d ** -0.5).masked_fill(~vis, -torch.inf)
        m = sc.amax(dim=1, keepdim=True)
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m))
        parts.setdefault((bi, rg, kh), []).append((j, m, p.sum(dim=1, keepdim=True), p @ vals))
    got = torch.zeros(b, kvh, c * g, d)
    for (bi, rg, kh), chunks in parts.items():
        chunks.sort(key=lambda t: t[0])
        mm = torch.stack([m for _, m, _, _ in chunks]).amax(dim=0)
        mm = torch.where(torch.isinf(mm), 0.0, mm)
        l = sum(li * torch.exp(m - mm) for _, m, li, _ in chunks)
        acc = sum(a * torch.exp(m - mm) for _, m, _, a in chunks)
        sl = slice(rg * pa.ROWS, min(rg * pa.ROWS + pa.ROWS, c * g))
        got[bi, kh, sl] = acc / torch.where(l == 0, 1.0, l)
    got = got.reshape(b, kvh, c, g, d).permute(0, 2, 1, 3, 4).reshape(b, c, h, d).numpy()
    _check(x, want, got)


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_plain_matches_pallas_at_the_split_only_head_dims(mode, d):
    """phi-2's D 80 and gpt-neox-20b's D 96, which only the split route
    runs on the card: the plain version against the Pallas kernel."""
    h, kvh = HEADS["gqa"]
    x = _inputs(mode, h, kvh, seed=d + len(mode))
    rng = np.random.default_rng(d)
    for name in ("q", "kpool", "vpool", "chunk_k", "chunk_v"):
        shape = x[name].shape[:-1] + (d,)
        x[name] = rng.standard_normal(shape).astype(np.float32)
    jax_out, port_out = _both(x, {"layer": 1, "window": 6})
    _check(x, jax_out, port_out)


def test_route_takes_every_serving_preset():
    """Every published preset the paged runner serves has a head dim the kernel is
    built for, and the route chooser gives it a hand-written route at
    decode and at a 128-token chunk: the split route at D 80 and 96 (no
    wgmma tile), the wgmma route only at D 64, 128 and 256."""
    from deepspeed_tpu_torch.models.config import PRESETS
    from deepspeed_tpu_torch.ops import paged_attention as pa
    served = {name: cfg for name, cfg in PRESETS.items()   # the tiny test configs run on the CPU
              if cfg.causal and not cfg.post_norm and not name.startswith("tiny")}
    assert {"phi-2", "gpt-neox-20b", "falcon-7b", "llama3-8b"} <= set(served)
    for name, cfg in served.items():
        d, g = cfg.dims_per_head, cfg.num_heads // cfg.kv_heads
        assert d in pa.KERNEL_HEAD_DIMS, name
        for c in (1, 128):
            way = pa.route(c, g, d, 128)
            assert way in ("split", "wgmma"), name
            assert way == "split" or d in pa.WGMMA_HEAD_DIMS, name
    assert pa.route(128, 1, 80, 16) == pa.route(128, 1, 96, 128) == "split"
    assert pa.route(1, 4, 128, 128) == "split" and pa.route(128, 4, 128, 128) == "wgmma"
