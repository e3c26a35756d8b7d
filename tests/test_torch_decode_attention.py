"""Decode attention of the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX functions
and the port's on CPU tensors, f32 throughout:

- the port's plain fused decode attention (the CPU side of
  ``ops/decode_attention.py``) against the JAX Pallas kernel
  ``fused_decode_attention`` in interpret mode (block 128 over a 256-slot
  cache) and against the JAX ``decode_attention`` einsum branch;
- the port's ``decode_attention`` (its masked einsum on the CPU) against
  the JAX ``decode_attention`` on decode, prefill chunks, windows, ALiBi
  bias and softcap;
- the dispatch rule: which calls reach the fused kernel on the card.

Tolerance 2e-5: one f32 summation order against another. A sequence with
``cache_len == 0`` outputs 0 from the fused kernel (``l_safe``) but the
mean of the V rows from the einsum branch (a uniform softmax over masked
scores), in JAX as in the port; the kernel-against-einsum comparison holds
such rows to 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.attention import decode_attention as jax_decode_attention
from deepspeed_tpu.ops.pallas.decode_attention import \
    fused_decode_attention as jax_fused
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.ops.attention import decode_attention
from deepspeed_tpu_torch.ops.decode_attention import fused_decode_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 2e-5
B, S_MAX, H, KVH, D = 3, 256, 8, 2, 64
LENS = {"short": [0, 127, 256], "edges": [1, 128, 200]}


def _inputs(lens, seed, s_new=1, s_max=S_MAX, h=H, kvh=KVH, d=D):
    rng = np.random.default_rng(seed)
    b = len(lens)
    return dict(q=rng.standard_normal((b, s_new, h, d)).astype(np.float32),
                k=rng.standard_normal((b, s_max, kvh, d)).astype(np.float32),
                v=rng.standard_normal((b, s_max, kvh, d)).astype(np.float32),
                lens=np.asarray(lens, np.int32))


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("lens", list(LENS.values()), ids=list(LENS))
@pytest.mark.parametrize("scale", [None, 0.3])
def test_plain_matches_pallas_kernel(lens, scale):
    x = _inputs(lens, seed=0)
    want = np.asarray(jax_fused(jnp.asarray(x["q"][:, 0]), jnp.asarray(x["k"]),
                                jnp.asarray(x["v"]), jnp.asarray(x["lens"]),
                                scale=scale, block=128))
    t = _t(x)
    got = fused_decode_attention(t["q"][:, 0], t["k"], t["v"], t["lens"], scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    empty = x["lens"] == 0
    assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("lens", list(LENS.values()), ids=list(LENS))
def test_plain_matches_jax_einsum_branch(lens):
    x = _inputs(lens, seed=1)
    want = np.asarray(jax_decode_attention(*[jnp.asarray(x[n]) for n in ("q", "k", "v", "lens")]))
    t = _t(x)
    got = fused_decode_attention(t["q"][:, 0], t["k"], t["v"], t["lens"]).numpy()
    live = x["lens"] > 0
    np.testing.assert_allclose(got[live], want[live, 0], atol=TOL, rtol=TOL)
    assert (got[~live] == 0).all()


CASES = {
    "decode": dict(lens=[0, 1, 200], s_new=1),
    "prefill_chunk": dict(lens=[5, 64, 256], s_new=5),
    "window": dict(lens=[3, 100, 256], s_new=3, window=16),
    "window_zero_global": dict(lens=[7, 9, 40], s_new=2, window=0),
    "alibi_bias": dict(lens=[4, 90, 130], s_new=4, bias=True),
    "softcap": dict(lens=[1, 33, 256], s_new=1, softcap=5.0),
    "mqa_scale": dict(lens=[2, 256, 17], s_new=2, kvh=1, scale=0.1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_attention_matches_jax(name):
    kw = dict(CASES[name])
    lens, s_new = kw.pop("lens"), kw.pop("s_new")
    kvh = kw.pop("kvh", KVH)
    x = _inputs(lens, seed=2, s_new=s_new, kvh=kvh)
    bias = None
    if kw.pop("bias", False):
        bias = np.random.default_rng(3).standard_normal(
            (len(lens), H, s_new, S_MAX)).astype(np.float32)
    jkw = dict(kw, bias=None if bias is None else jnp.asarray(bias))
    tkw = dict(kw, bias=None if bias is None else torch.from_numpy(bias))
    want = np.asarray(jax_decode_attention(*[jnp.asarray(x[n]) for n in ("q", "k", "v", "lens")],
                                           **jkw))
    got = decode_attention(*_t(x).values(), **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_einsum_chunks_match_one_pass(monkeypatch):
    x = _t(_inputs([9, 40, 256], seed=4, s_new=9))
    whole = decode_attention(*x.values(), window=20)
    # 4 bytes x B x H x S_max per query row: two rows a chunk
    monkeypatch.setattr(port_attention, "DECODE_LOGITS_BYTES", 2 * 4 * 3 * H * S_MAX)
    chunked = decode_attention(*x.values(), window=20)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)


ROUTES = {
    "eligible": (dict(), True),
    "short_cache": (dict(s_max=4096), False),
    "prefill": (dict(s_new=2), False),
    "window": (dict(window=64), False),
    "window_past_cache": (dict(window=1 << 20), True),
    "softcap": (dict(softcap=30.0), False),
    "head_dim_32": (dict(d=32), False),
    "bias": (dict(bias=True), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_dispatch_routes_long_decode_to_the_kernel(name, monkeypatch):
    """With the device rule patched to "on the card", exactly the JAX
    eligibility rule sends a call to the fused kernel's wrapper."""
    kw, routed = ROUTES[name]
    kw = dict(kw)
    shape = dict(s_max=kw.pop("s_max", 8192), s_new=kw.pop("s_new", 1), d=kw.pop("d", 64))
    x = _t(_inputs([5], seed=5, h=2, kvh=1, **shape))
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros((1, 2, shape["s_new"], shape["s_max"]))
    calls = []

    def record(q, k, v, lens, scale=None):
        calls.append(q.shape)
        return torch.zeros_like(q)

    monkeypatch.setattr(port_attention, "_on_card", lambda t: True)
    monkeypatch.setattr(port_attention, "fused_decode_attention", record)
    decode_attention(*x.values(), **kw)
    assert bool(calls) == routed


def test_kernel_wrapper_runs_the_plain_path_only_on_the_cpu():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on a
    device with no kernel (meta) is refused, not run through the plain
    version."""
    q = torch.empty((1, 2, 64), device="meta")
    kv = torch.empty((1, 8192, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_decode_attention(q, kv, kv, torch.empty((1,), dtype=torch.int32, device="meta"))


# ---- the kernel's split plan (ops/decode_attention.py plan, evaluated on the
# card by find_item in csrc/decode_attention.cu)

PLAN_LENS = {"full4": [8192] * 4, "mixed": [8192, 8065, 4097, 1, 0], "one": [8192],
             "ragged": [63, 64, 65, 0, 129, 7000], "empty": [0, 0], "b16": [8192] * 16}


@pytest.mark.parametrize("sms", [1, 7, 132, 264])
@pytest.mark.parametrize("kvh,groups", [(8, 1), (1, 2), (2, 1)])
@pytest.mark.parametrize("name", list(PLAN_LENS))
def test_plan_covers_every_live_slot_once(name, kvh, groups, sms):
    """Every live slot of every sequence lies in exactly one chunk of each
    (kv head, row group); no chunk reaches past cache_len; chunks start on
    64-slot tiles and are cut evenly; a sequence with no live slot gets one
    empty chunk (its zeros); the items fit the launched grid and the
    workspace's chunks."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    lens = PLAN_LENS[name]
    items = da.plan(lens, kvh, groups, sms)
    assert len(items) <= da.grid_size(len(lens), kvh, groups, sms)
    maxc = da.max_chunks(max(lens + [1]), kvh, groups, sms)
    for b, n in enumerate(lens):
        mine = [it for it in items if it[0] == b]
        chunks = {it[4] for it in mine}
        assert len(chunks) == 1 and chunks.pop() <= maxc
        for kh in range(kvh):
            for rg in range(groups):
                spans = sorted((it[3], it[5], it[6]) for it in mine if it[1:3] == (kh, rg))
                assert [c for c, _, _ in spans] == list(range(len(spans)))
                if n == 0:
                    assert [(s, e) for _, s, e in spans] == [(0, 0)]
                    continue
                covered = [slot for _, s, e in spans for slot in range(s, e)]
                assert covered == list(range(n))
                assert all(s % da.TILE == 0 and s < e <= n for _, s, e in spans)
                sizes = [-(-(e - s) // da.TILE) for _, s, e in spans]
                assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("name", ["full4", "one", "b16"])
def test_plan_sizes_itself_to_the_sm_count(name):
    """No chunk holds more than an SM's even share of the tiles (rounded up
    to whole tiles), so more SMs give more, shorter chunks (down to one
    chunk a sequence when the SMs are few)."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    lens = PLAN_LENS[name]
    tiles = sum(-(-n // da.TILE) for n in lens) * 8
    longest = {}
    for sms in (33, 66, 132, 264):
        items = da.plan(lens, 8, 1, sms)
        longest[sms] = max(-(-(e - s) // da.TILE) for *_, s, e in items)
        assert longest[sms] <= -(-tiles // sms)
    assert longest[264] <= longest[132] <= longest[66] <= longest[33]
    assert longest[264] < longest[33]


@pytest.mark.parametrize("lens", list(LENS.values()) + [[5, 0, 256]], ids=list(LENS) + ["five"])
def test_plan_chunks_merged_in_order_match_the_pallas_kernel(lens):
    """The kernel's arithmetic on the CPU: each planned chunk's unnormalised
    (m, l, acc) (p cast to the cache dtype into P V, l from the f32 p),
    merged per (sequence, kv head) in chunk order and divided by l, against
    the JAX kernel."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    x = _inputs(lens, seed=7)
    want = np.asarray(jax_fused(jnp.asarray(x["q"][:, 0]), jnp.asarray(x["k"]),
                                jnp.asarray(x["v"]), jnp.asarray(x["lens"]), block=128))
    q = torch.from_numpy(x["q"][:, 0]).reshape(len(lens), KVH, H // KVH, D)
    k, v = torch.from_numpy(x["k"]), torch.from_numpy(x["v"])
    parts = {}
    for b, kh, _, c, _, s, e in da.plan(lens, KVH, 1, 5):
        if s == e:
            continue
        sc = (q[b, kh] @ k[b, s:e, kh].T) * D ** -0.5                  # (G, slots)
        m = sc.amax(dim=1, keepdim=True)
        p = torch.exp(sc - m)
        pv = p.to(v.dtype) @ v[b, s:e, kh]
        parts.setdefault((b, kh), []).append((c, m, p.sum(dim=1, keepdim=True), pv))
    got = torch.zeros(len(lens), KVH, H // KVH, D)
    for (b, kh), chunks in parts.items():
        chunks.sort(key=lambda t: t[0])
        mm = torch.stack([m for _, m, _, _ in chunks]).amax(dim=0)
        l = sum(li * torch.exp(m - mm) for _, m, li, _ in chunks)
        acc = sum(a * torch.exp(m - mm) for _, m, _, a in chunks)
        got[b, kh] = acc / l
    np.testing.assert_allclose(got.reshape(len(lens), H, D).numpy(), want, rtol=TOL, atol=TOL)
