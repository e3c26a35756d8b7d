"""Ring flash attention of the PyTorch port against the JAX package.

- One ring step: the plain K13 (``ring_fwd_step``) and K14/K15
  (``ring_dq_step``, ``ring_dkv_step``, through ``_bwd_step``) on CPU
  tensors against JAX's ``_fwd_step`` / ``_bwd_step`` (the Pallas kernels in
  interpret mode with 8-row blocks, so a 16-token shard walks all three loop
  ranges), at the diagonal step, a step below it and one above it, for no
  mask beyond causal, a window, ALiBi, segment ids and all three, with 4 and
  2 kv heads over 4 query heads. The carry enters non-empty (and empty on
  the diagonal); lse is consistent with the step's scores. K15's dk/dv,
  summed over the group in the step, against JAX's per-head output summed
  outside. f32; 2e-5.
- The whole ring: the port's ``ring_attention`` over 4 local shards in one
  process against JAX's ``ring_attention`` on the virtual mesh
  (data=2, seq=4): outputs at 2e-5 and gradients (``jax.grad``) at 3e-5,
  the tolerances of tests/test_sequence_parallel.py, on the flash route
  (D = 64), the einsum route (D = 16; a tensor window at D = 64), and the
  einsum body called directly on an eligible shape.
- The loop bounds (``_global_q_ranges``) and ``ring_flash_supported`` give
  JAX's answers on a grid; the transport's rotation in one process.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.sequence import ring_attention as jax_ring
from deepspeed_tpu.sequence import ring_flash as jax_rf
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu_torch.sequence import ring_attention as port_ring
from deepspeed_tpu_torch.sequence import ring_flash as port_rf
from deepspeed_tpu_torch.utils import groups


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STEP_TOL = 2e-5
OUT_TOL, GRAD_TOL = 2e-5, 3e-5
B, H, S_SHARD, D = 1, 4, 16, 64
STATIC = ("alibi", "segmented", "window", "block_q", "block_k", "vma")
JAX_FWD = jax.jit(jax_rf._fwd_step, static_argnames=STATIC)
JAX_BWD = jax.jit(jax_rf._bwd_step, static_argnames=STATIC)

# (q_off, k_off) of the query and kv shards: the diagonal, a step below it
# (the shard just before), and one above it (nothing visible)
STEPS = {"diagonal": (16, 16), "below": (32, 16), "above": (0, 16)}
FEATURES = {
    "plain": {},
    "window": {"window": 10},
    "alibi": {"alibi": True},
    "segments": {"segments": True},
    "all": {"window": 10, "alibi": True, "segments": True},
}


@pytest.fixture(autouse=True)
def _one_shard_after():
    yield
    groups.reset()


def _step_inputs(kvh, seed):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("q", (B, S_SHARD, H, D)), ("k", (B, S_SHARD, kvh, D)), ("v", (B, S_SHARD, kvh, D)),
        ("do", (B, S_SHARD, H, D)), ("acc", (B, S_SHARD, H, D)), ("delta", (B, H, S_SHARD)))}
    x["q"] *= D ** -0.5
    x["m"] = rng.standard_normal((B, H, S_SHARD)).astype(np.float32)
    x["l"] = rng.uniform(0.5, 2.0, (B, H, S_SHARD)).astype(np.float32)
    # segments: rows 0-5 in segment 1 and 6-15 in 2; keys 0-3 in 0, 4-11 in
    # 1, 12-15 in 2, so some rows see no key of the shard at all
    x["qseg"] = np.repeat([[1] * 6 + [2] * 10], B, axis=0).astype(np.int32)
    x["kseg"] = np.repeat([[0] * 4 + [1] * 8 + [2] * 4], B, axis=0).astype(np.int32)
    x["slopes"] = np.linspace(0.5, 0.05, H).astype(np.float32)
    x["other_lse"] = rng.standard_normal((B, H, S_SHARD)).astype(np.float32) + 2.0
    return x


def _port_kw(x, feats, q_off, k_off):
    seg = feats.get("segments")
    return dict(q_off=q_off, k_off=k_off,
                slopes=torch.from_numpy(x["slopes"]) if feats.get("alibi") else None,
                qseg=torch.from_numpy(x["qseg"]) if seg else None,
                kseg=torch.from_numpy(x["kseg"]) if seg else None,
                window=feats.get("window", 0))


def _jax_args(x, feats, q_off, k_off):
    seg = feats.get("segments", False)
    qseg = jnp.asarray(x["qseg"])[:, None] if seg else jnp.zeros((B, 1, 128), jnp.int32)
    kseg = jnp.asarray(x["kseg"])[:, None] if seg else qseg
    slopes = jnp.broadcast_to(jnp.asarray(x["slopes"])[:, None], (H, 128))
    if not feats.get("alibi"):
        slopes = jnp.zeros_like(slopes)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))   # noqa: E731  (B, S, H, D) -> (B, H, S, D)
    static = dict(alibi=bool(feats.get("alibi")), segmented=bool(seg),
                  window=feats.get("window"), block_q=8, block_k=8, vma=frozenset())
    return (jnp.asarray([q_off, k_off], jnp.int32), t(x["q"]), t(x["k"]), t(x["v"]),
            slopes, qseg, kseg), t, static


def _consistent_lse(x, kw):
    """A row log-sum-exp that counts this step's visible scores and a share
    from other shards, so that every p = exp(s - lse) is at most 1."""
    m = torch.full((B, H, S_SHARD), port_rf.NEG_INF)
    l = torch.zeros((B, H, S_SHARD))
    acc = torch.zeros((B, S_SHARD, H, D))
    port_rf.ring_fwd_step_plain(torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
                                torch.from_numpy(x["v"]), m, l, acc, **kw)
    step = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), float("-inf"))
    return torch.logaddexp(step, torch.from_numpy(x["other_lse"]))


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("features", sorted(FEATURES))
def test_ring_step_matches_pallas(features, kvh):
    feats = FEATURES[features]
    x = _step_inputs(kvh, seed=7 + kvh)
    counts = [f.launches for f in (port_rf.ring_fwd_step, port_rf.ring_dq_step,
                                   port_rf.ring_dkv_step)]
    T = torch.from_numpy
    for step, (q_off, k_off) in STEPS.items():
        kw = _port_kw(x, feats, q_off, k_off)
        args, t, static = _jax_args(x, feats, q_off, k_off)
        carries = {"carried": (x["m"], x["l"], x["acc"])}
        if step == "diagonal":
            carries["empty"] = (np.full_like(x["m"], port_rf.NEG_INF), np.zeros_like(x["l"]),
                                np.zeros_like(x["acc"]))
        for name, (m0, l0, acc0) in carries.items():
            jm, jl, jacc = JAX_FWD(*args, jnp.asarray(m0)[:, :, None], jnp.asarray(l0)[:, :, None],
                                   t(acc0), **static)
            m, l, acc = T(m0.copy()), T(l0.copy()), T(acc0.copy())
            port_rf.ring_fwd_step(T(x["q"]), T(x["k"]), T(x["v"]), m, l, acc, **kw)
            msg = f"{features} kvh={kvh} {step} {name}"
            np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, :, 0], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg="m " + msg)
            np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :, 0], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg="l " + msg)
            np.testing.assert_allclose(acc.numpy(), np.asarray(jacc).transpose(0, 2, 1, 3),
                                       rtol=STEP_TOL, atol=STEP_TOL, err_msg="acc " + msg)
            if step == "above":   # nothing visible: the carry comes back as it went in
                assert torch.equal(m, T(m0)) and torch.equal(l, T(l0)) and torch.equal(acc, T(acc0))
        lse = _consistent_lse(x, kw)
        jdq, jdk, jdv = JAX_BWD(*args[:4], t(x["do"]), jnp.asarray(lse.numpy())[:, :, None],
                                jnp.asarray(x["delta"])[:, :, None], *args[4:], **static)
        # the accumulators enter holding earlier steps' sums
        dq0 = np.full((B, S_SHARD, H, D), 0.25, np.float32)
        dkv0 = np.full((B, S_SHARD, kvh, D), -0.5, np.float32)
        dq, dk, dv = T(dq0.copy()), T(dkv0.copy()), T(dkv0.copy())
        port_rf._bwd_step(T(x["q"]), T(x["k"]), T(x["v"]), T(x["do"]), lse, T(x["delta"]),
                          dq, dk, dv, **kw)
        for nm, got, start, want in (("dq", dq, dq0, jdq), ("dk", dk, dkv0, jdk),
                                     ("dv", dv, dkv0, jdv)):
            np.testing.assert_allclose(got.numpy() - start, np.asarray(want).transpose(0, 2, 1, 3),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{nm} {features} kvh={kvh} {step}")
        # the single-kernel wrappers give the same sums as _bwd_step
        dq2, dk2, dv2 = T(dq0.copy()), T(dkv0.copy()), T(dkv0.copy())
        port_rf.ring_dq_step(T(x["q"]), T(x["k"]), T(x["v"]), T(x["do"]), lse, T(x["delta"]),
                             dq2, **kw)
        port_rf.ring_dkv_step(T(x["q"]), T(x["k"]), T(x["v"]), T(x["do"]), lse, T(x["delta"]),
                              dk2, dv2, **kw)
        assert torch.equal(dq2, dq) and torch.equal(dk2, dk) and torch.equal(dv2, dv)
    # CPU tensors never count as kernel launches
    assert [f.launches for f in (port_rf.ring_fwd_step, port_rf.ring_dq_step,
                                 port_rf.ring_dkv_step)] == counts


def test_global_q_ranges_match_jax():
    grid = itertools.product((0, 8, 24, 64), (0, 16, 40, 64), (8, 16), (8, 32), (None, 1, 9, 40))
    for rows_base, k_off, bq, bk, window in grid:
        want = [int(v) for v in jax_rf._global_q_ranges(jnp.int32(rows_base), jnp.int32(k_off),
                                                        bq, bk, 64 // bk, window)]
        got = list(port_rf._global_q_ranges(rows_base, k_off, bq, bk, 64 // bk, window))
        assert got == want, (rows_base, k_off, bq, bk, window)


def test_ring_flash_supported_matches_jax():
    grid = itertools.product((8, 96, 512, 600, 1024, 8192), (16, 64, 80, 128, 256),
                             (None, 12, jnp.int32(12)))
    for s, d, window in grid:
        port_window = torch.tensor(12) if isinstance(window, jax.Array) else window
        assert port_rf.ring_flash_supported(s, s, d, port_window) == \
            jax_rf.ring_flash_supported(s, s, d, window), (s, d, window)


def test_transport_rotates_in_one_process():
    ring = port_rf.RingTransport(4)
    assert ring.ranks == [0, 1, 2, 3] and ring.procs == 1
    shards = [(torch.tensor(i), None) for i in range(4)]
    fwd = ring.rotate(shards)
    assert [int(t[0]) for t in fwd] == [3, 0, 1, 2] and fwd[0][1] is None
    # n rotations bring every shard home
    state = shards
    for _ in range(4):
        state = ring.rotate(state)
    assert [int(t[0]) for t in state] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        port_rf.RingTransport(0)


# ---------------------------------------------------------------- the whole ring

# name: (D, KVH, features, route)
RING_CASES = {
    "flash_causal": (64, 4, {}, "flash"),
    "flash_all": (64, 2, {"window": 12, "alibi": True, "segments": True}, "flash"),
    "einsum_d16_all": (16, 2, {"window": 9, "alibi": True, "segments": True}, "einsum"),
    "einsum_tensor_window": (64, 2, {"window": "tensor"}, "einsum"),
    "einsum_body_eligible": (64, 2, {"window": 12, "segments": True}, "body"),
}


def _ring_inputs(d, kvh, seed, b=2, s=32, h=4):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("q", (b, s, h, d)), ("k", (b, s, kvh, d)), ("v", (b, s, kvh, d)), ("cot", (b, s, h, d)))}
    x["seg"] = np.repeat([[0, 0, 1, 1]], b, axis=0).repeat(s // 4, axis=1).astype(np.int32)
    x["seg"][1, 5:] += 3          # the second row packs at another place
    return x


def _spy(monkeypatch, attr, name, calls):
    """Record ``name`` in ``calls`` whenever ring_attention takes ``attr``."""
    orig = getattr(port_ring, attr)

    def spy(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(port_ring, attr, spy)


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax(case, monkeypatch):
    d, kvh, feats, route = RING_CASES[case]
    x = _ring_inputs(d, kvh, seed=len(case))
    jax_groups.reset_mesh()
    jax_groups.set_mesh(jax_groups.build_mesh(data=2, seq=4))
    window = feats.get("window")
    jwin = jnp.int32(9) if window == "tensor" else window
    pwin = torch.tensor(9) if window == "tensor" else window
    slopes = np.array(jax_alibi_slopes(4)) if feats.get("alibi") else None
    seg = x["seg"] if feats.get("segments") else None
    kw = dict(window=jwin, alibi_slopes=None if slopes is None else jnp.asarray(slopes),
              segment_ids=None if seg is None else jnp.asarray(seg))

    def jax_loss(q, k, v):
        return jnp.sum(jax_ring.ring_attention(q, k, v, **kw) * jnp.asarray(x["cot"]))

    jq, jk, jv = (jnp.asarray(x[n]) for n in "qkv")
    jout = jax_ring.ring_attention(jq, jk, jv, **kw)
    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    jax_groups.reset_mesh()

    groups.set_sequence_parallel(4)
    calls = []
    for name, attr in (("flash", "ring_flash_body"), ("einsum", "_ring_body")):
        _spy(monkeypatch, attr, name, calls)
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    pkw = dict(window=pwin, alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
               segment_ids=None if seg is None else torch.from_numpy(seg))
    if route == "body":
        transport = port_rf.RingTransport(4)
        out = port_ring._ring_body(q, k, v, pkw["segment_ids"], transport, d ** -0.5, pwin, None)
    else:
        out = port_ring.ring_attention(q, k, v, **pkw)
        assert calls == [route]
    (out * torch.from_numpy(x["cot"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=OUT_TOL, atol=OUT_TOL)
    for t, jg, n in zip((q, k, v), jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{n} {case}")
