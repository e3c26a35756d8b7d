"""Flash attention of the PyTorch port against the JAX Pallas kernels.

The same inputs, made with numpy from a seed, go through
``deepspeed_tpu.ops.pallas.flash_attention`` (K3 forward, K4/K5 through
``jax.vjp``; interpret mode with 64-row blocks, as tests/test_flash_attention.py
runs it on the CPU) and ``deepspeed_tpu_torch.ops.flash_attention`` on CPU
tensors (its plain versions, through the autograd function). f32
throughout; tolerances as tests/test_flash_attention.py: 2e-5 forward (out
and the row log-sum-exp), 5e-4 for dq, dk, dv (one f32 summation order
against another over a longer chain).

The port's multihead_attention is also held to JAX's on the reference
branches the flash kernels never take: an additive bias, logit softcap, and
a window given as a tensor (the per-layer local/global pattern).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jax_attention
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.ops import flash_attention as port_flash


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FWD_TOL, BWD_TOL = 2e-5, 5e-4
BLOCK = 64

# name: (B, S, H, KVH, options)
CASES = {
    "causal": (2, 128, 2, 2, {}),
    "noncausal": (1, 128, 2, 2, {"causal": False}),
    "gqa_kvh2": (1, 128, 4, 2, {}),
    "gqa_kvh1": (1, 128, 4, 1, {}),
    "window": (1, 192, 2, 2, {"window": 70}),
    "alibi": (1, 128, 4, 2, {"alibi": True}),
    "segments": (2, 128, 2, 2, {"segments": True}),
    "segments_noncausal": (1, 128, 2, 1, {"segments": True, "causal": False}),
    # head dim 128, the other one the Hopper backward kernels are built for
    "d128_gqa4_alibi": (1, 128, 4, 1, {"alibi": True, "d": 128}),
    "d128_noncausal_gqa_segments": (2, 128, 4, 2, {"segments": True, "causal": False,
                                                   "d": 128}),
    "d128_window_gqa": (1, 192, 4, 2, {"window": 70, "d": 128}),
}


def _inputs(b, s, h, kvh, opts, seed, d=64):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal(shape).astype(np.float32)
         for n, shape in (("q", (b, s, h, d)), ("k", (b, s, kvh, d)),
                          ("v", (b, s, kvh, d)), ("do", (b, s, h, d)))}
    kw = {"causal": opts.get("causal", True), "window": opts.get("window")}
    if opts.get("alibi"):
        kw["alibi_slopes"] = np.linspace(0.5, 0.05, h).astype(np.float32)
    if opts.get("segments"):
        seg = np.zeros((b, s), np.int32)
        seg[0, s // 3:] = 1
        seg[0, (2 * s) // 3:] = 2
        seg[-1, s // 5:] = 3   # another packing in the last row
        kw["segment_ids"] = seg
    return x, kw


def _jax(x, kw):
    """JAX out, lse (B, H, S) and (dq, dk, dv) for the cotangent do."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK, **jkw)

    out, vjp = jax.vjp(f, q, k, v)
    grads = vjp(jnp.asarray(x["do"]))
    # lse comes from the forward kernel itself, on the wrapper's layout
    b, s, h, d = q.shape
    seg = (jnp.asarray(kw["segment_ids"], jnp.int32)[:, None, :]
           if "segment_ids" in kw else jnp.zeros((b, 1, 128), jnp.int32))
    slopes = (jnp.broadcast_to(jnp.asarray(kw["alibi_slopes"])[:, None], (h, 128))
              if "alibi_slopes" in kw else jnp.zeros((h, 128), jnp.float32))
    _, lse = jax_flash._fwd((q * d ** -0.5).transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                            v.transpose(0, 2, 1, 3), slopes, seg, kw["causal"],
                            "alibi_slopes" in kw, "segment_ids" in kw, kw["window"],
                            BLOCK, BLOCK)
    return np.asarray(out), np.asarray(lse)[:, :, 0, :], [np.asarray(g) for g in grads]


def _port(x, kw):
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    out = port_flash.flash_attention(q, k, v, **tkw)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(x["do"]))
    d = q.shape[-1]
    _, lse = port_flash.flash_attention_fwd(
        (q * d ** -0.5).detach(), k.detach(), v.detach(), causal=tkw["causal"],
        segment_ids=tkw.get("segment_ids"), alibi_slopes=tkw.get("alibi_slopes"),
        window=tkw["window"] or 0)
    return out.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_pallas(name):
    b, s, h, kvh, opts = CASES[name]
    x, kw = _inputs(b, s, h, kvh, opts, seed=len(name), d=opts.get("d", 64))
    j_out, j_lse, j_grads = _jax(x, kw)
    p_out, p_lse, p_grads = _port(x, kw)
    np.testing.assert_allclose(p_out, j_out, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(p_lse, j_lse, rtol=FWD_TOL, atol=FWD_TOL)
    for nm, got, want in zip(("dq", "dk", "dv"), p_grads, j_grads):
        np.testing.assert_allclose(got, want, rtol=BWD_TOL, atol=BWD_TOL, err_msg=nm)


def test_any_sequence_length():
    """The port takes an S that is no multiple of a tile (JAX requires its
    block to divide S): forward and grads against the reference path."""
    x, kw = _inputs(1, 100, 4, 2, {}, seed=11)
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    do = torch.from_numpy(x["do"])
    out = port_flash.flash_attention(q, k, v)
    ref = port_attention.reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for a, b_ in zip(torch.autograd.grad(out, (q, k, v), do),
                     torch.autograd.grad(ref, (q, k, v), do)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=BWD_TOL, atol=BWD_TOL)


def test_cpu_tensors_do_not_count_launches():
    x, kw = _inputs(1, 128, 2, 2, {}, seed=12)
    counts = [f.launches for f in (port_flash.flash_attention_fwd,
                                   port_flash.flash_attention_dq,
                                   port_flash.flash_attention_dkv)]
    q = torch.from_numpy(x["q"]).requires_grad_(True)
    out = port_flash.flash_attention(q, torch.from_numpy(x["k"]), torch.from_numpy(x["v"]))
    out.sum().backward()
    assert [f.launches for f in (port_flash.flash_attention_fwd,
                                 port_flash.flash_attention_dq,
                                 port_flash.flash_attention_dkv)] == counts


def test_flash_argument_contract():
    x, _ = _inputs(1, 128, 2, 2, {}, seed=13)
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    with pytest.raises(NotImplementedError):
        port_flash.flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, k[:, :64], v[:, :64])
    with pytest.raises(NotImplementedError):   # the ring is causal-only
        port_attention.multihead_attention(q, k, v, causal=False, impl="ring")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_auto_dispatch_on_card_ignores_dtype(monkeypatch, dtype):
    """On the card the auto dispatch sends every eligible shape to the flash
    kernels whatever its dtype (the kernels raise for f16/f32), and never
    the reference path; an ineligible shape still takes the reference."""
    calls = []
    monkeypatch.setattr(port_attention, "_on_card", lambda t: True)
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda q, k, v, **kw: calls.append(q.dtype) or q)
    x, _ = _inputs(1, 128, 2, 2, {}, seed=14)
    q, k, v = (torch.from_numpy(x[n]).to(dtype) for n in "qkv")
    port_attention.multihead_attention(q, k, v)
    assert calls == [dtype]
    bias = torch.zeros(1, 2, 128, 128, dtype=torch.float32)
    port_attention.multihead_attention(q.float(), k.float(), v.float(), bias=bias)
    port_attention.multihead_attention(q.float()[:, :64], k.float()[:, :64], v.float()[:, :64])
    assert calls == [dtype]


def test_flash_kernel_refuses_other_dtypes():
    x, _ = _inputs(1, 128, 2, 2, {}, seed=15)
    q, k, v = (torch.from_numpy(x[n]).half() for n in "qkv")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_flash._check(q, k, v, None, None, {})


def _mha_both(x, **kw):
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    j = jax_attention.multihead_attention(*(jnp.asarray(x[n]) for n in "qkv"), **jkw)
    t = port_attention.multihead_attention(*(torch.from_numpy(x[n]) for n in "qkv"), **tkw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("branch", ["bias", "softcap", "tensor_window", "alibi_segments"])
def test_multihead_attention_reference_branches(branch):
    x, _ = _inputs(2, 48, 4, 2, {}, seed=20 + len(branch), d=16)
    rng = np.random.default_rng(5)
    kw = {
        "bias": {"bias": rng.standard_normal((1, 4, 48, 48)).astype(np.float32)},
        "softcap": {"softcap": 3.0, "scale": 0.5},
        "tensor_window": {"window": np.asarray(9, np.int32)},
        "alibi_segments": {"alibi_slopes": np.linspace(0.3, 0.02, 4).astype(np.float32),
                           "segment_ids": np.repeat(np.arange(4, dtype=np.int32), 12)[None]
                           .repeat(2, axis=0)},
    }[branch]
    j, t = _mha_both(x, **kw)
    np.testing.assert_allclose(t, j, rtol=FWD_TOL, atol=FWD_TOL)
