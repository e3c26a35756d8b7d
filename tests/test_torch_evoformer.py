"""Evoformer attention of the PyTorch port against the JAX package.

The same numpy inputs go through ``deepspeed_tpu.ops.evoformer`` /
``deepspeed_tpu.ops.pallas.evoformer_flash`` (the Pallas kernel in
interpret mode on the CPU, as tests/test_flash_attention.py runs it) and
the port's ``ops/evoformer.py`` / ``ops/evoformer_flash.py`` on CPU tensors,
where the kernel wrapper runs its plain version. The plain K12 agrees with
the Pallas kernel to 2e-5 in f32 with no, one and two biases;
``DS4Sci_EvoformerAttention`` and its five gradients (q, k, v and both
biases) agree with JAX to 3e-4 on the chunked route and on the kernel route
(kernel forward, chunked recompute backward). In bf16 at D = 128 the
pre-scaled q is bit-identical to JAX's, whose scale is rounded to bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer as jevo
from deepspeed_tpu.ops.pallas import evoformer_flash as jef
from deepspeed_tpu_torch.ops import evoformer as tevo
from deepspeed_tpu_torch.ops import evoformer_flash as tef


def _inputs(b, n, s, h, d, seed=0):
    """q, k, v (B, N, S, H, D), a mask bias with -1e9 entries and a pair bias."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, s, h, d)).astype(np.float32) for _ in range(3))
    b1 = np.where(rng.random((b, n, 1, 1, s)) < 0.1, -1e9, 0.0).astype(np.float32)
    b2 = rng.standard_normal((b, 1, h, s, s)).astype(np.float32)
    return q, k, v, b1, b2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("biases", ["none", "mask", "both"])
def test_plain_kernel_matches_pallas(biases):
    q, k, v, b1, b2 = _inputs(1, 2, 128, 2, 64)
    b1 = b1 if biases != "none" else None
    b2 = b2 if biases == "both" else None
    hm = [np.moveaxis(a, 3, 2) for a in (q, k, v)]       # (B, N, H, S, D)
    want = jef.evoformer_flash_fwd(*map(jnp.asarray, hm), None if b1 is None else jnp.asarray(b1),
                                   None if b2 is None else jnp.asarray(b2), scale=64 ** -0.5)
    got = tef.evoformer_flash_fwd(*_t(*hm), None if b1 is None else torch.from_numpy(b1),
                                  None if b2 is None else torch.from_numpy(b2),
                                  scale=64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _grads_agree(jfn, tfn, arrays):
    g = np.random.default_rng(9).standard_normal(arrays[0].shape).astype(np.float32)
    jout, jvjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want = jvjp(jnp.asarray(g))
    ts = [t.requires_grad_() for t in _t(*arrays)]
    out = tfn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=3e-4, rtol=3e-4)
    (out * torch.from_numpy(g)).sum().backward()
    for t, ref, nm in zip(ts, want, ("dq", "dk", "dv", "db1", "db2")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=3e-4, rtol=3e-4,
                                   err_msg=nm)


def test_chunked_route_and_gradients_match_jax():
    arrays = _inputs(2, 3, 70, 4, 16)
    _grads_agree(lambda q, k, v, b1, b2: jevo.DS4Sci_EvoformerAttention(q, k, v, [b1, b2], chunk=32),
                 lambda q, k, v, b1, b2: tevo.DS4Sci_EvoformerAttention(q, k, v, [b1, b2], chunk=32),
                 arrays)


def test_kernel_route_and_gradients_match_jax(monkeypatch):
    """Both dispatchers forced onto their kernel routes: the Pallas forward
    (interpret) and the port's K12 wrapper (plain on the CPU), each with the
    chunked recompute backward."""
    calls = []
    orig = tef.evoformer_flash_fwd

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(jevo, "_use_pallas", lambda: True)
    monkeypatch.setattr(tevo, "_use_kernel", lambda q: True)
    monkeypatch.setattr(tevo, "evoformer_flash_fwd", spy)
    arrays = _inputs(1, 2, 128, 2, 64, seed=1)
    _grads_agree(lambda q, k, v, b1, b2: jevo.DS4Sci_EvoformerAttention(q, k, v, [b2, b1], chunk=64),
                 lambda q, k, v, b1, b2: tevo.DS4Sci_EvoformerAttention(q, k, v, [b2, b1], chunk=64),
                 arrays)
    assert calls, "the port did not take its kernel route at an eligible shape"
    # the ineligible head dim 16 stays on the chunked route
    calls.clear()
    tevo.DS4Sci_EvoformerAttention(*_t(*_inputs(1, 1, 128, 2, 16)[:3]))
    assert not calls


def test_bf16_prescale_matches_jax():
    """In bf16 JAX rounds the scale 128 ** -0.5 to bf16 before the product
    (``q * jnp.asarray(scale, q.dtype)`` in the kernel wrapper, weak typing
    in the chunked path); a Python-float product in torch would keep it in
    f32 and differ in some elements."""
    x = np.random.default_rng(5).standard_normal((2, 5, 100, 100)).astype(ml_dtypes.bfloat16)
    scale = 128 ** -0.5
    got = tef.prescale(torch.from_numpy(x.astype(np.float32)).bfloat16(), scale)
    for want in (jnp.asarray(x) * jnp.asarray(scale, jnp.bfloat16), jnp.asarray(x) * scale):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    unrounded = (torch.from_numpy(x.astype(np.float32)) * scale).bfloat16()
    assert (unrounded != got).any()


def test_bf16_d128_matches_jax():
    """bf16 at D = 128: the port's chunked route is bit-identical to JAX's
    ``_chunked`` run op by op. The public JAX function runs it under jit,
    where XLA's fused bf16 product moves half the outputs by one or two
    bf16 steps from the op-by-op result, so against it (and for the plain
    K12, which rounds p before normalising, as the kernel does) the bound
    is two bf16 steps, 2^-6 relative."""
    q, k, v, b1, b2 = _inputs(1, 2, 128, 2, 128, seed=6)
    bf = [a.astype(ml_dtypes.bfloat16) for a in (q, k, v)]
    jb = [*map(jnp.asarray, bf), jnp.asarray(b1), jnp.asarray(b2)]
    eager = np.asarray(jevo._chunked(*jb, 256))
    jitted = np.asarray(jevo.DS4Sci_EvoformerAttention(*jb[:3], jb[3:])).astype(np.float32)
    got = tevo.DS4Sci_EvoformerAttention(*[torch.from_numpy(a.astype(np.float32)).bfloat16()
                                           for a in bf], _t(b1, b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), eager.view(np.int16))
    np.testing.assert_allclose(got.float().numpy(), jitted, atol=2 ** -6, rtol=2 ** -6)
    # the plain K12 on the same bf16 inputs (p rounded once, as the kernel)
    hm = [torch.from_numpy(a.astype(np.float32)).bfloat16().movedim(3, 2) for a in bf]
    plain = tef.evoformer_flash_fwd(*hm, *_t(b1, b2), scale=128 ** -0.5).movedim(2, 3)
    np.testing.assert_allclose(plain.float().numpy(), jitted, atol=2 ** -6, rtol=2 ** -6)


def test_bias_shapes_checked():
    q = torch.zeros(1, 2, 8, 2, 16)
    with pytest.raises(ValueError):
        tevo.DS4Sci_EvoformerAttention(q, q, q, [torch.zeros(1, 2, 3)])
    with pytest.raises(ValueError):
        tevo.DS4Sci_EvoformerAttention(q, q, q, [torch.zeros(1, 2, 1, 1, 8)] * 3)


def test_supported_rule_is_jax_rule():
    for s in (64, 128, 256, 384, 512, 640, 1024, 70):
        for d in (16, 32, 64, 128, 256):
            assert tef.evoformer_flash_supported(s, d) == jef.evoformer_flash_supported(s, d)
