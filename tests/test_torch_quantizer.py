"""Group quantizers of the PyTorch port against the JAX Pallas kernels.

The same inputs, made with numpy from a seed, go through
``deepspeed_tpu.ops.pallas.quantizer`` (``quantize_int8`` /
``quantize_int4`` in interpret mode on the CPU, as
tests/test_quantization.py runs them) and the port's ``ops/quantizer.py``
on CPU tensors (its plain version). The codes and the packed nibbles must
be byte-identical and the f32 scales bit-identical; the dequantizers must
agree exactly. Cases: random groups in f32 and bf16, an all-zero group,
exact .5 ties (round half to even), groups whose largest magnitude is
negative, and a flat weight whose last group is short (the zero padding of
``QuantizedParameter``).
"""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.pallas import quantizer as jq
from deepspeed_tpu_torch.ops import quantizer as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _special(gs, qmax):
    """Four groups: all zero; exact .5 ties at scale 1 (absmax == qmax);
    a negative maximum; a negative maximum with ties at scale 2."""
    g = np.zeros((4, gs), np.float32)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5], np.float32)
    g[1, :8] = ties
    g[1, 8] = qmax
    g[2] = np.linspace(-1.0, 0.5, gs)
    g[2, 3] = -9.0
    g[3, :8] = ties * 2
    g[3, 9] = -2 * qmax
    return g.reshape(-1)


def _case(name, dtype, gs, qmax):
    rng = np.random.default_rng(0)
    if name == "random":
        x = rng.standard_normal(8 * gs).astype(np.float32) * 3
    else:
        x = _special(gs, qmax)
    np_dt, t_dt, _ = DTYPES[dtype]
    xs = x.astype(np_dt)
    return xs, torch.from_numpy(xs.astype(np.float32)).to(t_dt)


def _bytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["random", "special"])
@pytest.mark.parametrize("gs", [64, 256])
def test_int8_byte_identical(dtype, case, gs):
    xs, xt = _case(case, dtype, gs, 127.0)
    jqv, js = jq.quantize_int8(jnp.asarray(xs).reshape(-1, gs), gs)
    tqv, ts = tq.quantize_int8(xt.reshape(-1, gs), gs)
    assert tqv.shape == tuple(jqv.shape) and tqv.dtype == torch.int8
    np.testing.assert_array_equal(_bytes(tqv.numpy()), _bytes(jqv))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    jd = np.asarray(jq.dequantize_int8(jqv, js, jnp.float32, gs))
    td = tq.dequantize_int8(tqv, ts, torch.float32, gs).numpy()
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["random", "special"])
@pytest.mark.parametrize("gs", [64, 256])
def test_int4_byte_identical(dtype, case, gs):
    xs, xt = _case(case, dtype, gs, 7.0)
    jp, js, jshape = jq.quantize_int4(jnp.asarray(xs), gs)
    tp, ts, tshape = tq.quantize_int4(xt, gs)
    assert tshape == tuple(jshape) and tp.shape == tuple(jp.shape)
    np.testing.assert_array_equal(_bytes(tp.numpy()), _bytes(jp))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    jd = np.asarray(jq.dequantize_int4(jp, js, jshape, jnp.float32, gs))
    td = tq.dequantize_int4(tp, ts, tshape, torch.float32, gs).numpy()
    np.testing.assert_array_equal(td, jd)


def test_special_groups_round_half_even():
    """The tie group at scale 1 rounds 0.5, 1.5, 2.5 to 0, 2, 2 (and the
    negatives alike); the all-zero group takes scale 1e-10 times the f32
    reciprocal of qmax (the product XLA makes of the JAX kernel's division
    by the constant) and codes 0."""
    _, xt = _case("special", "float32", 64, 127.0)
    q, s = tq.quantize_int8(xt.reshape(4, 64), 64)
    assert q[1, :8].tolist() == [0, 2, 2, 0, -2, -2, 4, -4]
    assert (q[0] == 0).all()
    assert float(s[0, 0]) == np.float32(1e-10) * (np.float32(1.0) / np.float32(127.0))
    assert float(s[1, 0]) == 1.0
    assert int(q[2, 3]) == -127


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_groups_pads_the_last_group_with_zeros(bits, dtype):
    """A flat weight whose length is no multiple of the group quantizes as
    the JAX ``QuantizedParameter`` does: zero-padded to whole groups."""
    gs, n = 64, 5 * 64 + 23
    rng = np.random.default_rng(1)
    np_dt, t_dt, _ = DTYPES[dtype]
    xs = (rng.standard_normal(n) * 2).astype(np_dt)
    padded = np.concatenate([xs, np.zeros(64 - 23, np_dt)])
    if bits == 8:
        jqv, js = jq.quantize_int8(jnp.asarray(padded), gs)
    else:
        jqv, js, _ = jq.quantize_int4(jnp.asarray(padded), gs)
    tqv, ts = tq.quantize_groups(torch.from_numpy(xs.astype(np.float32)).to(t_dt), bits, gs)
    np.testing.assert_array_equal(_bytes(tqv.numpy()), _bytes(jqv))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("bits", [8, 4])
def test_ds_quantize_matches_jax(bits):
    x = np.random.default_rng(2).standard_normal((6, 128)).astype(np.float32)
    j = jq.ds_quantize(jnp.asarray(x), groups=12, bits=bits)
    t = tq.ds_quantize(torch.from_numpy(x), groups=12, bits=bits)
    np.testing.assert_array_equal(_bytes(t[0].numpy()), _bytes(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    with pytest.raises(ValueError):
        tq.ds_quantize(torch.from_numpy(x), groups=12, bits=6)
