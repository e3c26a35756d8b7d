"""Weight-only quantization of the PyTorch port against the JAX package.

The same weights and activations, made with numpy from a seed, go through
``deepspeed_tpu.ops.pallas.woq_matmul`` (the Pallas kernel in interpret
mode on the CPU) and ``deepspeed_tpu.inference.quantization.layers`` and
through the port's ``ops/woq_matmul.py`` and
``inference/quantization/layers.py`` on CPU tensors (the plain versions):

- ``quantize_woq`` at bits 8, 4 and 6: q and scales byte-identical;
- ``woq_dequantize``: exact;
- the plain ``woq_matmul`` against the JAX kernel at M = 3, K = 512,
  N = 256, g = 128 (rtol 1e-5: one f32 summation order against another),
  from the port's own quantization and from JAX's, carried across by
  ``module_inject.woq_state_from_numpy``;
- ``QuantizedParameter`` (8, 6, 4; padded and unpadded), ``QuantizedLinear``
  (fused and flat paths), ``QuantizedEmbedding`` and
  ``quantize_model_params`` / ``dequantize_model_params``: the stored bytes
  identical, the dequantized values equal, the products within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.quantization import layers as jl
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.ops.pallas import woq_matmul as jw
from deepspeed_tpu_torch.inference.quantization import layers as tl
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import (params_from_numpy,
                                               quantized_parameter_from_numpy,
                                               woq_state_from_numpy)
from deepspeed_tpu_torch.ops import woq_matmul as tw
from deepspeed_tpu_torch.utils.tree import tree_leaves

M, K, N, G = 3, 512, 256, 128
BITS = [8, 4, 6]


def _w(shape=(K, N), seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


def _x(shape=(M, K), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same_state(t, j):
    np.testing.assert_array_equal(_bytes(t["q"].numpy()), _bytes(j["q"]))
    np.testing.assert_array_equal(t["scales"].numpy().view(np.uint32),
                                  np.asarray(j["scales"]).view(np.uint32))
    assert (t["bits"], t["group_size"], tuple(t["shape"])) == (
        j["bits"], j["group_size"], tuple(j["shape"]))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("group", [64, 128])
def test_quantize_woq_byte_identical(bits, group):
    w = _w()
    _same_state(tw.quantize_woq(torch.from_numpy(w), bits, group),
                jw.quantize_woq(jnp.asarray(w), bits, group))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_woq_dequantize_exact(bits, dtype):
    w = _w()
    t = tw.woq_dequantize(tw.quantize_woq(torch.from_numpy(w), bits, G),
                          getattr(torch, dtype))
    j = jw.woq_dequantize(jw.quantize_woq(jnp.asarray(w), bits, G), getattr(jnp, dtype))
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


def test_fp6_codes_cover_the_codebook():
    """Every e3m2 code round-trips through the port's arithmetic encoder and
    decoder, as through JAX's."""
    codes = torch.arange(64, dtype=torch.int32)
    vals = tw._fp6_decode_f32(codes)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.asarray(jw._fp6_decode_f32(jnp.arange(64))))
    back = tw._fp6_encode(vals)
    same = (back == codes) | ((vals == 0) & ((back & 0x1F) == 0))   # -0 encodes as +0
    assert bool(same.all())
    np.testing.assert_array_equal(back.numpy(), np.asarray(jw._fp6_encode(jnp.asarray(vals.numpy()))))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("source", ["port", "jax"])
def test_woq_matmul_matches_jax_kernel(bits, source):
    w, x = _w(), _x()
    jstate = jw.quantize_woq(jnp.asarray(w), bits, G)
    want = np.asarray(jw.woq_matmul(jnp.asarray(x), jstate))
    if source == "port":
        state = tw.quantize_woq(torch.from_numpy(w), bits, G)
    else:
        state = woq_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    got = tw.woq_matmul(torch.from_numpy(x), state)
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(64, 48), (33, 7)], ids=["whole", "padded"])
def test_quantized_parameter_matches_jax(bits, shape):
    w = _w(shape, seed=2)
    j = jl.QuantizedParameter.quantize(jnp.asarray(w), bits, 64)
    t = tl.QuantizedParameter.quantize(torch.from_numpy(w), bits, 64)
    assert t.q.shape == tuple(j.q.shape) and t.orig_shape == tuple(j.orig_shape)
    np.testing.assert_array_equal(_bytes(t.q.numpy()), _bytes(j.q))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(t.dequantized().numpy(), np.asarray(j.dequantized()))
    assert t.nbytes == j.nbytes
    # a JAX-quantized parameter carried across dequantizes the same
    c = quantized_parameter_from_numpy(np.asarray(j.q), np.asarray(j.scales), j.orig_shape,
                                       j.bits, j.group_size, j.dtype, device="cpu")
    np.testing.assert_array_equal(c.dequantized().numpy(), np.asarray(j.dequantized()))


LINEAR = {
    "fused_caller_group": dict(shape=(512, 64), group=128),
    "fused_native_128": dict(shape=(512, 64), group=96),
    "flat": dict(shape=(96, 40), group=64),
}


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("case", list(LINEAR))
def test_quantized_linear_matches_jax(bits, case):
    shape, group = LINEAR[case]["shape"], LINEAR[case]["group"]
    w, x = _w(shape, seed=3), _x((2, 3, shape[0]), seed=4)
    b = _w((shape[1],), seed=5)
    j = jl.QuantizedLinear(jnp.asarray(w), jnp.asarray(b), bits=bits, group_size=group)
    t = tl.QuantizedLinear(torch.from_numpy(w), torch.from_numpy(b), bits=bits,
                           group_size=group)
    assert (t.fused is None) == (j.fused is None) == (case == "flat")
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t.dequantized().numpy(), np.asarray(j.dequantized()))
    assert t.nbytes == j.nbytes


@pytest.mark.parametrize("bits", BITS)
def test_quantized_embedding_matches_jax(bits):
    table, ids = _w((40, 24), seed=6), np.array([[0, 5, 39], [7, 7, 1]])
    j = jl.QuantizedEmbedding(jnp.asarray(table), bits=bits, group_size=64)
    t = tl.QuantizedEmbedding(torch.from_numpy(table), bits=bits, group_size=64)
    np.testing.assert_array_equal(t(ids).numpy(), np.asarray(j(jnp.asarray(ids))))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_params_matches_jax(bits):
    jmodel = jax_build_model("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(build_model("tiny").cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jq = jl.quantize_model_params(jparams, bits=bits, min_size=1024)
    tq = tl.quantize_model_params(params, bits=bits, min_size=1024)
    is_q = lambda x: isinstance(x, jl.QuantizedParameter)    # noqa: E731
    jleaves, tleaves = jax.tree.leaves(jq, is_leaf=is_q), tree_leaves(tq)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert isinstance(t, tl.QuantizedParameter) == is_q(j)
        if is_q(j):
            np.testing.assert_array_equal(_bytes(t.q.numpy()), _bytes(j.q))
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert any(map(is_q, jleaves))
    for t, j in zip(tree_leaves(tl.dequantize_model_params(tq)),
                    jax.tree.leaves(jl.dequantize_model_params(jq))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("op", ["quantize_int8", "quantize_int4", "woq_matmul"])
def test_kernel_wrappers_run_the_plain_path_only_on_the_cpu(op):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device with no kernel (meta) is refused, not run through the plain
    version."""
    from deepspeed_tpu_torch.ops import quantizer as tq
    x = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if op == "woq_matmul":
            tw.woq_matmul(x, tw.quantize_woq(torch.from_numpy(_w((256, 8))), 8, 128))
        else:
            getattr(tq, op)(x, 64)
