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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


# ---- the kernel's routes and split plans (host functions, ops/woq_matmul.py)

@pytest.mark.parametrize("m,n,bits,aligned,route", [
    (1, 4096, 8, True, "stream"), (4, 14336, 8, True, "stream"), (16, 4096, 8, True, "stream"),
    (8, 4096, 4, True, "stream"), (8, 4096, 6, True, "stream"), (9, 4096, 6, True, "wgmma"),
    (17, 4096, 8, True, "wgmma"), (9, 4096, 4, True, "wgmma"), (300, 4096, 8, True, "wgmma"),
    (2048, 14336, 6, True, "wgmma"), (4, 1000, 8, True, "simt"), (2048, 1000, 4, True, "simt"),
    (4, 4104, 6, True, "simt"), (4, 4096, 8, False, "simt"), (2048, 4096, 4, False, "simt")])
def test_route_is_chosen_by_shape(m, n, bits, aligned, route):
    """Small M streams the weight, large M takes the wgmma mainloop, and an N
    that is no multiple of 16 (or a tensor off 16-byte alignment) keeps the
    SIMT kernel; the crossover is STREAM_MAX_M[bits]."""
    assert tw.woq_route(m, n, bits, aligned) == route
    for b in BITS:
        assert tw.woq_route(tw.STREAM_MAX_M[b], 4096, b) == "stream"
        assert tw.woq_route(tw.STREAM_MAX_M[b] + 1, 4096, b) == "wgmma"


PLAN_SHAPES = [(4096, 14336), (14336, 4096), (4096, 1024), (4096, 4096), (512, 4096),
               (256, 16), (1536, 4112)]


PLAN_CASES = [(k, n, group, m, bits) for k, n in PLAN_SHAPES for group in (32, 128, 256)
              for m in (1, 4, 8, 16) for bits in BITS
              if k % (group * tw._PLANES[bits]) == 0 and m <= tw.STREAM_MAX_M[bits]]


@pytest.mark.parametrize("k,n,group,m,bits", PLAN_CASES)
def test_stream_plan_covers_k_in_whole_group_aligned_steps(k, n, group, m, bits):
    """The cluster's blocks take runs of whole steps that cover every byte
    row of every plane once (so every k value once); a step's rows never
    straddle a quantization group; the cluster fits the hardware's portable
    size; a chunk is a whole number of the 4 warps' prefetch rounds and fits
    the block's shared memory."""
    cs, per, chunk = tw.stream_plan(m, k, n, bits, group, 132)
    rps = tw.STREAM_ROWS_PER_STEP[bits]
    rows = k // tw._PLANES[bits]
    steps = rows // rps
    assert rows % rps == 0 and 1 <= cs <= tw.STREAM_MAX_CLUSTER
    runs = [(z * per, min((z + 1) * per, steps)) for z in range(cs)]
    assert all(a < b for a, b in runs) and runs[-1][1] == steps
    covered = [r for a, b in runs for s in range(a, b) for r in range(s * rps, (s + 1) * rps)]
    assert covered == list(range(rows))
    assert all((s * rps) // group == ((s + 1) * rps - 1) // group for s in range(steps))
    k_values = sorted(p * rows + r for p in range(tw._PLANES[bits]) for r in covered)
    assert k_values == list(range(k))
    unit = tw.STREAM_WARPS * tw.STREAM_PREFETCH[bits]
    assert chunk % unit == 0
    m_pad = 8 if m <= 8 else 16
    assert (chunk == unit or tw._stream_smem(m_pad, tw._PLANES[bits], rps, chunk, group)
            <= tw.STREAM_SMEM_BYTES)


@pytest.mark.parametrize("k,n", PLAN_SHAPES)
def test_stream_plan_sizes_the_cluster_to_the_card(k, n):
    """The blocks fit one wave at the blocks an SM the registers allow,
    unless the column tiles alone need more: a wide N needs fewer K splits
    than a narrow one, and more SMs never give fewer splits."""
    tiles = -(-n // tw.STREAM_COLS)
    for bits in BITS:
        for sms in (66, 132, 264):
            cs, _, _ = tw.stream_plan(4, k, n, bits, 128, sms)
            assert cs == 1 or tiles * cs <= tw.STREAM_BLOCKS_PER_SM[bits] * sms
    assert tw.stream_plan(4, k, n, 8, 128, 264)[0] >= tw.stream_plan(4, k, n, 8, 128, 66)[0]


@pytest.mark.parametrize("m,k,n", [(4, 4096, 1000), (300, 4096, 1000), (1, 14336, 4104)])
def test_simt_split_covers_k(m, k, n):
    """The SIMT route's split-K ranges are whole 32-row steps covering K."""
    splits, per = tw._splitk(m, k, n)
    assert per % tw.KERNEL_K_STEP == 0 and (splits - 1) * per < k <= splits * per


def _phase_count():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_phase_count.py"
    spec = importlib.util.spec_from_file_location("chip_phase_count", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PHASE_COUNT = _phase_count()


@pytest.mark.parametrize("i", range(len(PHASE_COUNT.WOQ_PATCHES)))
def test_phase_count_finds_what_it_instruments_in_k6(i):
    """chip_phase_count.py patches the committed K6 source in order: patch i
    finds its text once the patches before it are applied, and the whole
    list applies, with the counters' reader after the kernels."""
    source = (tw.op_builder.CSRC / "woq_matmul.cu").read_text()
    text = source
    for old, new in PHASE_COUNT.WOQ_PATCHES[:i]:
        text = text.replace(old, new, 1)
    assert PHASE_COUNT.WOQ_PATCHES[i][0] in text
    patched = PHASE_COUNT.patch_woq(source)
    assert patched is not None and patched.rstrip().endswith(
        'extern "C" int ds_woq_matmul' + source.split('extern "C" int ds_woq_matmul')[1].rstrip())
    assert PHASE_COUNT.WOQ_READER in patched
