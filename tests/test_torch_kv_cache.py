"""KV cache and allocator of the PyTorch port against the JAX package:
refcounted allocation, trash block 0, and the shape-bucket and byte
arithmetic, which must equal the JAX values exactly; the int8 page rows
(``quantize_kv_lanes`` / ``dequantize_kv_lanes``, byte for byte, with
lanes holding NaN and inf bit patterns read as 0) and the page movers
(``copy_blocks``, ``read_pages``, ``scatter_pages``, ``gather``, ``write``)
on float and int8 pools, byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import kv_cache as JK
from deepspeed_tpu.inference.v2.kv_cache import BlockedKVCache as JaxKV
from deepspeed_tpu_torch.inference.v2 import kv_cache as TK
from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.kv_cache import BlockedKVCache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_allocator_refcounts():
    a = BlockedAllocator(6)
    got = a.allocate(3)
    assert got == [0, 1, 2] and a.free_blocks == 3
    a.share([1, 2])
    assert a.refcount(1) == 2 and a.refcount(0) == 1
    a.free([1, 2])                       # one reference each: still held
    assert a.free_blocks == 3 and a.refcount(1) == 1
    a.free([0, 1, 2])
    assert a.free_blocks == 6 and a.refcount(1) == 0
    with pytest.raises(RuntimeError, match="double-free"):
        a.free([1])
    with pytest.raises(RuntimeError, match="share"):
        a.share([4])
    with pytest.raises(RuntimeError, match="Out of KV blocks"):
        a.allocate(7)
    b = a.allocate(2)
    with pytest.raises(RuntimeError, match="double-free"):
        a.free([b[0], b[0]])             # the same block twice in one call


def test_trash_block_is_block_zero():
    kv = BlockedKVCache(2, 2, 16, num_blocks=5, block_size=8, dtype=torch.float32)
    kv.reserve_trash_block()
    assert kv.allocator.refcount(0) == 1
    assert 0 not in kv.allocator.allocate(kv.free_blocks)
    assert kv.k.shape == (2, 2, 5, 8, 16) and kv.k.dtype == torch.float32
    assert float(kv.k.abs().sum()) == 0.0


def test_bucket_arithmetic_matches_jax():
    for cap in (1, 7, 16, 100):
        for need in range(0, 130):
            assert BlockedKVCache.bucket_width(need, cap) == JaxKV.bucket_width(need, cap)
    for n in (0.5, 1, 1.9, 2, 3, 8, 9.5, 1000):
        assert BlockedKVCache.floor_pow2(n) == JaxKV.floor_pow2(n)


@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)])
def test_block_bytes_and_blocks_for_match_jax(dtypes):
    port = BlockedKVCache(3, 2, 16, num_blocks=4, block_size=8, dtype=dtypes[0])
    ref = JaxKV(3, 2, 16, num_blocks=4, block_size=8, dtype=dtypes[1])
    assert port.block_bytes == ref.block_bytes
    for n in range(0, 40):
        assert port.blocks_for(n) == ref.blocks_for(n)
    # llama3-8b at bs=128 in bf16: 2 pools x 32 layers x 8 heads x 128 x 128 x 2 B
    big = BlockedKVCache(32, 8, 128, num_blocks=1, block_size=128,
                         dtype=torch.bfloat16, device="meta")
    assert big.block_bytes == 2 * 32 * 8 * 128 * 128 * 2


# ---------------------------------------------------------------------------
# the int8 page rows
# ---------------------------------------------------------------------------

def _rows(seed, shape):
    """Random rows at several magnitudes, an all-zero row, and rows holding
    exact half steps of their scale (round half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 30.0], size=shape[:-1] + (1,)).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] = np.arange(shape[-1], dtype=np.float32) - shape[-1] / 2 + 0.5
    x[0, 1, 0] = 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_lanes_match_jax_bytes(dtype):
    x = _rows(0, (3, 5, 16))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(JK.quantize_kv_lanes(jx))
    got = TK.quantize_kv_lanes(tx)
    assert got.dtype == torch.int8 and got.shape == (3, 5, 16 + TK.KV_SCALE_LANES)
    assert TK.KV_SCALE_LANES == JK.KV_SCALE_LANES
    assert got.numpy().tobytes() == want.tobytes()
    assert (got[0, 0] == 0).all()                       # all-zero row: scale 0
    # lanes holding non-finite scales read as 0; finite ones as JAX reads them
    packed = want.copy()
    for i, bad in enumerate((np.nan, np.inf, -np.inf)):
        packed[1, i, -4:] = np.asarray([bad], np.float32).view(np.int8)
    for out_dt in ("float32", "bfloat16"):
        ref = np.asarray(JK.dequantize_kv_lanes(jnp.asarray(packed), out_dt).astype(jnp.float32))
        back = TK.dequantize_kv_lanes(torch.from_numpy(packed), getattr(torch, out_dt)).float()
        np.testing.assert_array_equal(back.numpy(), ref)
        assert (back[1, :3] == 0).all()


# ---------------------------------------------------------------------------
# the page movers
# ---------------------------------------------------------------------------

def _pools(kv_dtype):
    """A JAX and a port cache holding the same random pool bytes."""
    ref = JK.BlockedKVCache(2, 2, 8, num_blocks=9, block_size=4, dtype=jnp.float32,
                            kv_dtype=kv_dtype)
    port = TK.BlockedKVCache(2, 2, 8, num_blocks=9, block_size=4, dtype=torch.float32,
                             device="cpu", kv_dtype=kv_dtype)
    rng = np.random.default_rng(7)
    for name in ("k", "v"):
        x = rng.standard_normal((2, 2, 9, 4, 8)).astype(np.float32)
        pool = np.asarray(JK.quantize_kv_lanes(jnp.asarray(x))) if kv_dtype else x
        setattr(ref, name, jnp.asarray(pool))
        setattr(port, name, torch.from_numpy(pool.copy()))
    return ref, port


def _same_pools(ref, port):
    for name in ("k", "v"):
        assert getattr(port, name).numpy().tobytes() == np.asarray(getattr(ref, name)).tobytes()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_page_movers_match_jax_bytes(kv_dtype):
    ref, port = _pools(kv_dtype)
    assert port.lanes == ref.lanes and port.block_bytes == ref.block_bytes
    ref.k, ref.v = ref.copy_blocks(ref.k, ref.v, [3, 5, 6], [1, 2, 8])
    k, v = port.copy_blocks(port.k, port.v, [3, 5, 6], [1, 2, 8])
    assert k is port.k and v is port.v                  # updated in place
    _same_pools(ref, port)
    want = ref.read_pages([2, 7, 4])
    got = port.read_pages([2, 7, 4])
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.numpy().tobytes() == np.asarray(b).tobytes()
    ref.k, ref.v = ref.scatter_pages(ref.k, ref.v, [5, 6, 3], *want)
    port.scatter_pages(port.k, port.v, [5, 6, 3], *got)
    _same_pools(ref, port)
    table = np.asarray([[1, 2, 0], [8, 5, 3]], np.int32)
    for a, b in zip(port.gather(torch.from_numpy(table)), ref.gather(jnp.asarray(table))):
        assert a.numpy().tobytes() == np.asarray(b).tobytes() and a.shape == b.shape
    if kv_dtype is None:
        rows = np.random.default_rng(9).standard_normal((2, 6, 2, 8)).astype(np.float32)
        tbl = np.asarray([4, 6, 1, 0], np.int32)
        ref.write(jnp.asarray(tbl), 3, jnp.asarray(rows), jnp.asarray(-rows))
        port.write(torch.from_numpy(tbl), 3, torch.from_numpy(rows), torch.from_numpy(-rows))
        _same_pools(ref, port)
    else:
        with pytest.raises(NotImplementedError, match="quantize_kv_lanes"):
            port.write(torch.zeros(4, dtype=torch.int32), 0, torch.zeros(2, 1, 2, 8),
                       torch.zeros(2, 1, 2, 8))
    other = _pools("int8" if kv_dtype is None else None)[1]
    with pytest.raises(ValueError, match="refusing the mixed-dtype"):
        port.scatter_pages(port.k, port.v, [1], *other.read_pages([1]))


def test_int8_block_bytes_match_jax():
    for d, bs in ((64, 16), (128, 128)):
        ref = JK.BlockedKVCache(32, 8, d, num_blocks=2, block_size=bs, kv_dtype="int8")
        port = TK.BlockedKVCache(32, 8, d, num_blocks=2, block_size=bs, device="meta",
                                 kv_dtype="int8")
        assert port.block_bytes == ref.block_bytes
    with pytest.raises(ValueError, match="kv_dtype must be None or 'int8'"):
        TK.BlockedKVCache(1, 1, 8, num_blocks=2, kv_dtype="int4")
