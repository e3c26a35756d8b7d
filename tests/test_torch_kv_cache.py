"""KV cache and allocator of the PyTorch port against the JAX package:
refcounted allocation, trash block 0, and the shape-bucket and byte
arithmetic, which must equal the JAX values exactly."""

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference.v2.kv_cache import BlockedKVCache as JaxKV
from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.kv_cache import BlockedKVCache


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
