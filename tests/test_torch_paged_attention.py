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
