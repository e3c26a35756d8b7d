"""fp8 group quantizer of the PyTorch port against the JAX function.

The same numpy inputs go through ``deepspeed_tpu.ops.pallas.fp_quantizer``
(its CPU path, which rounds to nearest) and the port's
``ops/fp_quantizer.py`` on CPU tensors (its plain version). With
``stochastic=False`` the codes must be byte-identical and the f32 scales
bit-identical, in e4m3 and e5m2, from f32 and bf16 inputs: random groups,
an all-zero group, and groups scaled to 1.0 whose values sit exactly halfway
between two fp8 values (round half to even), subnormal ties included.
Stochastic rounding has no JAX oracle off the TPU, so it is held to its law:
every code one of the two fp8 neighbours of x / scale (found here from a
sorted table of every finite fp8 value, not by the port's code), the mean
over 256 seeds unbiased within 4 standard errors, a seed always giving the
same bytes. The Philox generator it draws from is checked against the
known-answer vectors of Random123, the reference implementation.
"""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.pallas import fp_quantizer as jfp
from deepspeed_tpu_torch.ops import fp_quantizer as tfp

FMTS = {"e4m3": (ml_dtypes.float8_e4m3fn, 448.0), "e5m2": (ml_dtypes.float8_e5m2, 57344.0)}
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
GS = 64


def _grid(fmt):
    """Every finite non-negative fp8 value of the format, ascending."""
    np_dt = FMTS[fmt][0]
    vals = np.arange(256, dtype=np.uint8).view(np_dt).astype(np.float64)
    return np.unique(vals[np.isfinite(vals) & (vals >= 0)])


def _ties(fmt, n):
    """n exact midpoints of neighbouring fp8 values (from the subnormals
    up), representable in bf16 and f32, with alternating signs."""
    grid = _grid(fmt)
    mids = (grid[:-1] + grid[1:]) / 2
    mids = mids[np.abs(mids.astype(ml_dtypes.bfloat16).astype(np.float64) - mids) == 0]
    pick = mids[np.linspace(0, len(mids) - 1, n).astype(int)]
    return pick * np.where(np.arange(n) % 2, -1.0, 1.0)


def _inputs(fmt, dtype):
    """Groups of GS: four random at spread magnitudes, one all zero, and
    two of ties whose absmax is fmax (scale exactly 1)."""
    rng = np.random.default_rng(0)
    fmax = FMTS[fmt][1]
    rows = [rng.standard_normal(GS) * np.exp(rng.uniform(-9, 9)) for _ in range(4)]
    rows.append(np.zeros(GS))
    for _ in range(2):
        t = _ties(fmt, GS)
        t[0] = fmax
        rows.append(t)
    x = np.stack(rows).astype(DTYPES[dtype][0])
    return x, torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype][1])


def _bytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fmt", list(FMTS))
def test_round_to_nearest_byte_identical(fmt, dtype):
    xn, xt = _inputs(fmt, dtype)
    jq, js = jfp.quantize_fp8(jnp.asarray(xn), group_size=GS, fmt=fmt, stochastic=False)
    tq, ts = tfp.quantize_fp8(xt, group_size=GS, fmt=fmt, stochastic=False)
    assert tq.shape == xt.shape and tq.dtype == {"e4m3": torch.float8_e4m3fn,
                                                 "e5m2": torch.float8_e5m2}[fmt]
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    jd = jfp.dequantize_fp8(jq, js, group_size=GS)
    td = tfp.dequantize_fp8(tq, ts, group_size=GS)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_ties_round_half_to_even():
    """At scale 1 a tie goes to the neighbour with the even code."""
    grid = _grid("e4m3")
    t = np.abs(_ties("e4m3", GS))
    t[0] = 448.0
    q, s = tfp.quantize_fp8(torch.from_numpy(t.astype(np.float32)), group_size=GS,
                            fmt="e4m3", stochastic=False)
    assert float(s) == 1.0
    codes = q.view(torch.uint8).numpy()[1:]
    lo = np.searchsorted(grid, t[1:]) - 1
    want = np.arange(256, dtype=np.uint8)[:len(grid)][lo + (lo % 2)]
    np.testing.assert_array_equal(codes, want)


def _neighbours(y, fmt):
    grid = _grid(fmt)
    a = np.minimum(np.abs(y), grid[-1])
    hi_i = np.searchsorted(grid, a)
    lo = grid[np.where(grid[np.minimum(hi_i, len(grid) - 1)] == a, hi_i, hi_i - 1)]
    hi = grid[np.minimum(hi_i, len(grid) - 1)]
    return lo, hi


@pytest.mark.parametrize("fmt", list(FMTS))
def test_stochastic_law(fmt):
    xn, xt = _inputs(fmt, "float32")
    q0, s = tfp.quantize_fp8(xt, group_size=GS, fmt=fmt, seed=7)
    y = (xn.astype(np.float32) / s.numpy()).astype(np.float64)   # f32, as the port divides
    lo, hi = _neighbours(y, fmt)
    sign = np.sign(y)
    seeds = 256
    draws = np.stack([tfp.quantize_fp8(xt, group_size=GS, fmt=fmt, seed=sd)[0].float().numpy()
                      for sd in range(seeds)]).astype(np.float64)
    mag = np.abs(draws)
    assert np.all((mag == lo) | (mag == hi)), "a code that is no neighbour of x / scale"
    assert np.all((draws == 0) | (np.sign(draws) == sign))
    p = np.where(hi > lo, (np.abs(y) - lo) / np.where(hi > lo, hi - lo, 1), 0.0)
    expect = sign * (lo + p * (hi - lo))
    se = (hi - lo) * np.sqrt(p * (1 - p) / seeds)
    dev = np.abs(draws.mean(axis=0) - expect)
    assert np.all(dev <= 4 * se + 1e-12 * np.abs(expect)), float((dev / (se + 1e-30)).max())
    # draws are not all rounded the same way: both neighbours occur
    assert ((mag == hi) & (hi > lo)).any() and ((mag == lo) & (hi > lo)).any()
    q1, _ = tfp.quantize_fp8(xt, group_size=GS, fmt=fmt, seed=7)
    np.testing.assert_array_equal(q0.view(torch.uint8).numpy(), q1.view(torch.uint8).numpy())
    q2, _ = tfp.quantize_fp8(xt, group_size=GS, fmt=fmt, seed=8)
    assert (q0.view(torch.uint8) != q2.view(torch.uint8)).any()


def test_stochastic_offset_matches_whole():
    """The plain version on a slice, given the slice's first index, draws
    the bits of the same elements of the whole tensor."""
    x = torch.randn(8 * GS)
    whole, _ = tfp.quantize_fp8_plain(x, GS, "e4m3", True, seed=3)
    part, _ = tfp.quantize_fp8_plain(x[5 * GS:], GS, "e4m3", True, seed=3, index0=5 * GS)
    assert torch.equal(whole[5:].view(torch.uint8), part.view(torch.uint8))


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32-10."""
    def words(c, k):
        return [int(w) for w in tfp.philox4x32_10(*[torch.tensor([v]) for v in c], *k)]
    assert words((0, 0, 0, 0), (0, 0)) == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert words((0xffffffff,) * 4, (0xffffffff, 0xffffffff)) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert words((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
                 (0xa4093822, 0x299f31d0)) == [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]
    assert [int(w) for w in tfp.philox_words(0, torch.arange(4))] == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]


def test_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tfp.quantize_fp8(torch.zeros(100), group_size=64)
    with pytest.raises(ValueError):
        tfp.quantize_fp8(torch.zeros(64), group_size=64, fmt="e3m4")
    with pytest.raises(ValueError):
        tfp.quantize_fp8(torch.zeros(64, device="meta"), group_size=64)
