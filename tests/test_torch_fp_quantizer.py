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
known-answer vectors of Random123, the reference implementation. The
kernel's integer rule for stochastic rounding (``_stochastic_codes``) is
held byte for byte to the float law (``_stochastic_codes_law``) and to the
neighbour a numpy table picks, at the words on either side of each
threshold, over every f32 exponent and the range edges.
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


def _edge_bits(fmt):
    """f32 bit patterns (uint32) of y across every f32 exponent (0: zero and
    the f32 subnormals; up to 254, far past fmax): each fp8 mantissa pattern
    on top, then below it t = 0, 1, the middle and all ones of the D bits
    under the fp8 mantissa, and two random significands; both signs; then
    NaN, +-inf, +-0 and the magnitudes next to fmax."""
    rng = np.random.default_rng(1)
    mbits = {"e4m3": 3, "e5m2": 2}[fmt]
    d = 23 - mbits
    tops = np.arange(1 << mbits, dtype=np.uint64)
    ts = np.array([0, 1, 1 << (d - 1), (1 << d) - 1], dtype=np.uint64)
    mant = (tops[:, None] << np.uint64(d) | ts[None, :]).ravel()
    exps = np.arange(255, dtype=np.uint64)
    rand = rng.integers(0, 1 << 23, size=(255, 2), dtype=np.uint64)
    bits = np.concatenate([(exps[:, None] << np.uint64(23) | mant[None, :]).ravel(),
                           (exps[:, None] << np.uint64(23) | rand).ravel()])
    fmax_bits = int(np.float32(FMTS[fmt][1]).view(np.uint32))
    extra = [0x7FC00000, 0x7F800001, 0x7F800000, 0, fmax_bits, fmax_bits + 1, fmax_bits - 1,
             fmax_bits + (1 << d), 0x00000001, 0x007FFFFF, 0x00800000]
    bits = np.concatenate([bits, np.array(extra, dtype=np.uint64)])
    bits = np.concatenate([bits, bits | np.uint64(0x80000000)])
    return bits.astype(np.uint32)


@pytest.mark.parametrize("fmt", list(FMTS))
def test_stochastic_integer_rule_is_the_law(fmt):
    """The kernel's integer rule (``_stochastic_codes``) gives the float
    law's bytes, word for word, at every range edge: fp8 subnormals, f32
    subnormals, saturation, +-0, +-inf and NaN, each y with the words whose
    (r >> 8) sits just below and at the threshold ceil(up 2^24) (up from a
    numpy table of the fp8 values, not the port's code) and random words;
    for finite y the code is also the neighbour that threshold picks."""
    rng = np.random.default_rng(2)
    bits = _edge_bits(fmt)
    y = bits.view(np.float32)
    fin = np.isfinite(y)
    grid = _grid(fmt)
    a = np.minimum(np.abs(y[fin]).astype(np.float64), grid[-1])
    hi_i = np.searchsorted(grid, a)
    lo = grid[np.where(grid[np.minimum(hi_i, len(grid) - 1)] == a, hi_i, hi_i - 1)]
    hi = grid[np.minimum(hi_i, len(grid) - 1)]
    up = np.where(hi > lo, (a - lo) / np.where(hi > lo, hi - lo, 1.0), 0.0)
    thr = np.zeros(len(y), dtype=np.int64)
    thr[fin] = np.ceil(up * 2.0 ** 24).astype(np.int64)      # u < up  <=>  (r >> 8) < thr
    words = [np.clip(thr + dt, 0, (1 << 24) - 1) << 8 | rng.integers(0, 256, len(y))
             for dt in (-1, 0)] + [rng.integers(0, 1 << 32, len(y)) for _ in range(2)]
    yy = np.tile(y, len(words))
    r = np.concatenate(words)
    yt, rt = torch.from_numpy(yy), torch.from_numpy(r)
    got = tfp._stochastic_codes(yt, rt, fmt).view(torch.uint8).numpy()
    law = tfp._stochastic_codes_law(yt, rt, fmt).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, law)
    fin4 = np.tile(fin, len(words))
    take_hi = (r >> 8) < np.tile(thr, len(words))
    mag = np.where(take_hi[fin4], np.tile(hi, len(words)), np.tile(lo, len(words)))
    want = (mag.astype(FMTS[fmt][0]).view(np.uint8)
            | np.where(np.signbit(yy[fin4]), 0x80, 0).astype(np.uint8))
    np.testing.assert_array_equal(got[fin4], want)
    # NaN keeps its round-to-nearest code
    nan = np.isnan(yy)
    assert nan.any()
    np.testing.assert_array_equal(got[nan], yt[torch.from_numpy(nan)].to(
        {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[fmt]).view(torch.uint8).numpy())
    # the edges are all there: fp8 subnormals rounded both ways, saturation
    small = fin4 & (np.abs(yy) < grid[1 << {"e4m3": 3, "e5m2": 2}[fmt]]) & (np.abs(yy) > 0)
    assert (take_hi & small).any() and (~take_hi & small).any()
    assert (got[fin4 & (np.abs(yy) > grid[-1])] & 0x7F == (0x7E if fmt == "e4m3" else 0x7B)).all()


@pytest.mark.parametrize("fmt", list(FMTS))
def test_plain_version_rule_matches_law(fmt):
    """``quantize_fp8_plain`` by the integer rule and by the law give the
    same bytes on groups at spread magnitudes (ties and a zero group)."""
    _, xt = _inputs(fmt, "float32")
    q, s = tfp.quantize_fp8_plain(xt, GS, fmt, True, seed=4)
    q_law, s_law = tfp.quantize_fp8_plain(xt, GS, fmt, True, seed=4, law=True)
    assert torch.equal(q.view(torch.uint8), q_law.view(torch.uint8)) and torch.equal(s, s_law)
