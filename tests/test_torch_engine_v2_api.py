"""The v2 step API of the PyTorch port against the JAX engine, and the
static-buffer steps that the port replays from CUDA graphs on the card.

Both engines run the schedules of tests/test_inference_v2.py and
tests/test_frame_serving.py (SplitFuse ``query`` counts over ``step()``,
``can_schedule``, ``flush``, ``generate`` on mixed lengths, its small-pool
degrade, ``generate_compiled``) with the same ``tiny`` weights (through the
numpy bridge), f32: greedy outputs must be token-identical. On the CPU the
port's engine runs its functional loops; ``cuda_graphs=True`` there runs
the static-buffer steps that the card captures, eagerly, and they must give
the functional loops' tokens and pools bit for bit, under keys no more
numerous than the JAX recompile bounds.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4)


@pytest.fixture(scope="module")
def weights():
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _jax(weights, **over):
    return JaxEngine(jax_build_model("tiny"), JaxConfig(**{**KW, **over}),
                     params=weights[0], max_seq_len=128)


def _port(weights, cuda_graphs=None, **over):
    tm = build_model("tiny")
    return InferenceEngineV2(tm, RaggedInferenceEngineConfig(**{**KW, **over}),
                             params=params_from_numpy(tm.cfg, weights[1], device="cpu"),
                             max_seq_len=128, device="cpu", cuda_graphs=cuda_graphs)


@pytest.fixture(scope="module")
def engines(weights):
    """(JAX, port functional, port static-buffer) engines, reused across
    schedules: each schedule flushes what it puts."""
    return _jax(weights), _port(weights), _port(weights, cuda_graphs=True)


def _drained(e):
    return e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 200, (n,)).astype(np.int32) for n in lens]


def test_split_fuse_query_counts(engines):
    """A 40-token prompt over 16-token chunks: pending 40 -> 24 -> 8 -> 0
    over three step() calls, the first token on the third, the same token
    on every engine."""
    (prompt,) = _prompts(2, [40])
    firsts = []
    for e in engines:
        e.put([7], [prompt])
        counts = [e.query(7)[0]]
        for _ in range(3):
            e.step()
            counts.append(e.query(7)[0])
        assert counts == [40, 24, 8, 0]
        assert len(e.query(7)[1]) == 1
        firsts.append(e.query(7)[1])
        e.flush([7])
        assert _drained(e) and e.query(7) == (0, [])
    assert firsts[1] == firsts[0] and firsts[2] == firsts[0]


def test_can_schedule_and_flush(engines):
    for e in engines:
        assert e.can_schedule([1], [32])
        assert not e.can_schedule([1], [100000])
        free0 = e.kv.free_blocks
        e.put([1], [np.arange(40)])
        assert e.kv.free_blocks < free0
        e.flush([1])
        assert e.kv.free_blocks == free0


def test_generate_mixed_lengths_match_one_by_one_and_jax(engines):
    """Prompts of 7, 24 and 50 tokens generate what each generates alone,
    and what the JAX engine generates."""
    je, te, ts = engines
    prompts = _prompts(1, (7, 24, 50))
    want = je.generate(prompts, max_new_tokens=6)
    for e in (te, ts):
        batch = e.generate(prompts, max_new_tokens=6)
        solo = [e.generate([p], max_new_tokens=6)[0] for p in prompts]
        for w, b, s in zip(want, batch, solo):
            np.testing.assert_array_equal(b, w)
            np.testing.assert_array_equal(s, w)
        assert _drained(e)


def test_generate_compiled_matches_generate_and_jax(engines):
    """Lengths that stagger the prefill over the wide steps: the mixed loop
    equals generate() and the JAX engine's generate_compiled(), EOS cut
    on both sides."""
    je, te, ts = engines
    prompts = _prompts(3, (7, 24, 50, 33))
    want = je.generate_compiled(prompts, max_new_tokens=8)
    ref = je.generate(prompts, max_new_tokens=8)
    eos = int(want[2][3])
    want_eos = je.generate_compiled(prompts, max_new_tokens=8, eos_token_id=eos)
    for e in (te, ts):
        got = e.generate_compiled(prompts, max_new_tokens=8)
        steps = e.generate(prompts, max_new_tokens=8)
        for w, r, g, s in zip(want, ref, got, steps):
            np.testing.assert_array_equal(w, r)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(s, w)
        got_eos = e.generate_compiled(prompts, max_new_tokens=8, eos_token_id=eos)
        for w, g in zip(want_eos, got_eos):
            np.testing.assert_array_equal(g, w)
        assert len(got_eos[2]) == 4
        assert _drained(e)


@pytest.mark.parametrize("cuda_graphs", [None, True])
def test_generate_degrades_to_stepwise_on_small_pool(weights, cuda_graphs):
    """A pool of trash + 3 blocks holds the 24-token prompt but not the
    decode loop's 24 + 31 + 1: generate() degrades to step() and returns
    the JAX engine's partial tokens, then the pool drains."""
    (prompt,) = _prompts(11, [24])
    want = _jax(weights, num_kv_blocks=4).generate([prompt], max_new_tokens=32)[0]
    small = _port(weights, cuda_graphs=cuda_graphs, num_kv_blocks=4)
    got = small.generate([prompt], max_new_tokens=32)[0]
    assert 0 < len(got) < 32
    np.testing.assert_array_equal(got, want)
    small.flush(list(small.state.seqs))
    assert _drained(small)


def test_unported_calls_raise(engines):
    """``serve_stats`` is the telemetry's serve view now; ``cancel_request``
    rides the deadline machinery, which is still to be ported."""
    _, te, _ = engines
    assert te.serve_stats is te.telemetry.serve_view
    with pytest.raises(NotImplementedError, match="item 6"):
        te.cancel_request(0)
    assert _drained(te)


def _mid_stream(prompts):
    """tests/test_torch_serve.py's mid-stream arrivals schedule."""
    schedule = {0: [0, 1], 2: [2], 3: [3]}

    def arrivals():
        for k in range(5):
            yield [(u, prompts[u]) for u in schedule.get(k, [])]

    return arrivals


def test_static_steps_match_functional_loops_bit_for_bit(weights):
    """serve() with mid-stream arrivals, then step(), generate() and
    generate_compiled(), on two engines from the same weights and zero
    pools: the static-buffer steps give the functional loops' tokens,
    retirement order and pools bit for bit."""
    prompts = dict(enumerate(_prompts(5, (7, 24, 33, 5))))
    eng = [_port(weights), _port(weights, cuda_graphs=True)]
    outs = []
    for e in eng:
        served = list(e.serve(_mid_stream(prompts)(), max_new_tokens=8))
        e.put([9], [prompts[1]])
        stepped = [e.step() for _ in range(4)]
        e.flush([9])
        gen = e.generate(list(prompts.values()), max_new_tokens=5)
        comp = e.generate_compiled(list(prompts.values()), max_new_tokens=5)
        outs.append((served, stepped, gen, comp))
        assert _drained(e)
    (s0, st0, g0, c0), (s1, st1, g1, c1) = outs
    assert [u for u, _ in s1] == [u for u, _ in s0]
    for (_, a), (_, b) in zip(s0, s1):
        np.testing.assert_array_equal(b, a)
    assert st1 == st0
    for a, b in zip(g0 + c0, g1 + c1):
        np.testing.assert_array_equal(b, a)
    assert torch.equal(eng[1].kv.k, eng[0].kv.k) and torch.equal(eng[1].kv.v, eng[0].kv.v)
    assert eng[0].runner.graphs is None and eng[1].runner.graphs.keys()


def _programs(e, name):
    return [k for k in e.runner.graphs.keys() if k[0] == name]


def test_step_keys_within_jax_recompile_bound(weights):
    """tests/test_frame_serving.py:159's sweep (one arrival a step, the
    decode batch ramping 1..7): the per-chunk keys stay within JAX's
    bound, a chunk-16 program at padded B 1 and chunk-1 programs at padded
    B 1, 2, 4, 8."""
    e = _port(weights, cuda_graphs=True)
    rng = np.random.default_rng(9)
    for u in range(7):
        e.put([u], [rng.integers(0, 200, (5,)).astype(np.int32)])
        e.step()
    for _ in range(4):
        e.step()
    runs = _programs(e, "run")
    assert len(runs) <= 5, runs
    assert sum(k[2] == 16 for k in runs) <= 1 and sum(k[2] == 1 for k in runs) <= 4, runs
    assert sorted({k[1] for k in runs if k[2] == 1}) == [1, 2, 4, 8]


def test_frame_keys_within_jax_recompile_bound(weights):
    """tests/test_frame_serving.py:185's schedule (staggered lengths force
    prompt-width regrowth and mixed frames): at most 6 frame keys, one
    more serve() of the same shapes captures none."""
    e = _port(weights, cuda_graphs=True)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 200, (4 + 7 * k,)).astype(np.int32) for k in range(8)]

    def arrivals():
        for k in range(8):
            yield [(k, prompts[k])]

    got = dict(e.serve(arrivals(), max_new_tokens=6))
    assert len(got) == 8
    frames = _programs(e, "frame")
    assert len(frames) <= 6, frames
    again = dict(e.serve(arrivals(), max_new_tokens=6))
    assert _programs(e, "frame") == frames
    for u in got:
        np.testing.assert_array_equal(again[u], got[u])
    assert _drained(e)
