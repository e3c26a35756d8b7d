"""``serve()`` of the PyTorch port against JAX ``serve()``.

Both engines serve the schedules of tests/test_frame_serving.py (mid-stream
arrivals, in-graph EOS, overload deferral, sampled rows, admission guards,
abandonment) with the same ``tiny`` weights (through the numpy bridge),
``kv_block_size=16``, ``prefill_chunk_size=16``, ``frame_steps=4``, f32.
Greedy outputs must be token-identical and retire in the same order, and
the KV pool must drain. Sampled rows are only checked to complete their
budget: JAX threefry and torch Philox draw different bits.
"""

import dataclasses

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
from deepspeed_tpu_torch.inference.v2.model_runner import PagedModelRunner
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4)


@pytest.fixture(scope="module")
def engines():
    """One engine per package, reused across schedules (serve() leaves an
    engine clean, and the JAX engine keeps its compiled frames)."""
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    je = JaxEngine(jm, JaxConfig(**KW), params=jp, max_seq_len=128)
    tm = build_model("tiny")
    te = InferenceEngineV2(tm, RaggedInferenceEngineConfig(**KW),
                           params=params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                                                    device="cpu"),
                           max_seq_len=128, device="cpu")
    return je, te


def _drained(e):
    return e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs


def _serve_both(engines, arrivals, **kw):
    """Serve the same schedule on both engines; returns both (uid, tokens)
    lists in retirement order after checking they agree exactly."""
    je, te = engines
    want = list(je.serve(arrivals(), **kw))
    got = list(te.serve(arrivals(), **kw))
    assert [u for u, _ in got] == [u for u, _ in want], "retirement order"
    for (u, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    assert _drained(je) and _drained(te)
    return dict(want), dict(got)


def test_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(RaggedInferenceEngineConfig)]
    assert jf == tf


def test_mid_stream_arrivals(engines):
    rng = np.random.default_rng(5)
    prompts = {u: rng.integers(0, 200, (n,)).astype(np.int32)
               for u, n in zip(range(4), (7, 24, 33, 5))}
    schedule = {0: [0, 1], 2: [2], 3: [3]}

    def arrivals():
        for k in range(5):
            yield [(u, prompts[u]) for u in schedule.get(k, [])]

    _, got = _serve_both(engines, arrivals, max_new_tokens=8)
    assert set(got) == set(prompts) and all(len(t) == 8 for t in got.values())


def test_in_graph_eos(engines):
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, 200, (9,)).astype(np.int32),
               1: rng.integers(0, 200, (21,)).astype(np.int32)}
    base, _ = _serve_both(engines, lambda: iter([[(u, prompts[u]) for u in prompts]]),
                          max_new_tokens=8)
    eos = int(base[0][2])
    stop = base[0].tolist().index(eos)
    _, got = _serve_both(
        engines, lambda: iter([[(0, prompts[0], None, None, eos), (1, prompts[1])]]),
        max_new_tokens=8)
    np.testing.assert_array_equal(got[0], base[0][:stop + 1])


def test_overload_deferral(engines):
    rng = np.random.default_rng(7)
    prompts = {u: rng.integers(0, 200, (6 + u,)).astype(np.int32) for u in range(6)}
    _, got = _serve_both(engines, lambda: iter([[(u, prompts[u]) for u in prompts]]),
                         max_new_tokens=5, frame_slots=2)
    assert set(got) == set(prompts) and all(len(v) == 5 for v in got.values())


def test_sampled_row_completes_greedy_row_exact(engines):
    je, te = engines
    rng = np.random.default_rng(8)
    prompts = {0: rng.integers(0, 200, (11,)).astype(np.int32),
               1: rng.integers(0, 200, (17,)).astype(np.int32)}
    batch = [(0, prompts[0], None, 0.8), (1, prompts[1])]
    want = dict(je.serve(iter([batch]), max_new_tokens=6))
    got = dict(te.serve(iter([batch]), max_new_tokens=6, rng=3))
    assert len(got[0]) == 6 and ((got[0] >= 0) & (got[0] < 256)).all()
    np.testing.assert_array_equal(got[1], want[1])
    again = dict(te.serve(iter([batch]), max_new_tokens=6, rng=3))
    np.testing.assert_array_equal(again[0], got[0])     # seeded: reproducible
    assert _drained(te)


def test_admission_guards(engines):
    je, te = engines
    rng = np.random.default_rng(12)
    p = rng.integers(0, 200, (8,)).astype(np.int32)
    for e in engines:
        with pytest.raises(ValueError, match="already live"):
            list(e.serve(iter([[(0, p)], [(0, p)]]), max_new_tokens=64))
        assert _drained(e)
    # 100-token prompt in a 128-token context: budget 64 is clamped to 27
    long_p = rng.integers(0, 200, (100,)).astype(np.int32)
    _, got = _serve_both(engines, lambda: iter([[(0, long_p)]]), max_new_tokens=64)
    assert len(got[0]) == 128 - 100 - 1


def test_abandonment_releases_state(engines):
    je, te = engines
    rng = np.random.default_rng(13)
    prompts = {u: rng.integers(0, 200, (10 + u,)).astype(np.int32) for u in range(4)}
    for e in engines:
        for _uid, _toks in e.serve(iter([[(u, prompts[u]) for u in prompts]]),
                                   max_new_tokens=16):
            break                                   # abandon with 3 in flight
        assert _drained(e)
    _, got = _serve_both(engines, lambda: iter([[(0, prompts[0])]]), max_new_tokens=4)
    assert len(got[0]) == 4


def test_device_defaults_to_cuda(monkeypatch):
    """Without a GPU and without device="cpu", construction raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(build_model("tiny"), RaggedInferenceEngineConfig(**KW))


ENTRY_POINTS = {
    "runner": lambda m: PagedModelRunner(m, 16, 8),
    "init": lambda m: m.init(),
    "params_from_numpy": lambda m: params_from_numpy(
        m.cfg, {k: _numpy(v) for k, v in m.init(device="cpu").items()}),
}


def _numpy(node):
    return {k: _numpy(v) for k, v in node.items()} if isinstance(node, dict) \
        else node.numpy()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """The runner, ``CausalLM.init`` and the weights bridge choose their
    device as the engine does: with no GPU and no device given, they
    raise."""
    model = build_model("tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](model)


# over1 (prefix_cache) and over3 (kv_swap_dir) were ported; the other
# cases keep their ids
@pytest.mark.parametrize("over", [{"tp": 2}, {"role": "prefill"},
                                  {"nonfinite_policy": "repair"}],
                         ids=["over0", "over2", "over4"])
def test_unported_config_raises(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngineV2(build_model("tiny"),
                          RaggedInferenceEngineConfig(**{**KW, **over}), device="cpu")


# kw0 (scheduler) was ported; the other cases keep their ids
@pytest.mark.parametrize("kw", [{"faults": object()}, {"resume_from": {}},
                                {"yield_boundaries": True}],
                         ids=["kw1", "kw2", "kw3"])
def test_unported_serve_options_raise(engines, kw):
    _, te = engines
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.serve(iter([]), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        list(te.serve(iter([[{"uid": 0, "tokens": [1, 2], "deadline_ms": 5.0}]])))
    assert _drained(te)


def test_nonfinite_row_is_quarantined(engines):
    """A row whose logits go non-finite (here: its prompt holds a token
    whose embedding is NaN) is evicted at the frame boundary and logged,
    not yielded; its neighbour is token-identical to a clean run and the
    pool drains."""
    _, te = engines
    rng = np.random.default_rng(14)
    good = rng.integers(0, 200, (12,)).astype(np.int32)
    bad = np.concatenate([rng.integers(0, 200, (9,)), [255]]).astype(np.int32)
    clean = dict(te.serve(iter([[(0, good)]]), max_new_tokens=6))
    tok = te.params["embed"]["tok"]
    saved = tok[255].clone()
    tok[255] = float("nan")
    try:
        got = dict(te.serve(iter([[(0, good), (1, bad)]]), max_new_tokens=6))
    finally:
        tok[255] = saved
    assert set(got) == {0}
    np.testing.assert_array_equal(got[0], clean[0])
    assert te.fault_log[-1].uid == 1 and te.fault_log[-1].kind == "poison_row"
    assert _drained(te)
