"""Speculative decoding of the PyTorch port against the JAX package.

- ``speculative_verify_per_row``: exact on greedy rows (the JAX function's
  counts and replacements); on sampled rows held to its law with a fixed
  generator: the same draws replayed by hand give the same acceptances and
  replacements, and over many rows the first emitted token follows the
  target's distribution.
- serve() with a self-draft and with a distinct 1-layer draft is
  token-identical to JAX's non-speculative greedy serve() and to JAX's
  speculative engine on tests/test_frame_serving.py's SPEC_PROMPTS /
  SPEC_SCHEDULE, with JAX's drafted and accepted counts; forced rejection
  leaves every row at its budget and both pools drained; EOS inside an
  accepted run truncates in-graph; sampled rows complete.
- ``generate_compiled(speculate=True)`` equals JAX's.
- The static-buffer steps (``cuda_graphs=True``, run eagerly on the CPU)
  give the functional loops' tokens, with one key a program shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as JS
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference import sampling as TS
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4)
SPEC_PROMPTS = {u: np.random.default_rng(5).integers(0, 200, (200,)).astype(np.int32)[o:o + n]
                for u, (o, n) in enumerate(((0, 7), (10, 24), (40, 33), (80, 5)))}
SPEC_SCHEDULE = {0: [0, 1], 2: [2], 3: [3]}


def mid_stream():
    for k in range(max(SPEC_SCHEDULE) + 2):
        yield [(u, SPEC_PROMPTS[u]) for u in SPEC_SCHEDULE.get(k, [])]


def all_at_once():
    yield [(u, SPEC_PROMPTS[u]) for u in SPEC_PROMPTS]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """(JAX model, params, port model, params) for the target and for the
    distinct draft (1 layer, fresh weights from key 42)."""
    out = {}
    for name, kw, key in (("target", {}, 0), ("draft", {"num_layers": 1}, 42)):
        jm = jax_build_model("tiny", **kw)
        jp = jm.init(jax.random.PRNGKey(key))
        tm = build_model("tiny", **kw)
        out[name] = (jm, jp, tm, params_from_numpy(tm.cfg, _np(jp), device="cpu"))
    return out


def _jax(models, draft=None):
    jm, jp, _, _ = models["target"]
    e = JaxEngine(jm, JaxConfig(**KW), params=jp, max_seq_len=128)
    if draft is not None:
        dm, dp, _, _ = models[draft] if draft != "self" else models["target"]
        e.attach_draft(dm, dp)
    return e


def _port(models, draft=None, cuda_graphs=None):
    _, _, tm, tp = models["target"]
    e = InferenceEngineV2(tm, RaggedInferenceEngineConfig(**KW), params=tp, max_seq_len=128,
                          device="cpu", cuda_graphs=cuda_graphs)
    if draft is not None:
        _, _, dm, dp = models[draft] if draft != "self" else models["target"]
        e.attach_draft(dm, dp)
    return e


@pytest.fixture(scope="module")
def greedy_base(models):
    """JAX's non-speculative greedy serve() of SPEC_PROMPTS: the tokens
    every speculative run must reproduce."""
    return dict(_jax(models).serve(mid_stream(), max_new_tokens=8))


@pytest.fixture(scope="module")
def jax_spec(models):
    """JAX's speculative serve() (gamma 2) for each draft: outputs in
    retirement order and its ``serve_stats["spec"]``."""
    out = {}
    for draft in ("self", "draft"):
        e = _jax(models, draft)
        got = list(e.serve(mid_stream(), max_new_tokens=8, gamma=2))
        out[draft] = (got, dict(e.serve_stats["spec"]))
    return out


def _drained(e):
    return (e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs
            and e.draft_kv.allocator.free_blocks == e.draft_kv.num_blocks)


def _assert_serves(got, want):
    assert [u for u, _ in got] == [u for u, _ in want], "retirement order"
    for (u, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")


# ---------------------------------------------------------------------------
# the verify
# ---------------------------------------------------------------------------

def _verify_inputs(b=6, g=3, v=11, seed=0):
    rng = np.random.default_rng(seed)
    tl = rng.standard_normal((b, g + 1, v)).astype(np.float32) * 2
    dl = rng.standard_normal((b, g, v)).astype(np.float32) * 2
    toks = tl[:, :g].argmax(-1).astype(np.int32)
    toks[1, 0] = (toks[1, 0] + 1) % v            # reject at 0
    toks[2, 2] = (toks[2, 2] + 3) % v            # reject at 2
    toks[3] = (toks[3] + 1) % v
    tl[4, 1, :] = tl[4, 1].max()                 # ties: the first argmax wins
    toks[4, 1] = 0
    return tl, dl, toks


def test_verify_greedy_rows_match_jax():
    tl, dl, toks = _verify_inputs()
    temps = np.zeros(6, np.float32)
    want = JS.speculative_verify_per_row(jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(toks),
                                         jnp.asarray(temps))
    got = TS.speculative_verify_per_row(torch.from_numpy(tl), torch.from_numpy(dl),
                                        torch.from_numpy(toks), torch.from_numpy(temps))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].tolist() == [3, 0, 2, 0, 3, 3]    # row 4: the tied row accepts its 0
    # a generator changes nothing for greedy rows
    again = TS.speculative_verify_per_row(torch.from_numpy(tl), torch.from_numpy(dl),
                                          torch.from_numpy(toks), torch.from_numpy(temps),
                                          gen=torch.Generator().manual_seed(0))
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_verify_sampled_rows_follow_their_law():
    """Replaying the generator's draws by hand (uniforms for the
    acceptances, then Gumbel noise for the residual draw) gives the same
    counts and replacements, row for row; greedy rows in the batch stay
    exact; and over many rows with one draft token the emitted token is
    distributed as the target's softmax (the property rejection sampling
    exists for)."""
    tl, dl, toks = _verify_inputs(b=8)
    temps = np.asarray([0.7, 1.0, 1.3, 0.0, 0.9, 2.0, 0.0, 1.0], np.float32)
    args = [torch.from_numpy(a) for a in (tl, dl, toks, temps)]
    n_acc, repl = TS.speculative_verify_per_row(*args, gen=torch.Generator().manual_seed(5))
    replay = torch.Generator().manual_seed(5)
    u = torch.rand(toks.shape, generator=replay).numpy()
    gumbel_u = torch.rand((8, 11), generator=replay).clamp_min(
        torch.finfo(torch.float32).tiny).numpy()
    t = np.maximum(temps, 1e-6)[:, None, None]
    p_t, p_d = _softmax(tl / t), _softmax(dl / t)
    g = toks.shape[1]
    for i in range(8):
        if temps[i] <= 0:
            continue
        ok = [u[i, j] * p_d[i, j, toks[i, j]] <= p_t[i, j, toks[i, j]] for j in range(g)]
        k = next((j for j in range(g) if not ok[j]), g)
        assert n_acc[i] == k, i
        res = np.maximum(p_t[i, k] - (p_d[i, k] if k < g else 0.0), 0.0)
        if res.sum() <= 0:
            res = p_t[i, k]
        draw = np.argmax(np.log(res + 1e-30) - np.log(-np.log(gumbel_u[i])))
        assert repl[i] == draw, i
    greedy = JS.speculative_verify_per_row(jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(toks),
                                           jnp.zeros(8))
    for i in (3, 6):
        assert (n_acc[i], repl[i]) == (int(greedy[0][i]), int(greedy[1][i]))

    b, v = 20000, 5
    rng = np.random.default_rng(2)
    tgt = np.broadcast_to(rng.standard_normal((1, 2, v)).astype(np.float32), (b, 2, v)).copy()
    drf = np.broadcast_to(rng.standard_normal((1, 1, v)).astype(np.float32), (b, 1, v)).copy()
    gen = torch.Generator().manual_seed(11)
    q = torch.multinomial(torch.from_numpy(_softmax(drf[0, 0])), b, replacement=True,
                          generator=gen).to(torch.int32)[:, None]
    n, r = TS.speculative_verify_per_row(torch.from_numpy(tgt), torch.from_numpy(drf), q,
                                         torch.ones(b), gen=gen)
    first = torch.where(n > 0, q[:, 0], r).numpy()
    freq = np.bincount(first, minlength=v) / b
    np.testing.assert_allclose(freq, _softmax(tgt[0, 0]), atol=0.015)


# ---------------------------------------------------------------------------
# serve() and generate_compiled()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["self", "draft"])
def test_spec_serve_matches_jax(models, greedy_base, jax_spec, draft):
    """Self-draft (full acceptance) and a distinct 1-layer draft (near zero
    acceptance, so rollback on almost every step): the greedy tokens and
    retirement order of JAX's speculative engine, the tokens of plain
    greedy decoding, JAX's verify, drafted and accepted counts, and both
    pools drained."""
    e = _port(models, draft)
    got = list(e.serve(mid_stream(), max_new_tokens=8, gamma=2))
    want, spec = jax_spec[draft]
    _assert_serves(got, want)
    for u, toks in got:
        np.testing.assert_array_equal(toks, greedy_base[u], err_msg=f"uid={u}")
    sc = e.serve_counters
    assert sc["target_forwards"] == spec["target_forwards"]
    assert sc["accepted_draft_tokens"] == spec["accepted_drafts"]
    assert sc["drafted_tokens"] == 2 * spec["target_forwards"]
    assert (sc["accepted_draft_tokens"] > 0) == (draft == "self")
    assert _drained(e)


def test_spec_forced_rejection_rolls_back_to_budgets(models, greedy_base):
    """All four prompts at once against the random draft: every row gets
    its full budget with the greedy tokens, the pools drain, and the engine
    serves again afterwards."""
    e = _port(models, "draft")
    got = dict(e.serve(all_at_once(), max_new_tokens=8, gamma=2))
    assert sorted(got) == sorted(SPEC_PROMPTS)
    for u in SPEC_PROMPTS:
        assert len(got[u]) == 8
        np.testing.assert_array_equal(got[u], greedy_base[u])
    assert e.serve_counters["accepted_draft_tokens"] < e.serve_counters["drafted_tokens"] / 2
    assert _drained(e)
    again = dict(e.serve(iter([[(0, SPEC_PROMPTS[0])]]), max_new_tokens=4))
    np.testing.assert_array_equal(again[0], greedy_base[0][:4])


@pytest.mark.parametrize("cuda_graphs", [None, True])
def test_spec_in_graph_eos_and_sampled_rows(models, greedy_base, cuda_graphs):
    """An EOS inside an accepted run keeps the EOS and drops the drafted
    tail, in-graph; a sampled row beside a greedy one completes its budget
    (its steps run eagerly by rule) and the greedy row stays exact."""
    e = _port(models, "self", cuda_graphs=cuda_graphs)
    eos = int(greedy_base[0][2])
    stop = greedy_base[0].tolist().index(eos)
    got = dict(e.serve(iter([[(0, SPEC_PROMPTS[0], None, None, eos), (1, SPEC_PROMPTS[1])]]),
                       max_new_tokens=8, gamma=2))
    np.testing.assert_array_equal(got[0], greedy_base[0][:stop + 1])
    if eos not in greedy_base[1].tolist():
        np.testing.assert_array_equal(got[1], greedy_base[1])
    assert e.serve_counters["eos_events"] >= 1
    got = dict(e.serve(iter([[(0, SPEC_PROMPTS[0], None, 0.8), (1, SPEC_PROMPTS[1])]]),
                       max_new_tokens=8, gamma=2, rng=3))
    assert len(got[0]) == 8 and ((got[0] >= 0) & (got[0] < 256)).all()
    np.testing.assert_array_equal(got[1], greedy_base[1])
    assert _drained(e)


def test_spec_generate_compiled_matches_jax(models):
    prompts = [SPEC_PROMPTS[u] for u in sorted(SPEC_PROMPTS)]
    je = _jax(models, "self")
    want = je.generate_compiled(prompts, max_new_tokens=8, speculate=True, gamma=2)
    plain = je.generate_compiled(prompts, max_new_tokens=8, speculate=False)
    for cuda_graphs in (None, True):
        e = _port(models, "self", cuda_graphs=cuda_graphs)
        got = e.generate_compiled(prompts, max_new_tokens=8, gamma=2)
        for a, b, c in zip(got, want, plain):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert _drained(e)
    with pytest.raises(ValueError, match="no draft model is attached"):
        _port(models).generate_compiled(prompts, max_new_tokens=2, speculate=True)


def test_spec_static_steps_match_functional_and_keys(models):
    """The speculative frames on static buffers (the CUDA-graph programs,
    eager on the CPU) give the functional frames' tokens; their keys name
    the program, width, greedy flag, slot shape, gamma and the draft; a
    re-attach drops the speculative graphs; bad arguments raise with JAX's
    messages."""
    func = _port(models, "draft")
    stat = _port(models, "draft", cuda_graphs=True)
    for e in (func, stat):
        e.out = list(e.serve(mid_stream(), max_new_tokens=8, gamma=2))
    _assert_serves(stat.out, func.out)
    keys = stat.runner.graphs.keys()
    spec = [k for k in keys if k[0] == "spec_frame"]
    assert spec and all(k[-2] == 2 and k[-1] == stat.draft_runner.tag for k in spec)
    assert {k[1] for k in spec} == {1, KW["prefill_chunk_size"]}
    assert "frame" not in {k[0] for k in keys}
    with pytest.raises(ValueError, match="gamma >= 1"):
        stat.serve(iter([]), gamma=0)
    with pytest.raises(ValueError, match="attach_draft"):
        _port(models).serve(iter([]), speculate=True)
    with pytest.raises(ValueError, match="vocab_size"):
        stat.attach_draft(build_model("tiny", vocab_size=128))
    e = InferenceEngineV2(models["target"][2], RaggedInferenceEngineConfig(
        **{**KW, "prefill_chunk_size": 1}), device="cpu", max_seq_len=128)
    with pytest.raises(ValueError, match="prefill_chunk_size >= 2"):
        e.attach_draft("tiny")
