"""Quantized serving of the PyTorch port against the JAX package: int8
weight leaves and serve() with int8 weights, int8 KV pages or both (the
page rows and the page movers are held in tests/test_torch_kv_cache.py).

- ``quantize_params``: every leaf byte-identical to JAX's; the leaves JAX
  skips (norms, a tied head, an MoE stack by its ``router`` key) are
  untouched; ``quantized_param_bytes`` equal.
- serve(): an int8-KV engine is greedy token-identical to JAX's int8-KV
  engine and to the float engine (JAX's contract for write-once int8
  pages); an int8-weight engine is token-identical to JAX's int8-weight
  engine, also when it serves a tree JAX quantized; the static-buffer
  steps (``cuda_graphs=True``, run eagerly on the CPU) give the same.
- The config checks raise with JAX's messages.

Both packages serve ``tiny`` in f32 with the weights of
``tests/test_quantized_serving.py`` (8 heads), through the numpy bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.model_implementations import quantize as JQ
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import quantize as TQ
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
MAX_NEW = 8
PROMPTS = {u: np.random.default_rng(5).integers(0, 200, (200,)).astype(np.int32)[o:o + n]
           for u, (o, n) in enumerate(((0, 7), (10, 24), (40, 33), (80, 5)))}
SCHEDULE = {0: [0, 1], 2: [2], 3: [3]}


def arrivals():
    """tests/test_frame_serving.py's mid-stream schedule."""
    for k in range(max(SCHEDULE) + 2):
        yield [(u, PROMPTS[u]) for u in SCHEDULE.get(k, [])]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _same_tree(port, ref, path=""):
    """Every leaf of ``port`` (torch) equals ``ref`` (JAX) in shape, dtype
    and bytes."""
    assert set(port) == set(ref), path
    for k, v in port.items():
        if isinstance(v, dict):
            _same_tree(v, ref[k], f"{path}.{k}")
            continue
        want = np.asarray(ref[k])
        got = v.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f"{path}.{k}"
        assert got.tobytes() == want.tobytes(), f"{path}.{k}"


@pytest.fixture(scope="module")
def weights():
    jm = jax_build_model("tiny", num_heads=8)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model("tiny", num_heads=8)
    return jm, jp, tm, params_from_numpy(tm.cfg, _np(jp), device="cpu")


def _jax(weights, **over):
    jm, jp, _, _ = weights
    return JaxEngine(jm, JaxConfig(**{**KW, **over}), params=jp, max_seq_len=128)


def _port(weights, params=None, cuda_graphs=None, **over):
    _, _, tm, tp = weights
    return InferenceEngineV2(tm, RaggedInferenceEngineConfig(**{**KW, **over}),
                             params=tp if params is None else params, max_seq_len=128,
                             device="cpu", cuda_graphs=cuda_graphs)


@pytest.fixture(scope="module")
def served(weights):
    """JAX serve() outputs in retirement order: the float engine and each
    quantized one."""
    return {name: list(_jax(weights, **over).serve(arrivals(), max_new_tokens=MAX_NEW))
            for name, over in (("float", {}), ("kv", {"kv_dtype": "int8"}),
                               ("weights", {"weight_dtype": "int8"}))}


def _drained(e):
    return e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs


def _assert_serves(got, want):
    assert [u for u, _ in got] == [u for u, _ in want], "retirement order"
    for (u, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")


# ---------------------------------------------------------------------------
# weight leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2"])
def test_quantize_params_matches_jax(preset):
    """Leaf by leaf, the port's int8 leaves and scales are JAX's bytes; the
    leaves JAX keeps (norms, embeddings, biases, a tied head) are the same
    tensors, untouched; the byte counts agree."""
    jm = jax_build_model(preset)
    jp = jm.init(jax.random.PRNGKey(3))
    want, _ = JQ.quantize_params(jp, jm.logical_axes())
    tm = build_model(preset)
    tp = _torch(_np(jp))
    assert tm.logical_axes() == jax.tree.map(lambda a: a, jm.logical_axes(),
                                             is_leaf=lambda x: isinstance(x, tuple))
    got, specs = TQ.quantize_params(tp, tm.logical_axes())
    assert specs is None
    _same_tree(got, want)
    assert got["final_norm"]["scale"] is tp["final_norm"]["scale"]
    assert got["embed"]["tok"] is tp["embed"]["tok"]
    assert isinstance(got["layers"]["attn"]["wq"], dict)
    assert ("lm_head" in got["embed"]) == (not tm.cfg.tie_embeddings)
    assert TQ.quantized_param_bytes(got) == JQ.quantized_param_bytes(want)
    # in place: the same tree, its float leaves replaced
    inplace, _ = TQ.quantize_params(tp, tm.logical_axes(), inplace=True)
    assert inplace is tp
    _same_tree(inplace, want)


def test_quantize_params_skips_router_stacks_and_checks_its_arguments():
    rng = np.random.default_rng(1)
    tree = {"layers": {"mlp": {"router": rng.standard_normal((2, 8, 4)).astype(np.float32),
                               "wi_gate": rng.standard_normal((2, 4, 8, 16)).astype(np.float32)},
                       "attn": {"wq": rng.standard_normal((2, 8, 2, 4)).astype(np.float32)}}}
    axes = {"layers": {"mlp": {"router": ("layers", "embed", "expert"),
                               "wi_gate": ("layers", "expert", "embed", "mlp")},
                       "attn": {"wq": ("layers", "embed", "heads", "head_dim")}}}
    want, _ = JQ.quantize_params(jax.tree.map(jnp.asarray, tree), axes)
    got, _ = TQ.quantize_params(_torch(tree), axes)
    _same_tree(got, want)
    assert not isinstance(got["layers"]["mlp"]["wi_gate"], dict)
    with pytest.raises(ValueError, match="weight_dtype must be 'int8'"):
        TQ.quantize_params(_torch(tree), axes, weight_dtype="fp8")
    # with a tensor-parallel spec tree (each leaf's split dim) the specs come
    # back jointly: q keeps the weight's dim, the scale drops a contracted one
    specs = {"layers": {"mlp": {"router": None, "wi_gate": 3}, "attn": {"wq": 2}}}
    got, qspecs = TQ.quantize_params(_torch(tree), axes, specs=specs)
    _same_tree(got, want)
    assert qspecs == {"layers": {"mlp": {"router": None, "wi_gate": 3},
                                 "attn": {"wq": {"q": 2, "s": 2}}}}


# ---------------------------------------------------------------------------
# the int8-KV attention route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvh,window,alibi,softcap", [(2, None, False, 0.0), (8, 5, False, 0.0),
                                                      (1, None, True, 0.0), (4, 0, False, 30.0)])
def test_gather_route_attention_matches_jax(kvh, window, alibi, softcap):
    """The port's ``_paged_attention`` (the int8-KV route's attention over
    dequantized pages, with the chunk's own KV beside them) against JAX's,
    with GQA (8 query heads over 1, 2 or 4 kv heads), MHA with a window,
    ALiBi and a softcap; pad rows, rows at other offsets and stale pool
    slots included."""
    from deepspeed_tpu.inference.v2.model_runner import _paged_attention as jax_attn
    from deepspeed_tpu.models import layers as JL
    from deepspeed_tpu_torch.inference.v2.model_runner import _paged_attention
    cfg = jax_build_model("tiny", num_heads=8, num_kv_heads=kvh, attn_softcap=softcap).cfg
    rng = np.random.default_rng(4)
    b, c, s_pad, d = 3, 4, 16, 16
    q = rng.standard_normal((b, c, 8, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((b, s_pad, kvh, d)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.standard_normal((b, c, kvh, d)).astype(np.float32) for _ in range(2))
    positions = np.asarray([[5, 6, 7, 8], [11, 12, -1, -1], [-1, -1, -1, -1]], np.int32)
    chunk_start = np.asarray([5, 11, 1 << 30], np.int32)
    slopes = JL.alibi_slopes(8) if alibi else None
    want = jax_attn(*(jnp.asarray(a) for a in (q, kp, vp, positions)), cfg, window=window,
                    chunk_k=jnp.asarray(ck), chunk_v=jnp.asarray(cv),
                    chunk_start=jnp.asarray(chunk_start), alibi_slopes=slopes)
    got = _paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, positions)), cfg,
                           window=window, chunk_k=torch.from_numpy(ck),
                           chunk_v=torch.from_numpy(cv), chunk_start=torch.from_numpy(chunk_start),
                           alibi_slopes=None if slopes is None else torch.tensor(
                               np.asarray(slopes)))
    np.testing.assert_allclose(got.numpy()[positions >= 0], np.asarray(want)[positions >= 0],
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# serve()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuda_graphs", [None, True])
def test_int8_kv_serve_matches_jax_and_float(weights, served, cuda_graphs):
    """int8 KV pages are write-once, so greedy serving is token-identical
    to JAX's int8-KV engine and to the float engine; no pool holds a float
    row, and the pool drains."""
    e = _port(weights, cuda_graphs=cuda_graphs, kv_dtype="int8")
    assert e.kv.k.dtype == torch.int8 and e.kv.lanes == e.kv.head_dim + 4
    got = list(e.serve(arrivals(), max_new_tokens=MAX_NEW))
    _assert_serves(got, served["kv"])
    _assert_serves(got, served["float"])
    assert _drained(e)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_int8_weight_serve_matches_jax(weights, served, source):
    """An int8-weight engine (the port quantizing its float params, or
    serving the tree JAX quantized) is token-identical to JAX's."""
    jm, jp, tm, tp = weights
    params = None
    if source == "jax":
        jq, _ = JQ.quantize_params(jp, jm.logical_axes())
        params = params_from_numpy(tm.cfg, _np(jq), device="cpu")
        assert params["layers"]["mlp"]["wi_gate"]["q"].dtype == torch.int8
    e = _port(weights, params=params, weight_dtype="int8")
    want, _ = JQ.quantize_params(jp, jm.logical_axes())
    _same_tree(e.params, want)
    _assert_serves(list(e.serve(arrivals(), max_new_tokens=MAX_NEW)), served["weights"])
    assert _drained(e)


def test_both_int8_serve_with_static_steps_matches_functional(weights):
    """int8 weights and int8 pages together: the static-buffer steps (the
    CUDA-graph programs, run eagerly on the CPU) give the functional
    loop's tokens."""
    got = {cg: list(_port(weights, cuda_graphs=cg, weight_dtype="int8", kv_dtype="int8")
                    .serve(arrivals(), max_new_tokens=MAX_NEW)) for cg in (None, True)}
    _assert_serves(got[True], got[None])
    assert sorted(u for u, _ in got[None]) == sorted(PROMPTS)


@pytest.mark.parametrize("bad", [{"kv_dtype": "int4"}, {"weight_dtype": "fp4"},
                                 {"tp_collective_payload": "int4"}])
def test_config_validation_messages_match_jax(weights, bad):
    with pytest.raises(ValueError) as ref:
        _jax(weights, **bad)
    with pytest.raises(ValueError) as got:
        _port(weights, **bad)
    assert str(got.value) == str(ref.value)
