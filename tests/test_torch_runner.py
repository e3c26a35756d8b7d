"""Paged runner of the PyTorch port against the JAX runner.

The same weights (through the numpy bridge), block tables, pools and
chunks go through ``deepspeed_tpu``'s ``PagedModelRunner`` (on the CPU it
takes its XLA gather path) and the port's runner (on CPU tensors its
attention is the plain version). f32; logits to atol 1e-4 (a two-layer
forward of f32 products summed in another order), committed pool slots
to 1e-5, and a whole greedy frame token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.model_runner import PagedModelRunner as JaxRunner
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2.model_runner import PagedModelRunner
from deepspeed_tpu_torch.inference.v2.telemetry import zero_stats
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

BS, NB, MB = 8, 12, 4
TABLES = np.array([[3, 5, 1, 7], [2, 9, 0, 0], [4, 6, 8, 10]], np.int32)


@pytest.fixture(scope="module", params=["tiny", "tiny-gpt2"])
def pair(request):
    name = request.param
    jm = jax_build_model(name, dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(name, dtype="float32")
    tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return (JaxRunner(jm, BS, MB), jp), (PagedModelRunner(tm, BS, MB, device="cpu"), tp)


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.kv_heads, NB, BS, cfg.dims_per_head)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# decode: rows at positions 20 and 7 around a frozen row; prefill: a chunk
# after a 5-token cached prefix, an all-pad row, a 3-token chunk from 0
CHUNKS = {
    "decode": ([[20], [-1], [7]], [1, 0, 1]),
    "prefill": ([list(range(5, 13)), [-1] * 8, [0, 1, 2] + [-1] * 5], [8, 0, 3]),
}


@pytest.mark.parametrize("mode", sorted(CHUNKS))
def test_forward_matches_jax_run(pair, mode):
    (jr, jp), (tr, tp) = pair
    cfg = tr.cfg
    pos = np.asarray(CHUNKS[mode][0], np.int32)
    valid = np.asarray(CHUNKS[mode][1], np.int32)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, pos.shape).astype(np.int32)
    kp, vp = _pools(cfg, 2)
    jl, jk, jv = jr.run(pos.shape[1], jp, jnp.asarray(ids), jnp.asarray(pos),
                        jnp.asarray(TABLES), jnp.asarray(valid),
                        jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = tr.run(tp, torch.from_numpy(ids), torch.from_numpy(pos),
                          torch.from_numpy(TABLES), torch.from_numpy(valid), tk, tv)
    assert tk2 is tk and tv2 is tv                     # committed in place
    live = valid > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=1e-4, rtol=0)
    # every block but trash block 0 (pad rows' writes land there) holds the
    # same KV: the chunk's slots written, the rest untouched
    np.testing.assert_allclose(tk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:], atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, :, 1:], np.asarray(jv)[:, :, 1:], atol=1e-5)
    for b, row in enumerate(pos):
        for p in row[row >= 0]:
            blk, off = TABLES[b, p // BS], p % BS
            assert not np.allclose(tk.numpy()[:, :, blk, off], kp[:, :, blk, off])


def test_frame_loop_matches_jax(pair):
    """One greedy frame from the same carry: three live rows (one
    finishing its prompt mid-frame, one hitting its limit) and a free
    slot; identical tokens, emit masks, stats and carry."""
    (jr, jp), (tr, tp) = pair
    cfg = tr.cfg
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    carry = dict(
        prompt_lens=np.array([5, 12, 3, 0], np.int32),
        limits=np.array([4, 3, 6, 0], np.int32),
        eos_ids=np.full(4, -1, np.int32),
        temps=np.zeros(4, np.float32),
        tables=np.vstack([TABLES, np.zeros((1, MB), np.int32)]),
        cached=np.zeros(4, np.int32), produced=np.zeros(4, np.int32),
        last_tok=np.zeros(4, np.int32),
        done=np.array([False, False, False, True]),
        poison=np.zeros(4, bool), nonfinite=np.zeros(4, bool))
    order = ["prompt_lens", "limits", "eos_ids", "temps", "tables", "cached",
             "produced", "last_tok", "done", "poison", "nonfinite"]
    kp = np.zeros((cfg.num_layers, cfg.kv_heads, NB, BS, cfg.dims_per_head), np.float32)
    jout = jr.frame_loop(jp, jnp.asarray(prompts), *[jnp.asarray(carry[k]) for k in order],
                         jnp.zeros((7,), jnp.int32), jax.random.PRNGKey(0),
                         jnp.asarray(kp), jnp.asarray(kp), width=8, steps=6,
                         greedy=True)
    tout = tr.frame_loop(tp, torch.from_numpy(prompts),
                         *[torch.from_numpy(carry[k]) for k in order],
                         zero_stats(), torch.Generator().manual_seed(0),
                         torch.from_numpy(kp.copy()), torch.from_numpy(kp.copy()),
                         width=8, steps=6, greedy=True)
    names = ["toks", "emit", "cached", "produced", "last_tok", "done", "poison",
             "nonfinite", "stats"]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]), err_msg=name)
    assert np.asarray(jout[1]).sum() == 4 + 3 + 6        # every budget emitted


def _runner(tr, static):
    """The port runner, or one that runs the static-buffer steps (what the
    card replays from CUDA graphs) eagerly on the CPU."""
    if not static:
        return tr
    return PagedModelRunner(tr.model, BS, MB, device="cpu", cuda_graphs=True)


def _committed(pool):
    """Every block but trash block 0 (pad rows' writes land there)."""
    return np.asarray(pool)[:, :, 1:]


@pytest.mark.parametrize("static", [False, True], ids=["functional", "static"])
def test_decode_loop_matches_jax(pair, static):
    """Six greedy decode steps from cached prefixes of 20, 7 and 3 tokens
    over random pools: identical tokens, committed slots to 1e-5."""
    (jr, jp), (tr, tp) = pair
    tr = _runner(tr, static)
    cfg = tr.cfg
    last = np.random.default_rng(5).integers(0, cfg.vocab_size, (3,)).astype(np.int32)
    lens = np.array([20, 7, 3], np.int32)
    kp, vp = _pools(cfg, 6)
    jt, jk, jv = jr.decode_loop(jp, jnp.asarray(last), jnp.asarray(lens), jnp.asarray(TABLES),
                                jnp.asarray(kp), jnp.asarray(vp), jax.random.PRNGKey(0),
                                jnp.float32(0.0), steps=6, greedy=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tt, tk2, tv2 = tr.decode_loop(tp, torch.from_numpy(last), torch.from_numpy(lens),
                                  torch.from_numpy(TABLES), tk, tv, torch.Generator(), 0.0,
                                  steps=6, greedy=True)
    assert tk2 is tk and tv2 is tv
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(_committed(tk), _committed(jk), atol=1e-5)
    np.testing.assert_allclose(_committed(tv), _committed(jv), atol=1e-5)


@pytest.mark.parametrize("static", [False, True], ids=["functional", "static"])
def test_mixed_loop_matches_jax(pair, static):
    """Prompts of 5, 12 and 3 tokens at chunk 8 (two wide steps; the short
    rows decode inside them), limits 4, 3 and 6, then five narrow steps:
    identical tokens and emit masks, committed slots to 1e-5."""
    (jr, jp), (tr, tp) = pair
    tr = _runner(tr, static)
    cfg = tr.cfg
    plens = np.array([5, 12, 3], np.int32)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    limits = np.array([4, 3, 6], np.int32)
    kp = np.zeros((cfg.num_layers, cfg.kv_heads, NB, BS, cfg.dims_per_head), np.float32)
    kw = dict(chunk=8, wide_steps=2, narrow_steps=5, greedy=True)
    jt, je, jk, jv = jr.mixed_loop(jp, jnp.asarray(prompts), jnp.asarray(plens),
                                   jnp.asarray(limits), jnp.asarray(kp), jnp.asarray(kp),
                                   jnp.asarray(TABLES), jax.random.PRNGKey(0),
                                   jnp.float32(0.0), **kw)
    tt, te, tk, tv = tr.mixed_loop(tp, torch.from_numpy(prompts), torch.from_numpy(plens),
                                   torch.from_numpy(limits), torch.from_numpy(kp.copy()),
                                   torch.from_numpy(kp.copy()), torch.from_numpy(TABLES),
                                   torch.Generator(), 0.0, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.numpy().sum(axis=0).tolist() == limits.tolist()     # every budget emitted
    np.testing.assert_allclose(_committed(tk), _committed(jk), atol=1e-5)
    np.testing.assert_allclose(_committed(tv), _committed(jv), atol=1e-5)
