"""The v1 inference path of the PyTorch port against the JAX package.

A JAX engine (``deepspeed_tpu.init_inference`` on a one-device mesh) and a
port engine (``deepspeed_tpu_torch.init_inference(..., device="cpu")``)
hold the same weights: the JAX engine's parameters, converted by
``module_inject.params_from_numpy``. f32 throughout.

- ``generate``: greedy token-identical, B = 2, prompt 8, 8 new tokens,
  without and with ``eos_token_id`` (an EOS met mid-way, and one equal to a
  row's first new token, which JAX never checks);
- ``apply_decode``: logits after a prefill and after single-token steps,
  and the cache contents, within rtol 1e-5 for ``tiny`` and for variants
  that take the other branches of the decode layer (learned positions and
  biases, ALiBi, a sliding window, softcaps, parallel and sandwich blocks);
- ``forward`` against JAX ``apply``;
- ``sample_logits``: top_k = 1 is greedy, draws stay in the top-k and
  top-p sets;
- the config (aliases, defaults, dtype rewriting) and the
  ``NotImplementedError``s of what is not ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.sampling import sample_logits
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

RTOL = 1e-5


def _one_device_mesh():
    groups.set_mesh(groups.build_mesh(devices=jax.devices()[:1], data=1))


def _prompts(seed=0, b=2, s=8):
    return np.random.default_rng(seed).integers(0, 200, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over the same tiny weights, and the JAX
    engine's greedy continuation of the default prompts."""
    _one_device_mesh()
    jeng = jds.init_inference(jax_build_model("tiny"), dtype="float32")
    params = params_from_numpy(build_model("tiny").cfg,
                               jax.tree.map(np.asarray, jeng.module_params), device="cpu")
    teng = tds.init_inference(build_model("tiny"), dtype="float32", device="cpu",
                              params=params)
    return jeng, teng, np.asarray(jeng.generate(_prompts(), max_new_tokens=8))


@pytest.mark.parametrize("eos", ["none", "mid", "first"])
def test_generate_greedy_token_identical(engines, eos):
    jeng, teng, greedy = engines
    ids = _prompts()
    eos_id = {"none": None, "mid": int(greedy[0, 8 + 3]), "first": int(greedy[1, 8])}[eos]
    want = np.asarray(jeng.generate(ids, max_new_tokens=8, eos_token_id=eos_id))
    got = teng.generate(ids, max_new_tokens=8, eos_token_id=eos_id)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos == "first":
        # the first new token is not checked against EOS: row 1 goes on
        assert got[1, 8] == eos_id and (got[1, 9:] != eos_id).any()
    d = teng.generate(ids, max_new_tokens=8, eos_token_id=eos_id, return_dict=True)
    np.testing.assert_array_equal(d["sequences"].numpy(), want)
    np.testing.assert_array_equal(d["new_tokens"].numpy(), want[:, 8:])


def test_forward_matches_jax_apply(engines):
    jeng, teng, _ = engines
    ids = _prompts(seed=1, s=12)
    np.testing.assert_allclose(teng.forward(ids).numpy(), np.asarray(jeng.forward(ids)),
                               rtol=RTOL, atol=1e-5)


VARIANTS = {
    "tiny": ("tiny", {}),
    "gpt2_learned_bias": ("tiny-gpt2", {}),
    "alibi": ("tiny", dict(position="alibi")),
    "window_softcap": ("tiny", dict(sliding_window=4, attn_softcap=20.0, logit_softcap=30.0)),
    "parallel_sandwich_gqa": ("tiny", dict(parallel_block=True, sandwich_norm=True,
                                           num_kv_heads=2)),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_apply_decode_matches_jax(name):
    preset, over = VARIANTS[name]
    jmodel, model = jax_build_model(preset, **over), build_model(preset, **over)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = params_from_numpy(model.cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ids = _prompts(seed=2, s=9)
    jcache, cache = jmodel.init_cache(2, 12), model.init_cache(2, 12, device="cpu")
    jlen = jnp.zeros((2,), jnp.int32)
    tlen = torch.zeros((2,), dtype=torch.int32)
    # a 6-token prefill, then three single-token steps
    for a, b in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jl, jcache = jmodel.apply_decode(jparams, jnp.asarray(ids[:, a:b]), jcache, jlen)
        tl, cache = model.apply_decode(params, torch.from_numpy(ids[:, a:b]), cache, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=1e-5)
        jlen, tlen = jlen + (b - a), tlen + (b - a)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=RTOL, atol=1e-5)
    last, _ = model.apply_decode(params, torch.from_numpy(ids[:, :2]), cache, tlen,
                                 last_only=True)
    assert last.shape == (2, 1, model.cfg.vocab_size)


def test_sample_logits_controls():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = sample_logits(logits, gen, greedy=True)
    assert torch.equal(sample_logits(logits, gen, temperature=0.7, top_k=1), greedy)
    assert torch.equal(sample_logits(logits, gen, temperature=0.0), greedy)
    top5 = logits.topk(5, dim=-1).indices
    for _ in range(4):
        tok = sample_logits(logits, gen, temperature=1.3, top_k=5)
        assert (top5 == tok[:, None].long()).any(dim=-1).all()
    probs = torch.softmax(logits / 0.8, dim=-1)
    sp, order = probs.sort(dim=-1, descending=True)
    keep = (sp.cumsum(-1) - sp) < 0.6               # the prefix that reaches top_p, inclusive
    for _ in range(4):
        tok = sample_logits(logits, gen, temperature=0.8, top_p=0.6).long()
        rank = (order == tok[:, None]).float().argmax(dim=-1)
        assert keep.gather(-1, rank[:, None]).all()
    assert sample_logits(logits, gen, top_k=3).dtype == torch.int32


def test_static_decode_step_matches_eager_loop(engines):
    """``cuda_graphs=True`` on the CPU runs the decode step the card
    replays from a CUDA graph, eagerly on its static cache and state: the
    eager loop's tokens with and without EOS, sampled tokens from the same
    seed, and a second shape that replaces the static buffers."""
    _, teng, greedy = engines
    static = tds.init_inference(build_model("tiny"), dtype="float32", device="cpu",
                                params=teng.module_params, cuda_graphs=True)
    assert teng.graphs is None and static.graphs is not None
    ids = _prompts()
    calls = [dict(), dict(eos_token_id=int(greedy[0, 8 + 3])),
             dict(temperature=0.8, top_k=10, seed=3), dict()]
    for kw in calls:
        np.testing.assert_array_equal(static.generate(ids, max_new_tokens=8, **kw).numpy(),
                                      teng.generate(ids, max_new_tokens=8, **kw).numpy())
    longer = _prompts(seed=4, b=3, s=11)
    np.testing.assert_array_equal(static.generate(longer, max_new_tokens=5).numpy(),
                                  teng.generate(longer, max_new_tokens=5).numpy())
    assert [k[1:] for k in static.graphs.keys()] == [
        (2, 16, True, False), (2, 16, True, True), (2, 16, False, False), (3, 16, True, False)]


def test_sampled_generate_runs_and_is_seeded(engines):
    teng = engines[1]
    ids = _prompts()
    a = teng.generate(ids, max_new_tokens=5, temperature=0.8, top_k=10, top_p=0.9, seed=7)
    b = teng.generate(ids, max_new_tokens=5, temperature=0.8, top_k=10, top_p=0.9, seed=7)
    assert a.shape == (2, 13) and torch.equal(a, b)
    np.testing.assert_array_equal(a[:, :8].numpy(), ids)


def test_config_matches_jax():
    assert tds.default_inference_config() == jds.default_inference_config()
    kw = dict(max_out_tokens=77, ds_config={"a": 1}, tensor_parallel={"tp_size": 1},
              mp_size=1, dtype="torch.float16", quant={"bits": 4})
    t, j = DeepSpeedInferenceConfig.from_dict(kw), JaxInferenceConfig(**kw)
    assert (t.max_tokens, t.checkpoint_config, t.quant.bits, t.tp_size_effective) == (
        j.max_tokens, j.checkpoint_config, j.quant.bits, j.tp_size_effective)
    assert DeepSpeedInferenceConfig.from_dict({"mp_size": 3}).tp_size_effective == 3


@pytest.mark.parametrize("dtype,want", [("torch.float32", "float32"), ("half", "float16"),
                                        (torch.bfloat16, "bfloat16")])
def test_dtype_override(dtype, want):
    eng = tds.init_inference("tiny", dtype=dtype, device="cpu")
    assert eng.model.cfg.dtype == want
    leaf = eng.module_params["layers"]["attn"]["wq"]
    assert leaf.dtype == getattr(torch, want) and leaf.device.type == "cpu"
    assert set(eng.module_state_dict()) == {"embed", "layers", "final_norm"}


class _HFLike:
    config = object()

    def state_dict(self):
        return {}


@pytest.mark.parametrize("case", ["tp", "mp", "checkpoint", "hf_module", "moe"])
def test_not_ported_raises(case):
    kw = {"tp": dict(tensor_parallel={"tp_size": 2}), "mp": dict(mp_size=2),
          "checkpoint": dict(checkpoint="some/dir")}.get(case, {})
    model = {"hf_module": _HFLike(), "moe": "tiny-moe"}.get(case, "tiny")
    with pytest.raises(NotImplementedError, match="ROADMAP.md section A, item"):
        tds.init_inference(model, device="cpu", **kw)


@pytest.mark.parametrize("entry", ["init_inference", "engine", "init_cache"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """With no GPU and no device given, the v1 entry points raise rather
    than run on the CPU."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"init_inference": lambda: tds.init_inference("tiny"),
            "engine": lambda: InferenceEngine(build_model("tiny")),
            "init_cache": lambda: build_model("tiny").init_cache(1, 8)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
