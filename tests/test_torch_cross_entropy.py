"""Vocab-chunked cross-entropy of the PyTorch port against the JAX package.

``lm_cross_entropy`` (loss and the gradients of h and w through the custom
backward) on the same numpy inputs in both packages, with a vocab of at
least 4096 that the chunk count does not divide (the padded tail chunk),
tied and transposed heads, a loss mask and a softcap; then ``CausalLM.loss``
with the chunk threshold lowered so the chunked path engages, against the
same JAX model. f32 throughout; tolerance 1e-5 on losses and 2e-5 on
gradients (sums over 4100 vocab columns in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.ops.cross_entropy import lm_cross_entropy as jax_lm_xent
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.ops.cross_entropy import lm_cross_entropy
from deepspeed_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LOSS_TOL, GRAD_TOL = 1e-5, 2e-5
V, E = 4100, 32


@pytest.mark.parametrize("variant", ["tied", "transposed", "masked", "softcap"])
def test_lm_cross_entropy_matches_jax(variant):
    rng = np.random.default_rng(len(variant))
    h = rng.standard_normal((2, 24, E)).astype(np.float32)
    w = (rng.standard_normal((V, E)) * 0.2).astype(np.float32)
    labels = rng.integers(0, V, (2, 24)).astype(np.int32)
    kw = {"n_chunks": 8}
    if variant == "transposed":
        w = np.ascontiguousarray(w.T)
        kw["transpose_w"] = True
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32) if variant == "masked" else None
    if variant == "softcap":
        kw["softcap"] = 5.0

    def jloss(h_, w_):
        return jax_lm_xent(h_, w_, jnp.asarray(labels),
                           loss_mask=None if mask is None else jnp.asarray(mask), **kw)

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = lm_cross_entropy(th, tw, torch.from_numpy(labels),
                          loss_mask=None if mask is None else torch.from_numpy(mask), **kw)
    tdh, tdw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2"])
def test_model_loss_takes_the_chunked_path(preset):
    over = dict(vocab_size=V, dtype="float32", loss_chunk_threshold_bytes=1024)
    jmodel = jax_build_model(preset, **over)
    model = build_model(preset, **over)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    params = params_from_numpy(model.cfg, jparams, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (2, 16)).astype(np.int32)
    batch = {"input_ids": ids, "labels": np.roll(ids, -1, axis=1)}
    assert model._chunked_loss(ids.size)
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tl = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = torch.autograd.grad(tl, tree_leaves(params))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_TOL)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=GRAD_TOL)
