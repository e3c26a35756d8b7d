"""Sequence parallelism of the PyTorch port against the JAX package.

- ``DistributedAttention`` and ``seq_all_to_all`` in one process holding
  every shard: the identity exchange around the local attention.
- ``sequence_parallel_cross_entropy`` against JAX's on the virtual mesh
  (data=2, seq=4), 1e-6.
- ``multihead_attention(impl="ring")``: with one shard it is the reference
  path; the JAX refusals (non-causal; a bias or softcap over shards) raise;
  the auto dispatch over shards equals the one-shard result.
- Training: a port engine with ``mesh {"seq": 4}`` against JAX's
  ``test_ring_training_matches_dp`` set-up (a JAX engine on the mesh data=2,
  seq=4 with ``attn_impl="ring"``), started from the same weights: three
  fp32 ``train_batch`` losses at rtol 1e-5 (the JAX test holds CP to DP at
  3e-4), on ``tiny`` (D = 16: the einsum ring) and on ``tiny`` with one
  head (D = 64: the flash ring).
- Across processes: 2 gloo processes holding 2 shards each, and 4 holding
  1 each. Ring attention outputs and q/k/v gradients, on both routes, equal
  the one-process ring exactly (the same f32 operations in the same order);
  the Ulysses all-to-all round-trips exactly and ``DistributedAttention``
  equals the attention of the whole sequence; the cross entropy's value and
  local gradients equal the one-process ones (1e-6). The children are
  killed after a time limit of their own.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.sequence.cross_entropy import \
    sequence_parallel_cross_entropy as jax_sp_cross_entropy
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.sequence.cross_entropy import sequence_parallel_cross_entropy
from deepspeed_tpu_torch.sequence.layer import DistributedAttention, seq_all_to_all
from deepspeed_tpu_torch.utils import groups

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _one_shard_after():
    yield
    groups.reset()


def _qkv(seed, b=2, s=32, h=4, kvh=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


def test_distributed_attention_in_one_process():
    groups.set_sequence_parallel(4)
    q, k, v = _qkv(0)
    attn = DistributedAttention(lambda q, k, v: port_attention.reference_attention(q, k, v))
    assert torch.equal(attn(q, k, v), port_attention.reference_attention(q, k, v))
    assert seq_all_to_all(q) is q
    assert seq_all_to_all(q, groups.get_sequence_parallel_group(), 1, 2) is q


def test_sp_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 32, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)
    jax_groups.reset_mesh()
    jax_groups.set_mesh(jax_groups.build_mesh(data=2, seq=4))
    want = float(jax_sp_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    jax_groups.reset_mesh()
    groups.set_sequence_parallel(4)
    got = sequence_parallel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_ring_impl_dispatch():
    q, k, v = _qkv(2)
    ref = port_attention.reference_attention(q, k, v)
    # one shard: the ring is the reference path
    assert torch.equal(port_attention.multihead_attention(q, k, v, impl="ring"), ref)
    with pytest.raises(NotImplementedError, match="causal-only"):
        port_attention.multihead_attention(q, k, v, causal=False, impl="ring")
    groups.set_sequence_parallel(4)
    with pytest.raises(NotImplementedError, match="causal-only"):
        port_attention.multihead_attention(q, k, v, causal=False, impl="ring")
    with pytest.raises(NotImplementedError, match="softcap"):
        port_attention.multihead_attention(q, k, v, impl="ring", softcap=30.0)
    with pytest.raises(NotImplementedError, match="bias"):
        port_attention.multihead_attention(q, k, v, impl="ring",
                                           bias=torch.zeros(1, 4, 32, 32))
    torch.testing.assert_close(port_attention.multihead_attention(q, k, v, impl="ring"), ref,
                               rtol=2e-5, atol=2e-5)
    # the auto dispatch over shards: the Ulysses exchange is the identity here
    assert torch.equal(port_attention.multihead_attention(q, k, v), ref)


def _train_config(mesh=None):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 2}, "steps_per_print": 10 ** 9, "seed": 7}
    if mesh:
        cfg["mesh"] = mesh
    return cfg


def _batch(seed, n=16, seq=32):
    ids = np.random.default_rng(seed).integers(0, 256, (n, seq))
    return {"input_ids": ids, "labels": ids}


@pytest.mark.parametrize("heads", [4, 1])
def test_ring_training_matches_jax(heads):
    """4 heads of 16 (the einsum ring), 1 head of 64 (the flash ring)."""
    jax_groups.reset_mesh()
    jax_groups.set_mesh(jax_groups.build_mesh(data=2, seq=4))
    jengine, _, _, _ = jds.initialize(
        model=jax_build_model("tiny", attn_impl="ring", num_heads=heads), config=_train_config())
    start = jax.tree.map(np.asarray, jengine.module_params)
    want = [float(jengine.train_batch(_batch(i))) for i in range(3)]
    jax_groups.reset_mesh()
    engine, _, _, _ = tds.initialize(model=build_model("tiny", attn_impl="ring", num_heads=heads),
                                     config=_train_config({"seq": 4}), device="cpu")
    assert groups.get_sequence_parallel_world_size() == 4
    engine.load_module_state_dict(start)
    got = [engine.train_batch(_batch(i)).item() for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_other_wide_mesh_axes_still_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.initialize(model=build_model("tiny"), config=_train_config({"seq": 4, "data": 2}),
                       device="cpu")
    with pytest.raises(ValueError):
        groups.set_sequence_parallel(0)


# ---------------------------------------------------------------- across processes

CHILD = r'''
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops.attention import reference_attention
from deepspeed_tpu_torch.sequence.cross_entropy import (
    sequence_parallel_cross_entropy, vocab_sequence_parallel_cross_entropy)
from deepspeed_tpu_torch.sequence.layer import DistributedAttention, seq_all_to_all
from deepspeed_tpu_torch.sequence.ring_attention import ring_attention
from deepspeed_tpu_torch.utils import groups

comm.init_distributed(dist_backend="gloo")
rank, procs = comm.get_rank(), comm.get_world_size()
world = dist.group.WORLD
B, S, H, KVH, SEQ = 2, 32, 4, 2, 4
part = slice(rank * S // procs, (rank + 1) * S // procs)
g = torch.Generator().manual_seed(0)
results = {}


def ring(q, k, v, cot, **kw):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ring_attention(q, k, v, **kw)
    out.backward(cot)
    return out.detach(), q.grad, k.grad, v.grad


for route, d in (("flash", 64), ("einsum", 16)):
    q, k, v, cot = (torch.randn(B, S, n, d, generator=g) for n in (H, KVH, KVH, H))
    seg = torch.zeros(B, S, dtype=torch.int32)
    seg[:, 20:] = 1
    kw = dict(window=12, alibi_slopes=torch.linspace(0.5, 0.05, H), segment_ids=seg)
    groups.set_sequence_parallel(SEQ)                       # one process, every shard
    want = ring(q, k, v, cot, **kw)
    groups.set_sequence_parallel(SEQ, world)                # SEQ / procs shards here
    got = ring(q[:, part], k[:, part], v[:, part], cot[:, part],
               **{**kw, "segment_ids": seg[:, part]})
    results[route] = all(torch.equal(a, b[:, part]) for a, b in zip(got, want))

x = torch.randn(B, S // procs, H, 16, generator=g)
y = seq_all_to_all(x, world, 2, 1)
results["all_to_all_shape"] = list(y.shape) == [B, S, H // procs, 16]
results["all_to_all_roundtrip"] = torch.equal(seq_all_to_all(y, world, 1, 2), x)
q, k, v = (torch.randn(B, S, H, 16, generator=g) for _ in range(3))   # heads split 4 ways
attn = DistributedAttention(lambda q, k, v: reference_attention(q, k, v))
results["ulysses"] = torch.allclose(attn(q[:, part], k[:, part], v[:, part]),
                                    reference_attention(q, k, v)[:, part], rtol=1e-6, atol=1e-6)

logits = torch.randn(B, S, 64, generator=g)
labels = torch.randint(0, 64, (B, S), generator=g)
full = logits.clone().requires_grad_(True)
want = vocab_sequence_parallel_cross_entropy(full, labels)    # one process
want.backward()
mine = logits[:, part].clone().requires_grad_(True)
got = sequence_parallel_cross_entropy(mine, labels[:, part])
got.backward()
# each process's share of the mean: its gradient is the whole mean's on its tokens
results["cross_entropy"] = (abs(got.item() - want.item()) <= 1e-6
                            and torch.allclose(mine.grad, full.grad[:, part], atol=1e-7))
print(json.dumps(results))
'''


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("procs", [2, 4])
def test_ring_across_gloo_processes(procs):
    env = {**os.environ, "PYTHONPATH": str(REPO), "WORLD_SIZE": str(procs),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "OMP_NUM_THREADS": "1"}
    children = [subprocess.Popen([sys.executable, "-c", CHILD], cwd=REPO, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 env={**env, "RANK": str(r)}) for r in range(procs)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        outs = [c.communicate(timeout=max(1.0, deadline - time.monotonic())) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    for rank, (c, (out, err)) in enumerate(zip(children, outs)):
        assert c.returncode == 0, f"rank {rank}: {err[-2000:]}"
        results = json.loads(out.strip().splitlines()[-1])
        assert all(results.values()), f"rank {rank}: {results}"
        assert set(results) == {"flash", "einsum", "all_to_all_shape", "all_to_all_roundtrip",
                                "ulysses", "cross_entropy"}
