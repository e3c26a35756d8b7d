"""Tensor-parallel serving context: the process group and the layout the
sharded serving steps run under.

Mirrors ``deepspeed_tpu/inference/v2/tp.py``. JAX keeps one controller and
runs the frame loops under ``shard_map`` over a 1-D ``tp`` mesh. The port
runs one process a card, each with the whole engine (SPMD): every rank gets
the same arrivals, makes the same frame-boundary decisions over the same
replicated host state and returns the same tokens, and only the model is
split (DeepSpeed-Inference, arXiv 2207.00032):

- **weights** column- and row-split by the logical-axis rules
  (``parallel/sharding.py`` ``inference_tp_specs``): wq / wk / wv over
  heads, wo and the MLP output over their contraction dim, the MLP input
  over the intermediate dim, the embedding and LM head over vocab when the
  degree divides it;
- **paged KV pools** (target and draft) split by kv head: each rank holds
  ``(L, KVH / tp, NB, bs, lanes)``, so block tables, the allocator and
  admission are unchanged (block ids are global);
- **the slot state and every host structure** replicated, so snapshots,
  the prefix cache and the ledger are those of one engine.

The forward issues the collectives (``parallel/collectives.py``): an
all-reduce after the attention and MLP output projections, a masked-lookup
all-reduce for the vocab-split embedding and an all-gather of the vocab-split
logits. Where a boundary decision reads the wall clock (deadlines, the
watchdog, the scheduler's SLO view), rank 0's decision is broadcast
(``TPContext.agree``): ranks whose decisions diverged would issue different
collectives and hang.
"""

import dataclasses
import os
from typing import Any, Optional

import torch

from ...comm import comm
from ...parallel.collectives import TPCollectives
from ...parallel.sharding import inference_tp_specs, shard_params, shard_shape

@dataclasses.dataclass(frozen=True)
class TPContext:
    """Everything a runner, its pools and a slot table need under tp."""

    group: Any                # the tp process group (None: the world)
    rank: int
    degree: int
    coll: TPCollectives
    vocab_sharded: bool
    param_specs: Any          # each leaf's split dim, or None

    def kv_heads(self, kv_heads: int) -> int:
        """The KV layout (JAX ``kv_spec``): a rank's paged pools (L, KVH,
        NB, bs, lanes) hold its KVH / degree kv heads. (The stats layout,
        JAX ``stats_spec``: each rank counts its frames itself; the counts
        agree by construction, so a rank reads its own, and
        ``tp_debug_replica_check`` all-gathers them to assert it.)"""
        return kv_heads // self.degree

    def shard_params(self, params, full_shapes=None):
        """This rank's shard of a full params tree (``full_shapes``: leaves
        already at their shard's shape pass through)."""
        return shard_params(params, self.param_specs, self.rank, self.degree, full_shapes)

    def shard_shapes(self, abstract_params):
        """The meta tree of this rank's shard shapes."""
        def walk(p, sp):
            if isinstance(p, dict):
                return {k: walk(v, sp[k]) for k, v in p.items()}
            return torch.empty(shard_shape(p.shape, sp, self.degree), dtype=p.dtype,
                               device="meta")

        return walk(abstract_params, self.param_specs)

    def agree(self, obj):
        """Rank 0's value of a host decision, on every rank."""
        return comm.broadcast_object(obj, src=0, group=self.group)

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` holds on some rank: one one-int all-reduce."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        comm.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def warm_up(self, device) -> None:
        """One collective on every rank before anything is captured: NCCL
        makes its communicator at a group's first collective, which a CUDA
        graph capture cannot hold."""
        comm.all_reduce(torch.ones((1,), device=device), group=self.group)


def build_tp_context(model, tp: int, *, quantized: bool = False, overlap: bool = False,
                     payload: str = "int8", role: str = "target",
                     group=None) -> Optional[TPContext]:
    """The serving tp context for ``model`` (a ``CausalLM``; JAX
    ``build_tp_context``). Validates the arch (``archs.validate_tp_serving``),
    takes the process group the caller joined (``comm.init_distributed``;
    ``group``: a group of exactly ``tp`` ranks, default the world) and
    derives the spec tree from the model's ``logical_axes()``. Returns None
    for ``tp <= 1``: the tp = 1 engine never touches a collective."""
    if tp <= 1:
        return None
    from .model_implementations.archs import validate_tp_serving
    validate_tp_serving(model.cfg, tp, role=role)
    world = comm.get_world_size(group)
    if world < tp:
        raise ValueError(
            f"tp={tp} needs {tp} ranks, found {world} (start one process a card and "
            "join them with deepspeed_tpu_torch.comm.init_distributed before building "
            "the engine: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if world > tp:
        raise ValueError(
            f"tp={tp} over a process group of {world} ranks: serve from a group of "
            f"exactly {tp} ranks (build_tp_context(group=...))")
    vocab_sharded = model.cfg.vocab_size % tp == 0
    specs = inference_tp_specs(model.abstract_params(), model.logical_axes(), tp,
                               vocab_sharded=vocab_sharded)
    return TPContext(group=group, rank=comm.get_rank(group), degree=tp,
                     coll=TPCollectives(group=group, degree=tp, quantized=quantized,
                                        overlap=overlap, payload=payload),
                     vocab_sharded=vocab_sharded, param_specs=specs)


def local_device(device=None):
    """Where a tp rank's engine runs: ``device`` when given, else the card of
    its local rank (``LOCAL_RANK``, or the rank modulo the cards there are),
    made the current CUDA device (NCCL and the graph captures use it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("tensor-parallel serving runs on CUDA devices by default and "
                           "no CUDA device is available: pass device='cpu' for the CPU")
    local = int(os.environ.get("LOCAL_RANK", comm.get_rank() % torch.cuda.device_count()))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def init_params_shard(model, ctx: TPContext, seed: int = 0, device=None, dtype=None):
    """Random params drawn directly at this rank's shard shapes, so no rank
    ever holds the whole model: every leaf is drawn as ``CausalLM.init``
    draws it for a model with the local heads, kv heads, FFN width and (when
    split) vocab, from ``seed`` and the rank; then the leaves every rank
    holds whole (norms, and any other unsplit leaf) are made rank 0's by a
    broadcast. Distributions match the unsplit init's (normal 0.02, output
    projections scaled by the full depth, norms at one)."""
    from ...models.transformer import CausalLM
    cfg = model.cfg
    d = ctx.degree
    local = cfg.replace(num_heads=cfg.num_heads // d, num_kv_heads=cfg.kv_heads // d,
                        head_dim=cfg.dims_per_head, intermediate_size=cfg.ffn_size // d,
                        vocab_size=cfg.vocab_size // d if ctx.vocab_sharded else cfg.vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + ctx.rank + 1)
    params = CausalLM(local).init(gen, device=device, dtype=dtype)
    want = ctx.shard_shapes(model.abstract_params(dtype))

    def check(p, w, sp, path):
        if isinstance(p, dict):
            for k in p:
                check(p[k], w[k], sp[k], f"{path}.{k}")
            return
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"init_params_shard: params{path} drawn at {tuple(p.shape)}, "
                             f"the shard is {tuple(w.shape)}")
        if sp is None:
            comm.broadcast(p, src=0, group=ctx.group)

    check(params, want, ctx.param_specs, "")
    return params

