"""DeepSpeed-Ulysses sequence parallelism.

Mirrors ``deepspeed_tpu/sequence/layer.py`` (reference
``deepspeed/sequence/layer.py:145`` ``DistributedAttention``,
``single_all_to_all:41``, ``_SeqAllToAll:90``): an all-to-all scatters heads
and gathers the sequence before the local attention, and the inverse
exchange follows it. The exchange runs over the sequence-parallel process
group; in one process holding every shard it is the identity, as it is on
the JAX package's single-host virtual mesh.
"""

from typing import Callable

import torch

from ..comm import comm
from ..utils import groups


class _SeqAllToAll(torch.autograd.Function):
    """The all-to-all, whose gradient is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, scatter_idx, gather_idx):
        ctx.exchange = (group, scatter_idx, gather_idx)
        return comm.all_to_all_single(x, scatter_idx, gather_idx, group)

    @staticmethod
    def backward(ctx, g):
        group, scatter_idx, gather_idx = ctx.exchange
        return comm.all_to_all_single(g.contiguous(), gather_idx, scatter_idx, group), \
            None, None, None


def seq_all_to_all(x, group=None, scatter_idx: int = 2, gather_idx: int = 1):
    """All-to-all over ``group``: scatter dim ``scatter_idx`` (heads),
    gather dim ``gather_idx`` (sequence); differentiable. The identity for a
    group of one process (or None)."""
    if group is None or comm.get_world_size(group) == 1:
        return x
    return _SeqAllToAll.apply(x, group, scatter_idx, gather_idx)


class DistributedAttention:
    """Wraps a local attention callable with the Ulysses exchange.

    ``local_attn(q, k, v, *args, **kwargs) -> out`` sees full-sequence,
    head-split tensors; inputs and outputs at the boundary are this
    process's part of the sequence. ``sequence_process_group`` defaults to
    the group of ``utils.groups``."""

    def __init__(self, local_attention: Callable, sequence_process_group=None,
                 scatter_idx: int = 2, gather_idx: int = 1, sp_stream=None):
        self.local_attn = local_attention
        self.spg = sequence_process_group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def __call__(self, query, key, value, *args, **kwargs):
        group = self.spg if self.spg is not None else groups.get_sequence_parallel_group()
        if group is None or comm.get_world_size(group) == 1:
            return self.local_attn(query, key, value, *args, **kwargs)
        q, k, v = (seq_all_to_all(t, group, self.scatter_idx, self.gather_idx)
                   for t in (query, key, value))
        out = self.local_attn(q, k, v, *args, **kwargs)
        return seq_all_to_all(out, group, self.gather_idx, self.scatter_idx)
