"""Sequence-parallel cross entropy.

Mirrors ``deepspeed_tpu/sequence/cross_entropy.py`` (reference
``deepspeed/sequence/cross_entropy.py:59``): with the sequence split over
processes, each computes the cross entropy of its own tokens and the mean
is taken over the sequence-parallel group. In one process holding every
shard that is the plain mean.
"""

import torch

from ..comm import comm
from ..utils import groups


def _nll(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def vocab_sequence_parallel_cross_entropy(logits, labels, group=None):
    """logits (B, S_local, V) and labels (B, S_local) of this process: its
    mean f32 cross entropy, averaged over ``group``. The value is the
    group's mean; the gradient flows to this process's logits only (each
    process differentiates its own share), as with the JAX ``pmean``."""
    local = _nll(logits, labels).mean()
    n = comm.get_world_size(group) if group is not None else 1
    if n == 1:
        return local
    total = comm.all_reduce(local.detach().clone(), group=group)
    share = local / n
    return share + (total / n - share).detach()


def sequence_parallel_cross_entropy(logits, labels, group=None):
    """The same over the sequence-parallel group of ``utils.groups`` by
    default."""
    group = group if group is not None else groups.get_sequence_parallel_group()
    return vocab_sequence_parallel_cross_entropy(logits, labels, group)
