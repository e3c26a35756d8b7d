"""Sequence-parallel state: the ``seq`` degree and its process group.

Mirrors the sequence-parallel part of ``deepspeed_tpu/utils/groups.py``,
where the ``seq`` axis of the global device mesh is the sequence-parallel
group. The port has no device mesh: the ``seq`` degree is the number of
sequence shards of the ring, the group is the ``torch.distributed`` process
group they span (None: this process holds every shard), and each process
holds ``seq / world size`` consecutive shards, its local shards. The engine
sets the state from its config's ``mesh`` block, as the JAX engine's mesh
is set from it (``set_mesh``); ``reset`` returns to one shard.
"""

from ..comm import comm

_SEQ_SIZE = 1
_SEQ_GROUP = None


def set_sequence_parallel(size: int, group=None):
    """``size`` sequence shards over the processes of ``group``; each holds
    ``size / world size`` of them."""
    global _SEQ_SIZE, _SEQ_GROUP
    procs = comm.get_world_size(group) if group is not None else 1
    if size < 1 or size % procs:
        raise ValueError(f"seq degree {size} does not split over {procs} processes")
    _SEQ_SIZE, _SEQ_GROUP = int(size), group


def reset():
    set_sequence_parallel(1)


def get_sequence_parallel_world_size() -> int:
    """The ``seq`` degree: the number of sequence shards."""
    return _SEQ_SIZE


def get_sequence_parallel_group():
    """The process group the shards span, or None within one process."""
    return _SEQ_GROUP
