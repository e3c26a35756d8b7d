"""Parallel state: the ``data`` and ``seq`` degrees and their process groups.

Mirrors the data- and sequence-parallel parts of
``deepspeed_tpu/utils/groups.py``, where the ``data`` and ``seq`` axes of the
global device mesh are the data- and sequence-parallel groups. The port has
no device mesh: one process drives one card, and the ``data`` group is the
``torch.distributed`` group of the processes that each hold a slice of the
global batch (``BATCH_AXES``; the port's mesh is one ``data`` axis over the
whole world, as ``build_mesh`` fills ``data`` with the devices the other
axes leave). The ``seq`` degree is the number of sequence shards of the
ring, the group is the process group they span (None: this process holds
every shard), and each process holds ``seq / world size`` consecutive
shards, its local shards. The engine sets the state from its config's
``mesh`` block, as the JAX engine's mesh is set from it (``set_mesh``);
``reset`` returns to one process and one shard.
"""

from ..comm import comm

# the mesh axes whose product is the data-parallel world (JAX ``BATCH_AXES``)
BATCH_AXES = ("zrep", "data", "expert")

_SEQ_SIZE = 1
_SEQ_GROUP = None
_DATA_SIZE = 1


def set_sequence_parallel(size: int, group=None):
    """``size`` sequence shards over the processes of ``group``; each holds
    ``size / world size`` of them."""
    global _SEQ_SIZE, _SEQ_GROUP
    procs = comm.get_world_size(group) if group is not None else 1
    if size < 1 or size % procs:
        raise ValueError(f"seq degree {size} does not split over {procs} processes")
    _SEQ_SIZE, _SEQ_GROUP = int(size), group


def resolve_data_degree(mesh: dict, world: int) -> int:
    """The ``data`` degree of a config's ``mesh`` block in a world of
    ``world`` processes (JAX ``build_mesh``): unset, -1 or "auto" fills the
    world; any other value must equal it (the port's other axes span no
    process: ``seq`` shards live within one, and the rest are refused)."""
    data = mesh.get("data", -1)
    if data in (-1, None, "auto"):
        return world
    if not isinstance(data, int) or data != world:
        raise ValueError(f"mesh data={data!r} does not match the world of {world} "
                         "process(es): the port runs one process a card, all on the data axis")
    return data


def set_data_parallel(size: int):
    """A data-parallel world of ``size`` processes: the whole default group,
    or this process alone."""
    global _DATA_SIZE
    procs = comm.get_world_size()
    if size != procs and size != 1:
        raise ValueError(f"data degree {size} is not the world's {procs} processes")
    _DATA_SIZE = int(size)


def reset():
    set_sequence_parallel(1)
    set_data_parallel(1)


def get_sequence_parallel_world_size() -> int:
    """The ``seq`` degree: the number of sequence shards."""
    return _SEQ_SIZE


def get_sequence_parallel_group():
    """The process group the shards span, or None within one process."""
    return _SEQ_GROUP


def get_data_parallel_world_size() -> int:
    """The number of processes that split the global batch."""
    return _DATA_SIZE


def get_data_parallel_group():
    """The process group the data-parallel world spans: None, the default
    group (the port's data axis is the whole world)."""
    return None


def get_data_parallel_rank() -> int:
    """This process's rank in the data-parallel world."""
    return comm.get_rank() if _DATA_SIZE > 1 else 0
