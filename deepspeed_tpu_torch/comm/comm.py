"""Module-level communication API over ``torch.distributed``.

Mirrors the names of ``deepspeed_tpu/comm/comm.py`` that the sequence-
parallel and tensor-parallel slices use, as thin wrappers:
``init_distributed``, ``get_rank``, ``get_world_size``, ``all_reduce``,
``all_to_all_single``, ``all_gather_into_tensor`` (the JAX tiled
``all_gather``), ``reduce_scatter_tensor`` (the JAX tiled ``psum_scatter``,
the ZeRO gradient reduction), ``broadcast``, ``broadcast_object``, ``barrier``, and
``ring_send_recv``, the ring exchange (the JAX ``ppermute`` by one step
around an axis). Processes talk over NCCL on cards and gloo on the CPU.
A process that never joined a process group is a world of one: every
collective is then the identity, as on a one-device JAX axis. Neither
backend has an fp8 dtype: fp8 payloads travel as their ``uint8`` bytes.
"""

import os

import torch
import torch.distributed as dist


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(dist_backend=None, distributed_port=29500, init_method=None, rank=-1,
                     world_size=-1, timeout=None):
    """Join the process group. ``rank`` and ``world_size`` default to the
    ``RANK`` and ``WORLD_SIZE`` environment variables, the rendezvous to
    ``tcp://MASTER_ADDR:MASTER_PORT`` (localhost and ``distributed_port``
    when unset); the backend to NCCL when a GPU is present, else gloo. A
    world of one process joins nothing (the JAX single-host no-op)."""
    if _joined():
        return
    world_size = int(os.environ.get("WORLD_SIZE", world_size if world_size > 0 else 1))
    rank = int(os.environ.get("RANK", rank if rank >= 0 else 0))
    if world_size <= 1:
        return
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", distributed_port)
        init_method = f"tcp://{addr}:{port}"
    backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)


def get_rank(group=None) -> int:
    return dist.get_rank(group) if _joined() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if _joined() else 1


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _wire(t):
    """``t`` as the backends can carry it: fp8 tensors as a ``uint8`` view
    of their bytes, anything else as it is."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None):
    """In place, as ``torch.distributed.all_reduce``; returns the tensor."""
    if get_world_size(group) > 1:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_to_all_single(tensor, scatter_dim=0, gather_dim=0, group=None):
    """Split ``tensor`` into one chunk per rank along ``scatter_dim``, send
    chunk j to rank j, and concatenate what arrives along ``gather_dim``
    (the JAX ``all_to_all`` with ``tiled=True``). Returns a new tensor."""
    n = get_world_size(group)
    if n == 1:
        return tensor
    if tensor.shape[scatter_dim] % n:
        raise ValueError(f"all_to_all_single: dim {scatter_dim} of {tuple(tensor.shape)} does "
                         f"not split over {n} ranks")
    chunks = [c.contiguous() for c in tensor.chunk(n, dim=scatter_dim)]
    send = torch.stack(chunks)
    recv = torch.empty_like(send)
    dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    return torch.cat(list(recv.unbind(0)), dim=gather_dim)


def all_gather_into_tensor(tensor, dim=0, group=None):
    """Every rank's ``tensor`` concatenated along ``dim`` in rank order (the
    JAX ``all_gather`` with ``tiled=True``). Returns a new tensor."""
    n = get_world_size(group)
    if n == 1:
        return tensor
    send = tensor.contiguous()
    recv = torch.empty((n * send.numel(),), dtype=send.dtype, device=send.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(_wire(recv), _wire(send.reshape(-1)), group=group)
    return torch.cat(list(recv.view((n,) + tuple(send.shape)).unbind(0)), dim=dim)


def reduce_scatter_tensor(tensor, dim=0, group=None):
    """The sum over ranks of ``tensor``, cut into one block per rank along
    ``dim``: rank r gets block r (the JAX ``psum_scatter`` with
    ``tiled=True``). The blocks travel as one contiguous (ranks, ...) stack,
    so any ``dim`` reduces on dim 0 of a contiguous buffer. Returns a new
    contiguous tensor of the block's shape."""
    n = get_world_size(group)
    if n == 1:
        return tensor
    if tensor.shape[dim] % n:
        raise ValueError(f"reduce_scatter_tensor: dim {dim} of {tuple(tensor.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(tensor.chunk(n, dim=dim))
    recv = torch.empty(send.shape[1:], dtype=send.dtype, device=send.device)
    # flat buffers: gloo wants the input's dim 0 to be ranks x the output's
    dist.reduce_scatter_tensor(recv.view(-1), send.view(-1), group=group)
    return recv


def _global(group, r):
    """Global rank of rank ``r`` of ``group`` (None: the world)."""
    return r if group is None else dist.get_global_rank(group, r)


def broadcast(tensor, src=0, group=None):
    """In place, rank ``src`` of ``group``'s values to every rank; returns
    the tensor."""
    if get_world_size(group) > 1:
        dist.broadcast(_wire(tensor), src=_global(group, src), group=group)
    return tensor


def broadcast_object(obj, src=0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank (its own elsewhere
    ignored): a host value that one rank decided, made every rank's."""
    if get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_global(group, src), group=group)
    return box[0]


def barrier(group=None):
    if get_world_size(group) > 1:
        dist.barrier(group=group)


def ring_send_recv(tensors, group=None, shift=1):
    """Send ``tensors`` to rank + shift of ``group`` and receive tensors of
    the same shapes and dtypes from rank - shift, in one
    ``batch_isend_irecv`` (send and receive issued together, so a ring of
    processes cannot deadlock). Returns the received tensors."""
    n = get_world_size(group)
    if n == 1:
        return list(tensors)
    rank = get_rank(group)

    dst, src = _global(group, (rank + shift) % n), _global(group, (rank - shift) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, _wire(t), dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, _wire(t), src, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs
