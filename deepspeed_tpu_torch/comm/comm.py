"""Module-level communication API over ``torch.distributed``.

Mirrors the names of ``deepspeed_tpu/comm/comm.py`` that the sequence-
parallel slice uses, as thin wrappers: ``init_distributed``, ``get_rank``,
``get_world_size``, ``all_reduce``, ``all_to_all_single``, ``barrier``, and
``ring_send_recv``, the ring exchange (the JAX ``ppermute`` by one step
around an axis). Processes talk over NCCL on cards and gloo on the CPU.
A process that never joined a process group is a world of one: every
collective is then the identity, as on a one-device JAX axis.
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
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=gather_dim)


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

    def peer(r):   # P2POp takes global ranks
        return r % n if group is None else dist.get_global_rank(group, r % n)

    dst, src = peer(rank + shift), peer(rank - shift)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs
