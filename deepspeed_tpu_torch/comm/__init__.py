"""Communication over ``torch.distributed`` (``comm.py``)."""

from .comm import (all_gather_into_tensor, all_reduce, all_to_all_single,  # noqa: F401
                   barrier, broadcast, broadcast_object, get_rank, get_world_size,
                   init_distributed, reduce_scatter_tensor, ring_send_recv)
