"""Communication over ``torch.distributed`` (``comm.py``)."""

from .comm import (all_reduce, all_to_all_single, barrier, get_rank, get_world_size,  # noqa: F401
                   init_distributed, ring_send_recv)
