"""Checkpoint engines.

Mirrors ``deepspeed_tpu/runtime/checkpoint_engine/orbax_engine.py``: the
``CheckpointEngine`` interface (create / save / load / commit) and the
port's backend, ``TorchCheckpointEngine``. JAX's orbax writes logical
arrays with sharded writers; the port runs one process a card, so each
rank writes its own tensors with ``torch.save`` into
``<dir>/<tag>/states_rank<r>.pt`` (the module, optimizer and Twin-Flow
shards it holds, the loss scaler, and its ``layout``: degree, rank, stage
and every leaf's split dims), and after a barrier rank 0 writes
``ds_meta.json`` with JAX's meta keys. The engine writes ``latest``. The
port does not read JAX's orbax checkpoints (they need ``jax``): the two
packages meet in the universal format (``checkpoint/universal.py``).
"""

import json
import os
from typing import Any, Dict

import torch

from ...comm import comm

META_FILE = "ds_meta.json"


def rank_file(path: str, rank: int) -> str:
    return os.path.join(path, f"states_rank{rank}.pt")


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().cpu()
    return x


class CheckpointEngine:
    def __init__(self, config_params=None):
        pass

    def create(self, tag):
        pass

    def save(self, state_dict, path: str):
        raise NotImplementedError

    def load(self, path: str, layout=None):
        raise NotImplementedError

    def commit(self, tag):
        return True


class TorchCheckpointEngine(CheckpointEngine):
    """One ``torch.save`` file a rank and rank 0's ``ds_meta.json``."""

    def save(self, state: Dict[str, Any], path: str):
        """Every rank of the group calls it with its own ``state`` (a
        ``meta`` entry is written by rank 0 only, after every rank's file)."""
        rank = comm.get_rank()
        os.makedirs(path, exist_ok=True)
        torch.save(_to_cpu({k: v for k, v in state.items() if k != "meta"}),
                   rank_file(path, rank))
        comm.barrier()
        if rank == 0 and state.get("meta") is not None:
            with open(os.path.join(path, META_FILE), "w") as f:
                json.dump(state["meta"], f)
        return True

    def load(self, path: str, layout=None):
        """This rank's state with ``meta``. ``layout``: the loading engine's
        (``world``, ``rank``, ``stage``); a checkpoint saved at another
        degree or stage raises (load it through a universal checkpoint)."""
        rank = comm.get_rank() if layout is None else layout["rank"]
        state = load_rank(path, rank)
        saved = state.get("layout", {})
        if layout is not None and (saved.get("world"), saved.get("stage")) != \
                (layout["world"], layout["stage"]):
            raise ValueError(
                f"{path} was saved at data-parallel degree {saved.get('world')}, ZeRO stage "
                f"{saved.get('stage')}; this engine runs degree {layout['world']}, stage "
                f"{layout['stage']}: convert it with checkpoint.universal.ds_to_universal "
                "and load_universal_checkpoint")
        state["meta"] = load_meta(path)
        return state


def load_rank(path: str, rank: int):
    f = rank_file(path, rank)
    if not os.path.isfile(f):
        raise FileNotFoundError(f"no checkpoint file {f}")
    return torch.load(f, map_location="cpu", weights_only=False)


def load_meta(path: str):
    meta_path = os.path.join(path, META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)
