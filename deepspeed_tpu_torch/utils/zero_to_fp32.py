"""Consolidate a checkpoint into a single f32 state dict.

Mirrors ``deepspeed_tpu/utils/zero_to_fp32.py``: offline conversion of a
checkpoint the port's ``save_checkpoint`` wrote into a flat
``{dotted parameter path: f32 numpy array}``, usable without the engine.
Each rank's file (``runtime/checkpoint_engine``) holds its shards and
their split dims; the leaves are joined along those dims in rank order.
The optimizer's f32 masters are preferred where the checkpoint has them
(host offload, or bf16 / fp16 master weights), as JAX's does. Also a
script:

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint dir> <out.npz>
"""

import glob
import os
import sys
from typing import Dict

import numpy as np
import torch

from ..runtime.checkpoint_engine import load_rank
from .tree import tree_paths


def _join(states, section, key, dim):
    """Leaf ``key`` of ``section`` (a flat dict per rank) whole: the ranks'
    blocks concatenated along ``dim``, or rank 0's when whole."""
    parts = [s[section][key] for s in states]
    if dim is None or len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=dim)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag=None) -> Dict[str, np.ndarray]:
    """Read ``<dir>/<tag or latest>/`` and return ``{param path: f32 array}``."""
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
    path = os.path.join(checkpoint_dir, str(tag)) if tag else checkpoint_dir
    n = len(glob.glob(os.path.join(path, "states_rank*.pt")))
    if n == 0:
        raise FileNotFoundError(f"no port checkpoint under {path}")
    raw = [load_rank(path, r) for r in range(n)]
    layout = raw[0]["layout"]
    states = []
    for s in raw:
        flat = {"module": dict(tree_paths(s["module"])), "masters": {}}
        opt = s.get("optimizer") or {}
        for k, t in tree_paths(opt.get("slots", {})):
            if k.endswith(".master") and t is not None:
                flat["masters"][k[:-len(".master")]] = t
        states.append(flat)
    out = {}
    for k in states[0]["module"]:
        if k in states[0]["masters"]:
            t = _join(states, "masters", k, layout["opt_dims"][k])
        else:
            t = _join(states, "module", k, layout["param_dims"][k])
        out[k] = t.float().numpy()
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str, tag=None):
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    return output_file


def main():
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(1)
    convert_zero_checkpoint_to_fp32_state_dict(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
