"""Weights bridge: JAX params (as numpy) to the port's params.

The JAX package keeps a ``CausalLM``'s parameters as a nested dict pytree
(``deepspeed_tpu/models/transformer.py`` ``CausalLM.init``); the port keeps
the same tree of torch tensors under the same leaf names. The caller
converts the JAX tree to numpy first (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.
"""

import numpy as np
import torch

from ..accelerator import get_device


def params_from_numpy(cfg, tree, device=None, dtype=None):
    """Port params from a numpy copy of the JAX params of a model with
    config ``cfg``. Every leaf must match the port's tree by path and shape
    (checked against ``CausalLM.abstract_params``); ``dtype`` casts every
    leaf (None keeps each leaf's dtype). Returns a dict of tensors on
    ``device``: the current CUDA device by default, which raises without a
    GPU (pass ``device="cpu"`` for the CPU)."""
    from ..models.transformer import CausalLM
    expected = CausalLM(cfg).abstract_params()
    device = get_device(device)

    def convert(node, want, path):
        if set(node) != set(want):
            raise ValueError(f"params{path}: keys {sorted(node)} != expected {sorted(want)}")
        out = {}
        for k, v in node.items():
            if isinstance(want[k], dict):
                out[k] = convert(v, want[k], f"{path}.{k}")
                continue
            arr = np.asarray(v)
            if tuple(arr.shape) != tuple(want[k].shape):
                raise ValueError(f"params{path}.{k}: shape {arr.shape} != "
                                 f"expected {tuple(want[k].shape)}")
            t = torch.tensor(arr)      # a copy: JAX hands out read-only arrays
            out[k] = t.to(device=device, dtype=dtype or t.dtype)
        return out

    return convert(tree, expected, "")
