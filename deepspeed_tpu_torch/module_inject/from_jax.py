"""Weights bridge: JAX params (as numpy) to the port's params.

The JAX package keeps a ``CausalLM``'s parameters as a nested dict pytree
(``deepspeed_tpu/models/transformer.py`` ``CausalLM.init``); the port keeps
the same tree of torch tensors under the same leaf names. The caller
converts the JAX tree to numpy first (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.

Quantized weights cross the same way: ``quantized_parameter_from_numpy``
takes the fields of a JAX ``inference/quantization/layers.py``
``QuantizedParameter`` (q, scales, orig_shape, bits, group_size, dtype) and
``woq_state_from_numpy`` a ``ops/pallas/woq_matmul.py`` ``quantize_woq``
state dict, each with its arrays as numpy.
"""

import numpy as np
import torch

from ..accelerator import get_device


def params_from_numpy(cfg, tree, device=None, dtype=None):
    """Port params from a numpy copy of the JAX params of a model with
    config ``cfg``. Every leaf must match the port's tree by path and shape
    (checked against ``CausalLM.abstract_params``). A leaf may also be a
    quantized one, ``{"q": int8, "s": f32}``, as the JAX serving
    quantization (``model_implementations/quantize.py`` ``quantize_params``)
    leaves it: its shapes are checked against the port's
    ``quantize_params`` of the same leaf and its bytes kept. ``dtype``
    casts every float leaf outside a quantized one (None keeps each leaf's
    dtype). Returns a dict of tensors on ``device``: the current CUDA device
    by default, which raises without a GPU (pass ``device="cpu"`` for the
    CPU)."""
    from ..inference.v2.model_implementations.quantize import quantize_params
    from ..models.transformer import CausalLM
    model = CausalLM(cfg)
    expected = model.abstract_params()
    quantized, _ = quantize_params(model.abstract_params(), model.logical_axes())
    device = get_device(device)

    def keys(node, want, path):
        if set(node) != set(want):
            raise ValueError(f"params{path}: keys {sorted(node)} != expected {sorted(want)}")
        return node

    def convert(node, want, want_q, path):
        out = {}
        for k, v in keys(node, want, path).items():
            if isinstance(want[k], dict):
                out[k] = convert(v, want[k], want_q[k], f"{path}.{k}")
            elif isinstance(v, dict):
                if not isinstance(want_q[k], dict):
                    raise ValueError(f"params{path}.{k}: a quantized leaf where the "
                                     "serving quantization keeps the float one")
                out[k] = {n: leaf(t, want_q[k][n], f"{path}.{k}.{n}", exact=True)
                          for n, t in keys(v, want_q[k], f"{path}.{k}").items()}
            else:
                out[k] = leaf(v, want[k], f"{path}.{k}")
        return out

    def leaf(v, want, path, exact=False):
        arr = np.asarray(v)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"params{path}: shape {arr.shape} != expected {tuple(want.shape)}")
        t = torch.tensor(arr)      # a copy: JAX hands out read-only arrays
        if exact and t.dtype != want.dtype:
            raise ValueError(f"params{path}: dtype {t.dtype} != expected {want.dtype}")
        return t.to(device=device, dtype=None if exact else dtype or t.dtype)

    return convert(tree, expected, quantized, "")


def _tensor(arr, device):
    """A torch copy of a numpy array; bfloat16 (ml_dtypes) arrays, which
    torch cannot read, go through their 16-bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr).to(device)


def quantized_parameter_from_numpy(q, scales, orig_shape, bits, group_size, dtype,
                                   device=None):
    """A port ``QuantizedParameter`` from the fields of a JAX one: ``q`` and
    ``scales`` as numpy arrays (bytes and scales kept as they are), ``dtype``
    the JAX dtype (or its name) of the original weight. Device as for
    ``params_from_numpy``."""
    from ..inference.quantization.layers import QuantizedParameter
    from ..models.config import torch_dtype
    device = get_device(device)
    return QuantizedParameter(_tensor(q, device), _tensor(scales, device),
                              tuple(int(n) for n in orig_shape), int(bits), int(group_size),
                              torch_dtype(np.dtype(dtype).name))


def woq_state_from_numpy(state, device=None):
    """A port ``quantize_woq`` state from a JAX one with numpy ``q`` and
    ``scales``: the same keys, tensors on ``device``."""
    device = get_device(device)
    return {"q": _tensor(state["q"], device), "scales": _tensor(state["scales"], device),
            "bits": int(state["bits"]), "group_size": int(state["group_size"]),
            "shape": tuple(int(n) for n in state["shape"])}
