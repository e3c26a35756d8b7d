"""Which dim of each parameter leaf a 1-D mesh splits: tensor-parallel
serving's tp axis, and ZeRO's data axis.

Mirrors what ``deepspeed_tpu/parallel/sharding.py`` gives serving over a
1-D tp mesh (``inference_tp_specs``) and training over a 1-D data mesh
(``zero_rules`` / ``optimizer_state_rules`` through ``tree_specs``). Every parameter leaf carries a tuple
of logical axis names (``CausalLM.logical_axes()``). JAX maps them through
its training rules to ``PartitionSpec`` trees that ``device_put`` lays over
a mesh; over one tp axis only the heads / kv_heads / mlp / vocab rules can
split anything. The port has no mesh: a leaf's spec is the index of the dim
it is split along, or None when every rank holds it whole, and
``shard_params`` cuts rank r's block of each split dim out of a full tree
(JAX's ``device_put`` shard r). Megatron's layout falls out of the names:
wq / wk / wv and the MLP input columns split over heads / kv heads / mlp,
wo and the MLP output over their contraction dim (which carries the same
name), the embedding and LM head over vocab. ZeRO splits the first
``embed`` dim of every leaf of at least ``MIN_SHARD_SIZE`` elements: the
parameters at stage 3, the optimizer state (and, from stage 2, the
gradients) from stage 1.
"""

import math
from typing import Optional, Sequence, Tuple

# the logical axes a tp mesh axis splits (JAX ``BASE_RULES``' ``tensor`` rows)
SPLIT_AXES = ("heads", "kv_heads", "mlp")
# the logical axis ZeRO splits over the data axis (JAX ``FSDP_AXIS`` rows)
ZERO_AXES = ("embed",)
# leaves below this many elements stay whole (JAX ``shard_spec_for``)
MIN_SHARD_SIZE = 2 ** 11


def _leaf_dim(shape: Sequence[int], axes: Sequence[Optional[str]], degree: int,
              split: Tuple[str, ...], min_size: int = 0) -> Optional[int]:
    """The first dim whose logical name is in ``split`` (JAX: a mesh axis
    serves one dim a leaf), or None; None also when ``degree`` does not
    divide that dim or the leaf has fewer than ``min_size`` elements (JAX
    ``shard_spec_for``)."""
    if math.prod(int(n) for n in shape) < min_size:
        return None
    for i, ax in enumerate(axes):
        if ax in split:
            return i if int(shape[i]) % degree == 0 else None
    return None


def inference_tp_specs(abstract_params, logical_tree, degree: int,
                       vocab_sharded: bool = True):
    """The split dim of every leaf for tensor-parallel serving at ``degree``
    (JAX ``inference_tp_specs`` over a 1-D mesh of that size, each
    ``PartitionSpec`` read as the index of its tp entry or None), as a tree
    mirroring ``abstract_params``; ``logical_tree`` gives each leaf its
    tuple of axis names.

    There is no minimum-size threshold: the per-layer reductions assume
    every heads / kv_heads / mlp tensor is split (the caller checks
    divisibility first, ``archs.validate_tp_serving``).
    ``vocab_sharded=False`` leaves the embedding and the LM head whole on
    every rank, and the logits need no gather."""
    split = ("vocab",) + SPLIT_AXES if vocab_sharded else SPLIT_AXES

    def walk(p, ax):
        if isinstance(p, dict):
            return {k: walk(v, ax[k]) for k, v in p.items()}
        return _leaf_dim(tuple(p.shape), ax, degree, split)

    return walk(abstract_params, logical_tree)


def zero_rules(stage: int) -> Tuple[str, ...]:
    """The logical axes ZeRO splits the *parameters* along at ``stage``
    (JAX ``zero_rules``): ``embed`` from stage 3."""
    return ZERO_AXES if stage >= 3 else ()


def optimizer_state_rules(stage: int) -> Tuple[str, ...]:
    """The logical axes ZeRO splits the *optimizer state* along at ``stage``
    (JAX ``optimizer_state_rules``): ``embed`` from stage 1."""
    return ZERO_AXES if stage >= 1 else ()


def zero_specs(abstract_params, logical_tree, rules: Tuple[str, ...], degree: int):
    """The split dim of every leaf over a data axis of ``degree`` under
    ``rules`` (``zero_rules`` or ``optimizer_state_rules``), as a tree
    mirroring ``abstract_params``: JAX ``tree_specs`` over a 1-D data mesh,
    each ``PartitionSpec`` read as the index of its data entry or None."""
    def walk(p, ax):
        if isinstance(p, dict):
            return {k: walk(v, ax[k]) for k, v in p.items()}
        if degree == 1:
            return None
        return _leaf_dim(tuple(p.shape), ax, degree, rules, MIN_SHARD_SIZE)

    return walk(abstract_params, logical_tree)


def shard_shape(shape: Sequence[int], dim: Optional[int], degree: int) -> Tuple[int, ...]:
    """A leaf's shape on one rank: ``dim`` divided by ``degree``."""
    shape = tuple(int(n) for n in shape)
    if dim is None:
        return shape
    return shape[:dim] + (shape[dim] // degree,) + shape[dim + 1:]


def shard_leaf(t, dim: Optional[int], rank: int, degree: int):
    """Rank ``rank``'s block of ``t`` along ``dim`` (contiguous blocks in
    rank order, as ``device_put`` lays a ``PartitionSpec`` over a 1-D
    mesh), as a tensor of its own, so the full leaf can be freed."""
    if dim is None:
        return t
    n = t.shape[dim] // degree
    if n * degree != t.shape[dim]:
        raise ValueError(f"shard_leaf: dim {dim} of {tuple(t.shape)} does not split "
                         f"over {degree} ranks")
    return t.narrow(dim, rank * n, n).clone()


def shard_params(params, specs, rank: int, degree: int, full_shapes=None):
    """Rank ``rank``'s shard of a params tree: each leaf cut along its spec's
    dim (quantized leaves ``{"q", "s"}`` carry a spec each). ``full_shapes``
    (the tree's full shapes, e.g. ``CausalLM.abstract_params``) lets a tree
    that already holds this rank's shards pass through: a leaf at its
    shard's shape is kept as it is."""
    def walk(p, sp, full):
        if isinstance(p, dict):
            return {k: walk(v, sp[k], full[k] if isinstance(full, dict) else None)
                    for k, v in p.items()}
        if sp is not None and full is not None and tuple(p.shape) != tuple(full.shape):
            if tuple(p.shape) != shard_shape(full.shape, sp, degree):
                raise ValueError(f"shard_params: a leaf of shape {tuple(p.shape)} is neither "
                                 f"{tuple(full.shape)} nor its shard")
            return p
        return shard_leaf(p, sp, rank, degree)

    return walk(params, specs, full_shapes)


def is_shard_tree(params, specs, full_shapes) -> bool:
    """Whether some split leaf of ``params`` is already at its shard's shape."""
    def walk(p, sp, full):
        if isinstance(p, dict):
            return isinstance(full, dict) and any(walk(v, sp[k], full[k]) for k, v in p.items())
        return sp is not None and tuple(p.shape) != tuple(full.shape)

    return walk(params, specs, full_shapes)

