"""ZeRO's shard bookkeeping over the data-parallel group.

The JAX package states ZeRO declaratively (``deepspeed_tpu/runtime/
engine.py:120-166`` with ``parallel/sharding.py``): each parameter, its
gradient and its optimizer state get a ``NamedSharding`` over the ``data``
axis, and XLA inserts the all-gathers and reduce-scatters. The port runs
eagerly, one process a card, so this module does by hand what those
shardings make XLA do:

- each leaf's split dims (``parallel.sharding.zero_specs``): the parameter
  dim (stage 3), the optimizer-state dim (stages 1-3) and the gradient dim
  (the optimizer's from stage 2, else the parameter's), and its shard
  shape. A split leaf's shard is rank r's contiguous block along its dim
  (``device_put``'s shard r), stored as a contiguous tensor of its own:
  the buffer the fused Adam kernel K10 updates;
- the cut of a full tree (``cut_init`` while the model draws its
  parameters, ``cut``), and the gather of a sharded tree back to full
  (``gather``);
- the gradient reduction at the step (``reduce_grads``): all-reduce for a
  leaf whose gradient is replicated, then the rank's block where the
  optimizer state is split (stage 1); reduce-scatter into the optimizer's
  dim (stage 2); at stage 3 the split leaves' gradients arrive reduced;
- stage 3's gathers in the forward (``LayerGather``, one a forward for the
  embedding and final norm, one a layer inside the checkpointed layer
  function), each a ``torch.autograd.Function`` whose backward
  reduce-scatters the gathered leaves' gradients into the f32 gradient
  shards (``grad_shards``), as XLA's FSDP schedule gathers a layer's
  weights in the forward and again in the recomputation.

Collectives sum in f32 on the default stream, one leaf at a time (the
bucket sizes of the config are parsed and not acted on, as in JAX).
"""

import math

import torch

from ...comm import comm
from ...models.transformer import training_layer_views
from ...parallel.sharding import (optimizer_state_rules, shard_leaf, shard_shape, zero_rules,
                                  zero_specs)
from ...utils.tree import tree_map, tree_paths


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _merge(a, b):
    """The union of two trees of disjoint leaves, as new dicts."""
    out = {k: _merge(v, {}) if isinstance(v, dict) else v for k, v in a.items()}
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


class ZeroPartition:
    """Which dim of each leaf is split over ``degree`` data-parallel ranks,
    and the collectives that cut, gather and reduce along it, for a model
    trained at ZeRO ``stage`` (JAX ``DeepSpeedEngine`` shardings).

    ``persistence_threshold``: at stage 3, leaves of fewer elements keep
    the stage-1 layout (whole parameters, split optimizer state; JAX reads
    ``stage3_param_persistence_threshold`` only where the config sets it)."""

    def __init__(self, model, stage: int, degree: int, rank: int,
                 persistence_threshold: int = 0):
        self.degree, self.rank = degree, rank
        abstract, logical = model.abstract_params(), model.logical_axes()
        self.full_shapes = tree_map(lambda p: tuple(p.shape), abstract)
        params = zero_specs(abstract, logical, zero_rules(stage), degree)
        if stage >= 3 and persistence_threshold > 0:
            params = tree_map(lambda d, s: None if math.prod(s) < persistence_threshold else d,
                              params, self.full_shapes)
        self.param_dims = params
        self.opt_dims = zero_specs(abstract, logical, optimizer_state_rules(stage), degree)
        self.grad_dims = self.opt_dims if stage >= 2 else self.param_dims
        self._dims = [(path, p, o, g) for (path, p), (_, o), (_, g) in
                      zip(tree_paths(self.param_dims), tree_paths(self.opt_dims),
                          tree_paths(self.grad_dims))]
        # per leaf: whether its optimizer-layout gradient is a block
        self.split = [o is not None for _, _, o, _ in self._dims]
        # path -> f32 gradient shard of a split parameter (stage 3)
        self.grad_shards = {}

    # -- layout --

    def dims(self):
        """(path, param dim, optimizer dim, gradient dim) of every leaf, in
        ``tree_leaves`` order."""
        return self._dims

    def cut(self, t, dim):
        """Rank ``rank``'s block of ``t`` along ``dim`` (a contiguous tensor
        of its own), or ``t`` for None."""
        return shard_leaf(t, dim, self.rank, self.degree)

    def cut_init(self, path, t):
        """The part of a freshly drawn leaf this rank keeps
        (``CausalLM.init``'s ``cut``): layer leaves come one layer at a time,
        without the stacked leaf's leading layer dim."""
        dim = _get(self.param_dims, path)
        if dim is not None and path[0] == "layers":
            dim -= 1
        return self.cut(t, dim)

    def gather(self, t, dim):
        """The full tensor from every rank's block along ``dim``."""
        if dim is None:
            return t
        return comm.all_gather_into_tensor(t, dim=dim)

    def reduce_scatter(self, t, dim):
        return comm.reduce_scatter_tensor(t, dim=dim)

    def all_reduce(self, t, op=torch.distributed.ReduceOp.SUM):
        return comm.all_reduce(t, op=op)

    def tag(self, params):
        """Mark each split parameter with ``ds_dim``, its split dim, which
        ``zero.GatheredParameters`` reads."""
        for path, dim, _, _ in self.dims():
            if dim is not None:
                _get(params, path.split(".")).ds_dim = dim

    # -- the step --

    def opt_params(self, params):
        """The tree the optimizer updates: a split parameter as it is, the
        rank's block of a whole parameter whose optimizer state is split (a
        contiguous copy, gathered back by ``refresh``), else the
        parameter."""
        out = {}
        for path, pd, od, _ in self.dims():
            keys = path.split(".")
            p = _get(params, keys)
            _set(out, keys, p if pd is not None or od is None else self.cut(p.detach(), od))
        return out

    def refresh(self, params, opt_params):
        """Gather the updated blocks of whole parameters back into them
        (stages 1-2, and stage 3's persistent leaves)."""
        for path, pd, od, _ in self.dims():
            if pd is None and od is not None:
                keys = path.split(".")
                _get(params, keys).copy_(self.gather(_get(opt_params, keys), od))

    def reduce_grads(self, params):
        """Every leaf's gradient summed over the group, in the optimizer's
        layout, f32: split parameters' from ``grad_shards`` (reduced in the
        backward), the others' accumulated ``.grad`` all-reduced (and then
        cut where the optimizer state is split) or reduce-scattered."""
        out = {}
        for path, pd, od, gd in self.dims():
            keys = path.split(".")
            p = _get(params, keys)
            if pd is not None:
                g = self.grad_shards.get(path)
                if g is None:
                    g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            else:
                g = (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                if gd is not None:
                    g = self.reduce_scatter(g, gd)
                else:
                    g = self.cut(self.all_reduce(g), od)
            _set(out, keys, g)
        self.grad_shards.clear()
        return out

    def accumulate(self, path, index, g):
        """Add a reduced gradient block into the f32 gradient shard of the
        split parameter at ``path`` (layer ``index`` of a stacked leaf)."""
        keys = path.split(".")
        buf = self.grad_shards.get(path)
        if buf is None:
            shape = shard_shape(_get(self.full_shapes, keys), _get(self.param_dims, keys),
                                self.degree)
            buf = self.grad_shards[path] = torch.zeros(shape, dtype=torch.float32,
                                                       device=g.device)
        (buf if index is None else buf[index]).add_(g)


class _Gathered(torch.autograd.Function):
    """Forward: all-gather each block of ``items`` (cast to its dtype
    first: the bf16 cast of a shard travels, as the forward would cast the
    full leaf); backward: reduce-scatter each full gradient in f32 into its
    gradient shard. The blocks are not inputs of the graph: ``anchor``, a
    scalar that requires grad, makes autograd call the backward, so no
    gradient of a stacked shard is ever built whole."""

    @staticmethod
    def forward(ctx, anchor, part, items):
        ctx.part, ctx.items = part, items
        return tuple(part.gather(block.to(dt), dim) for block, dim, dt, _, _ in items)

    @staticmethod
    def backward(ctx, *grads):
        part = ctx.part
        for g, (_, dim, _, path, index) in zip(grads, ctx.items):
            part.accumulate(path, index, part.reduce_scatter(g.float(), dim))
        return None, None, None


class LayerGather:
    """Stage 3's parameter gathers for one forward of a ``CausalLM``
    (``CausalLM.loss(..., gather=)``): ``outer`` gathers the split leaves of
    ``embed`` and ``final_norm`` once, in their stored dtype (a tied
    embedding's two uses then sum their gradients in f32, as they do on one
    card); ``layer(i)`` gathers layer i's split leaves, the bf16 cast of
    each outside a norm group (as ``training_layer_views`` casts them) and
    the stored dtype inside one. Whole (persistent or indivisible) layer
    leaves are cast and unbound once a forward, as on one card."""

    def __init__(self, part: ZeroPartition, params, anchor, act_dtype, num_layers):
        self.part, self.params, self.anchor, self.dt = part, params, anchor, act_dtype
        self.split, whole = [], {}
        for path, pd, _, _ in part.dims():
            keys = path.split(".")
            if keys[0] != "layers":
                continue
            if pd is None:
                _set(whole, keys[1:], _get(params, keys))
            else:
                norm = any("norm" in k for k in keys[1:])
                self.split.append((path, keys[1:], pd - 1, norm))
        self.views = training_layer_views(whole, num_layers, act_dtype)

    def outer(self, params):
        """``params`` with the split leaves of ``embed`` and ``final_norm``
        gathered whole (``layers`` stays the shards)."""
        items, keys_of = [], []
        for path, pd, _, _ in self.part.dims():
            keys = path.split(".")
            if keys[0] != "layers" and pd is not None:
                p = _get(params, keys)
                items.append((p.detach(), pd, p.dtype, path, None))
                keys_of.append(keys)
        out = _merge(params, {})
        for keys, full in zip(keys_of, _Gathered.apply(self.anchor, self.part, items)):
            _set(out, keys, full)
        return out

    def layer(self, i):
        """Layer ``i``'s parameter tree, whole, for the layer function."""
        items = []
        for path, keys, dim, norm in self.split:
            p = _get(self.params["layers"], keys)
            items.append((p.detach()[i], dim, p.dtype if norm else self.dt, path, i))
        tree = {}
        for (_, keys, _, _), full in zip(self.split, _Gathered.apply(self.anchor, self.part,
                                                                      items)):
            _set(tree, keys, full)
        return _merge(tree, self.views[i])


class GlobalSum(torch.autograd.Function):
    """The group's sum of this rank's scalar term, differentiated as the
    term alone: every rank sees the global loss, and each backward gives
    its own rows' gradients (the step then sums them over the group)."""

    @staticmethod
    def forward(ctx, local):
        return comm.all_reduce(local.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return g
