"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

The JAX package keeps parameters, gradients and optimizer slots as pytrees
of nested dicts; the port keeps the same trees of tensors. Leaves are
visited in sorted-key order, the order ``jax.tree`` flattens dicts in, so
the trees of two packages line up leaf for leaf.
"""


def tree_leaves(tree, is_leaf=None):
    """The leaves of a nested dict, in sorted-key order. ``is_leaf(node)``
    may stop the descent at a dict."""
    if not isinstance(tree, dict) or (is_leaf is not None and is_leaf(tree)):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]


def tree_paths(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested dict, in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree)
            for pair in tree_paths(tree[k], f"{prefix}.{k}" if prefix else k)]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    for other in rest:
        if not isinstance(other, dict) or set(other) != set(tree):
            raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                             f"{sorted(other) if isinstance(other, dict) else type(other)}")
    return {k: tree_map(fn, tree[k], *(o[k] for o in rest)) for k in tree}
