"""Pytrees of dicts and lists of torch tensors: the few ``jax.tree``
functions that the training path uses.

Leaves are visited as ``jax.tree.leaves`` visits them: dict keys in
sorted order, lists in order.  So a sum over the leaves (AdamW's global
norm) adds them in the JAX package's order.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _is_node(tree, is_leaf) -> bool:
    if is_leaf is not None and is_leaf(tree):
        return False
    return isinstance(tree, (dict, list, tuple))


def leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if not _is_node(tree, is_leaf):
        return [tree]
    out = []
    for child in _children(tree):
        out.extend(leaves(child, is_leaf))
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; dicts stay dicts (in ``tree``'s key order),
    lists and tuples come back as lists."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree)]


def unflatten_like(tree, values: list):
    """A tree of ``tree``'s structure whose leaves, in ``leaves`` order,
    are ``values``."""
    it = iter(values)

    def build(t):
        if not _is_node(t, None):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        return [build(v) for v in t]

    return build(tree)
