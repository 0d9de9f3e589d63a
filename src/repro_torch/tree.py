"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

A tree is made of dicts, lists and tuples; everything else is a leaf
(tensors, ``GSEPacked``, ``None``).  ``is_leaf`` stops the walk early, as
in ``jax.tree.map``.
"""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_leaves_sorted"]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the containers."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in container order."""
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def tree_leaves_sorted(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: a dict's
    entries by sorted key (lists, tuples and NamedTuples in order).  Where
    the reference sums over its leaves (a gradient's global norm), the port
    sums in this order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves_sorted(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves_sorted(v, is_leaf)]
    return [tree]
