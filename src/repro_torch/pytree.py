"""Dict / list trees of tensors walked in ``jax.tree_util`` order.

The port keeps parameters, optimizer state and checkpoints as plain
nested dicts and lists, as the reference keeps its pytrees.  Where the
reference's results depend on the order of the leaves (the summed
squares of ``global_norm``, the files of a checkpoint), the port walks
its trees as ``jax.tree_util`` flattens them: dict keys sorted, lists
and tuples in order, ``None`` a node without leaves.  A leaf's path is
its keys and list indices joined with ``/`` (the strings the
reference's ``tree_flatten_with_path`` keys give).
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any) -> list:
    """The leaves in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def leaf_paths(tree: Any, prefix: tuple = ()) -> list[str]:
    """``/``-joined key path of each leaf, in :func:`flatten` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (str(i),))]
    return ["/".join(prefix)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`flatten` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def tree_map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf, keeping the structure; ``path``
    is the tuple of keys and list indices (as strings) down to the leaf,
    the keys of ``jax.tree_util.tree_map_with_path``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
