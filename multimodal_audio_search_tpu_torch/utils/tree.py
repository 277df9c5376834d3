"""Trees of tensors: the port's pytrees.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
arrays, or numbers) as leaves; ``None`` is an empty subtree, as in JAX.
The optimizer states of training/finetune.py are NamedTuples named as
optax's, so a leaf's path string (``path_str``) is the key JAX's
``utils/checkpoint.py::_path_str`` gives the same leaf: a dict key as
it is, a list or tuple index as a number, a NamedTuple field as
``.field`` (``1/0/.mu/decoder/ln/scale``).
"""
from __future__ import annotations

from typing import Any, Callable


def is_state(x) -> bool:
    """Whether ``x`` is a NamedTuple (a node whose children are named)."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> list[tuple[str, Any]] | None:
    """(path element, child) of a node, None for a leaf."""
    if isinstance(x, dict):
        return [(str(k), v) for k, v in x.items()]
    if is_state(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    return None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return dict(zip(node.keys(), values))
    if is_state(node):
        return type(node)(*values)
    return type(node)(values)


def tree_map(fn: Callable, tree, *rest):
    """fn(leaf, *leaves of ``rest`` at the same place) over the leaves of
    ``tree``; ``rest`` are trees of the same structure. None stays None."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: tuple = ()):
    """fn(path, leaf, *leaves of ``rest`` at the same place), the path as
    in ``tree_leaves_with_path``. None stays None."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree, *rest)
    others = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [
        tree_map_with_path(fn, c, *(o[i] for o in others),
                           prefix=prefix + (k,))
        for i, (k, c) in enumerate(kids)])


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the tree's order; a path is its elements'
    strings (``path_str`` joins them)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, c in kids:
        out += tree_leaves_with_path(c, prefix + (k,))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in tree_leaves' order) in
    place of its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def path_str(path: tuple) -> str:
    return "/".join(path)
