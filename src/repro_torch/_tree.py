"""Nested dicts, lists and tuples of tensors as trees: the few pytree
operations of ``jax.tree_util`` that the port needs.

A leaf's path is its keys and indices joined by ``"/"`` (``lstm/0/w_x``,
``fcl/w``), the names the reference builds from
``tree_flatten_with_path``.  Dicts keep their insertion order (two trees
are matched by key, never by leaf order), and named tuples
(``AdamState``) are rebuilt as their own type.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(node: Any, values: List[Any]) -> Any:
    if isinstance(node, dict):
        return dict(zip(node.keys(), values))
    if hasattr(node, "_fields"):                     # a named tuple
        return type(node)(*values)
    return type(node)(values)


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in tree order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_path(child, _join(prefix, key))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """The same structure with every leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, child, _join(prefix, key))
                           for key, child in kids])


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which have the structure of ``tree`` (dicts are matched by
    key, whatever their order).  ``is_leaf(node)`` true stops the descent
    there (a tuple that is one value, such as a partition spec)."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return _rebuild(tree, [tree_map(fn, child, *(r[i] for r in rest),
                                    is_leaf=is_leaf)
                           for i, (_, child) in enumerate(kids)])
