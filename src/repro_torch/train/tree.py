"""Nested dicts of tensors, the port's pytrees.

The counterpart of ``jax.tree_util`` for the shapes the training stack
uses: parameters, adapters, optimizer states and train states are dicts
(nested to any depth) whose leaves are tensors or plain values. A leaf's
path is its keys joined by ``/`` (``"layers/attn/wq"``), as
``jax.tree_util.tree_flatten_with_path`` keys it in the reference, and
leaves come in sorted key order, as JAX flattens a dict.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "unflatten", "tree_map", "leaves"]


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in sorted key order; a non-dict is one leaf."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for k in sorted(tree):
        out += flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree: Any) -> list[Any]:
    return [v for _, v in flatten(tree)]


def unflatten(like: Any, values: list[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves, in :func:`flatten` order,
    are ``values``."""
    it = iter(values)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        return {k: build(t[k]) for k in sorted(t)}
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
