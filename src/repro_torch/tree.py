"""Nested-dict parameter trees with the reference's leaf order.

JAX flattens a dict pytree in sorted-key order; the port keeps that order
everywhere a leaf loop or a per-leaf state list is indexed (the tau table's
worker columns are per worker, the rings and payloads per leaf), so leaf
``i`` here is leaf ``i`` of ``jax.tree.leaves`` on the same tree.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def flatten(tree) -> tuple[list, Any]:
    """-> (leaves in sorted-key order, treedef)."""
    if _is_leaf(tree):
        return [tree], None
    leaves, defs = [], {}
    for key in sorted(tree):
        sub, d = flatten(tree[key])
        leaves.extend(sub)
        defs[key] = (d, len(sub))
    return leaves, defs


def unflatten(treedef, leaves: list):
    if treedef is None:
        (leaf,) = leaves
        return leaf
    out, i = {}, 0
    for key in sorted(treedef):
        d, n = treedef[key]
        out[key] = unflatten(d, leaves[i:i + n])
        i += n
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def paths(tree, prefix: str = "") -> list[str]:
    """'/'-joined key paths of the leaves, in leaf order."""
    if _is_leaf(tree):
        return [prefix]
    out = []
    for key in sorted(tree):
        out.extend(paths(tree[key], f"{prefix}/{key}" if prefix else key))
    return out


def tree_map(fn: Callable, tree, *rest):
    flat, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
