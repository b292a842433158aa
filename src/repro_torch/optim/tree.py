"""Nested dicts, lists and tuples of tensors: the pytrees the optimizer
walks (``ParamTree.tree()``, gradients, moments, residuals)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in a fixed order: dict values as given,
    sequence items by index (the order of ``ParamTree.parameters()``)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, values: Iterable[Any]):
    """A tree shaped as ``like`` holding ``values`` in :func:`leaves`'
    order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the matching leaves of ``tree`` and ``rest``, in a tree
    shaped as ``tree``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, (fn(*xs) for xs in zip(leaves(tree), *others)))
