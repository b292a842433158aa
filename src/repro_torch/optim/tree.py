"""Nested dicts, lists and tuples of tensors: the pytrees the optimizer
walks (``ParamTree.tree()``, gradients, moments, residuals) and the decode
caches.  A ``NamedTuple`` (``AdamWState``, ``KVCache``, …) is a tuple whose
fields are its children, rebuilt as its own type.  A tuple type that sets
``tree_leaf = True`` (``repro_torch.parallel.PartitionSpec``) is a leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _is_node(t) -> bool:
    return (isinstance(t, (dict, list, tuple))
            and not getattr(type(t), "tree_leaf", False))


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in a fixed order: dict values as given,
    sequence items by index (the order of ``ParamTree.parameters()``)."""
    if not _is_node(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [x for v in tree for x in leaves(v)]


def leaves_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` in :func:`leaves`' order; a path holds the dict keys
    and ``NamedTuple`` field names (str) and sequence indices (int) from
    the root down."""
    if not _is_node(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))


def unflatten(like, values: Iterable[Any]):
    """A tree shaped as ``like`` holding ``values`` in :func:`leaves`'
    order."""
    return _build(like, iter(values))


def _build(t, it):
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle, which would hold ``values`` (a step's
    # gradients) until Python's cycle collector happens to run
    if not _is_node(t):
        return next(it)
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if _is_namedtuple(t):
        return type(t)(*(_build(v, it) for v in t))
    return type(t)(_build(v, it) for v in t)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the matching leaves of ``tree`` and ``rest``, in a tree
    shaped as ``tree``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, (fn(*xs) for xs in zip(leaves(tree), *others)))
