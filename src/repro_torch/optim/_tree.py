"""The few pytree operations the optimizer and the train step need, over
the port's param trees (dicts, lists and tuples of tensors).  Leaves come
in JAX's order: dict keys sorted, sequences in order; None holds no
leaf, as in JAX."""

from __future__ import annotations

from typing import Callable, Iterator


def leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's key path (dict keys and sequence indices), in
    ``leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, prefix + (i,))]
    return [prefix]


def unflatten(like, flat) -> object:
    """A tree of ``like``'s structure with ``flat``'s leaves, in order."""
    it = iter(flat)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _build(like, it: Iterator):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_build(v, it) for v in like)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees of its structure in
    ``rest``, leaf by leaf."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
