"""Nested-dict trees of tensors: the port's stand-in for the pytrees of
the reference's training state.

A tree is a ``Mapping`` of trees or a leaf; the flattening functions
also walk a ``NamedTuple`` of trees (the training state). Leaves are
visited in the reference's order: a mapping's keys sorted, a named
tuple's fields in order, as JAX flattens them. :func:`tree_items` gives
each leaf with its key in the form the reference's checkpoint writes
(``".params/dense_layers/attn/wq"``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the nodes of ``rest`` at
    the same place as further arguments. ``tree`` alone decides where the
    leaves are, so a node of ``rest`` may be a subtree (the Adafactor
    state has a dict where a parameter has a tensor)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the reference's leaf order; the key is the
    reference checkpoint's: path parts joined by ``/``, a field of a
    named tuple written ``.field``."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from tree_items(v, prefix + (f".{f}",))
    else:
        yield "/".join(prefix), tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` with ``leaves`` (in ``tree_items``
    order) in place of its leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        return next(it)

    return build(like)
