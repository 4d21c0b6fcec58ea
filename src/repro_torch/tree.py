"""Nested containers of tensors (parameters, optimizer state, gradients,
batches), walked in `jax.tree`'s leaf order: a dict's values by sorted
key, a list's or tuple's (a NamedTuple's fields included) in order.
None is an empty subtree; anything else is a leaf, and so is a tuple
whose class sets `tree_leaf` (a partition spec, `sharding.Spec`)."""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, List


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _container(x: Any) -> bool:
    return isinstance(x, (list, tuple)) and not getattr(x, "tree_leaf",
                                                        False)


def leaves(tree: Any) -> List[Any]:
    """The leaves in order."""
    return list(_walk(tree))


def _walk(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key])
    elif _container(tree):
        for sub in tree:
            yield from _walk(sub)
    else:
        yield tree


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure), in a tree of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if _container(tree):
        return type(tree)(map_leaves(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of `like`'s structure holding `new_leaves` in leaf order."""
    if len(new_leaves) != len(leaves(like)):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(leaves(like))}")
    # map_leaves keeps a dict's insertion order, `leaves` walks sorted
    # keys: number the leaves in leaf order first, then look each one up
    return map_leaves(lambda n: new_leaves[n], _number(like))


def _number(like: Any) -> Any:
    """`like` with each leaf replaced by its index in `leaves(like)`."""
    counter = itertools.count()

    def walk(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            out = {k: walk(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}
        if _is_namedtuple(tree):
            return type(tree)(*(walk(v) for v in tree))
        if _container(tree):
            return type(tree)(walk(v) for v in tree)
        return next(counter)

    return walk(like)
