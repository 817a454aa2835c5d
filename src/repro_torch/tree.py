"""Trees of tensors as the port keeps them (nested dicts, tuples and
lists), walked in the reference's order.

The reference's pytrees flatten a dict by its sorted keys and name a
leaf by its key path (``jax.tree_util.keystr``: ``['layers']['attn']
['wq']``, ``[0]`` for a sequence index).  The optimizer's decay mask and
the checkpoint's leaf names are read off these paths, so the port walks
its trees the same way.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

Path = Tuple


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, object]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, sequences in order.  A path is a tuple of dict keys and
    sequence indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List:
    """The leaves in the reference's order."""
    return [x for _, x in leaves_with_path(tree)]


def unflatten(tree, values) -> object:
    """``tree``'s containers with its leaves replaced, in the reference's
    order, by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path: ``[repr(key)]`` per step."""
    return "".join(f"[{p!r}]" for p in path)


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of equally shaped trees, keeping each
    container's type and each dict's own key order."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)
