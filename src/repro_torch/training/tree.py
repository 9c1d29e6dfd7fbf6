"""Parameter trees of the training path: nested dicts and lists with
tensor leaves (the reference's pytrees), walked in JAX's flatten order:
a dict's keys sorted, a list in order. The checkpoint's leaf files and
the optimizer's moments follow that order, so both packages number the
leaves alike."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values`` in JAX's
    flatten order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])


def treedef_str(tree) -> str:
    """The tree's structure in the form of JAX's ``str(treedef)``, for
    the checkpoint manifest (which neither package reads back)."""
    def inner(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {inner(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ", ".join(inner(x) for x in t) + "]"
        return "*"
    return f"PyTreeDef({inner(tree)})"
