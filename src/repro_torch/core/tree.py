"""Nested containers of tensors (the JAX package's pytrees): ``None``,
tuples, lists and dicts of leaves."""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and structurally equal ``rest``;
    ``None`` stays ``None``."""

    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
