"""Nested dicts, lists and tuples of tensors: the port's stand-in for the
few `jax.tree_util` walks that training needs.

Traversal follows each dict's own key order, so `tree_leaves` and
`tree_map` of one tree visit the leaves in the same order.  `is_leaf`
stops the walk at a node (packed optimizer moments are {"w", "s"}
dicts treated as one leaf).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def tree_paths(tree, is_leaf: IsLeaf = None, prefix: str = ""
               ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] with paths like "layers/attn/wq"; None is no leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_paths(v, is_leaf, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """fn over the leaves of `tree` and the matching nodes of `rest`,
    keeping `tree`'s structure (NamedTuples rebuilt from their fields)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*seq)
        return type(tree)(seq)
    if tree is None:
        return None
    return fn(tree, *rest)
