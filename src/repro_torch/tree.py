"""Parameter and state trees: nested dicts, lists, tuples and NamedTuples
whose leaves are tensors (the port's counterpart of jax pytrees).

Dict keys are walked in sorted order, as `jax.tree_util` does, so leaf
orders (and the sums taken over them) match the reference's.  Anything
that is neither a container nor a tensor (an int, a shape tuple's entries,
None) is static: kept as it is by `tree_map`, absent from `leaves`.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied at every tensor leaf of `tree`, with the subtrees of
    `rest` found at the same place (they may be deeper there, as jax's
    `flatten_up_to`); containers are rebuilt, static leaves kept."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, paths joined by '/' (dict keys,
    NamedTuple field names, sequence indices), dict keys in sorted order."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return []
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def leaves(tree: Any) -> list[torch.Tensor]:
    return [t for _, t in flatten(tree)]


def unflatten_like(like: Any, values: dict[str, torch.Tensor]) -> Any:
    """`like` with each tensor leaf replaced by values[its path]."""
    def walk(node, prefix):
        if torch.is_tensor(node):
            return values[prefix]
        join = (lambda k: f"{prefix}/{k}" if prefix else str(k))
        if isinstance(node, dict):
            return {k: walk(v, join(k)) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, join(f)) for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, join(i)) for i, v in enumerate(node))
        return node
    return walk(like, "")
