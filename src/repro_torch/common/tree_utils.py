"""Trees of tensors, shared by the optimizer, checkpoint and trainer layers.

A tree is what the JAX package calls a pytree: dicts (flattened in sorted key
order), NamedTuples (in field order), lists and tuples, with ``None`` holding no
leaf; every other object is a leaf. An ``nn.Module`` counts as the tree of its
named parameters (``a.b.0`` becomes the path ``a/b/0``), for reading only.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch
from torch import nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Iterator[tuple[str, Any]] | None:
    """(path component, child) pairs of a node, or None for a leaf."""
    if tree is None:
        return iter(())
    if isinstance(tree, nn.Module):
        return ((name.replace(".", "/"), p) for name, p in tree.named_parameters())
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if _is_namedtuple(tree):
        return zip(tree._fields, tree)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def flatten_with_paths(tree: Any) -> dict[str, Any]:
    """Flatten a tree into {'a/b/0': leaf}, in the JAX package's leaf order.
    An explicit stack, not a recursive closure: a closure that calls itself
    is a reference cycle, which would keep every leaf alive until the next
    garbage collection."""
    out = {}
    stack = [("", tree)]
    while stack:
        prefix, node = stack.pop()
        kids = _children(node)
        if kids is None:
            out[prefix] = node
            continue
        stack.extend(reversed([(f"{prefix}/{key}" if prefix else key, child) for key, child in kids]))
    return out


def tree_leaves(tree: Any) -> list:
    return list(flatten_with_paths(tree).values())


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``),
    in leaf order, in a tree of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        raise TypeError("tree_map builds a new tree; pass the module's parameters as a tree, not the module")
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *vals) for vals in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vals) for vals in zip(tree, *rest))
    return fn(tree, *rest)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """The sum over leaves of each pair's inner product, in float32, added in
    leaf order as ``jax.tree.reduce`` adds them."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.vdot(x.reshape(-1), y.reshape(-1)).to(torch.float32)
        total = d if total is None else total + d
    return torch.zeros((), dtype=torch.float32) if total is None else total


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; the per-leaf sums
    are added one after another in leaf order, as ``jax.tree.reduce`` does."""
    total = None
    for x in tree_leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Floating leaves cast to ``dtype`` (a leaf already of ``dtype`` is returned
    as it is); other leaves pass through."""
    return tree_map(lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def param_count(tree: Any) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


def param_bytes(tree: Any) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))
