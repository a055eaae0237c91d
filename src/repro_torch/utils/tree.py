"""Small tree utilities over the port's parameter and train-state trees
(``repro.utils.tree`` without JAX's pytrees).

A tree is a dict (flattened in sorted key order, as JAX flattens dicts),
a list or tuple (in order), a NamedTuple (in field order) or a leaf (a
tensor, an array or a number).  A leaf's path name joins the keys,
indices and field names on the way to it with "/", as the JAX package's
checkpoint names them ("params/layers/0/attn/wq", "opt/count").
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(name, child) pairs of an inner node; [] for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path name, leaf) of every leaf, in flattening order."""
    if _is_leaf(tree):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from tree_paths(child, f"{prefix}/{name}" if prefix else name)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    out = [tree_map(fn, c, *(r[i] for r in rest))
           for i, c in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*out)
    return type(tree)(out)


def to_numpy(leaf) -> np.ndarray:
    """A tensor (on any device; bf16 as f32, which numpy lacks) or an
    array-like as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in flattening
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _shaped(tree) -> Iterator[Any]:
    """Every leaf with a ``shape``, a ``ParamSpec`` (a NamedTuple with
    one) taken whole."""
    if hasattr(tree, "shape"):
        yield tree
        return
    for _, child in _children(tree):
        yield from _shaped(child)


def count_params(tree) -> int:
    """Total number of scalar parameters in a tree of tensors (real,
    ``meta`` or fake) or ``ParamSpec`` leaves."""
    return int(sum(math.prod(leaf.shape) for leaf in _shaped(tree)))


def param_bytes(tree) -> int:
    """Total bytes of the leaves of a tree that have a shape and a dtype
    (tensors on any device; a ``ParamSpec`` has no dtype)."""
    return int(sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                   for leaf in _shaped(tree) if hasattr(leaf, "dtype")))


def tree_map_with_path_names(fn: Callable, tree):
    """``tree_map`` where ``fn`` receives ("a/b/c", leaf)."""
    names = iter([name for name, _ in tree_paths(tree)])
    return tree_map(lambda leaf: fn(next(names), leaf), tree)
