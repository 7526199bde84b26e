"""Small shared helpers for abstract (``meta``) tensors and their sizes.

Port of ``repro.utils``.  "Abstract" is a tensor on the ``meta`` device:
a shape and a dtype, no storage, which is what the dry run drives a step
with (the reference's ``jax.ShapeDtypeStruct``).  A tree is a tensor, a
dict / list / tuple of trees, or an ``nn.Module`` (its named parameters).
"""
from __future__ import annotations

from typing import Iterator

import torch
from torch import nn


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of ``tree``, in insertion order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from (p for _, p in tree.named_parameters())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)


def map_tree(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)`` (a module maps
    to the dict of its named parameters)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, nn.Module):
        return {k: fn(p) for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return tree


def zeros(shape, dtype, abstract: bool = False, device=None) -> torch.Tensor:
    if abstract:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def stack_tree(tree, n: int, abstract: bool = False):
    """Prepend a leading axis of size n to every tensor (the copies are
    views of one another unless ``abstract``)."""
    if abstract:
        return map_tree(lambda x: torch.empty((n,) + tuple(x.shape),
                                              dtype=x.dtype, device="meta"),
                        tree)
    return map_tree(lambda x: x.expand((n,) + tuple(x.shape)), tree)


def abstract_like(tree):
    return map_tree(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def tree_size(tree) -> int:
    return sum(x.numel() for x in leaves(tree))
