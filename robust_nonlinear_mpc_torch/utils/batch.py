"""Helpers for the written-out batch dimension.

The JAX package runs one problem per function call and batches with
`jax.vmap`; the port carries the batch as the leading dimension of every
tensor. A reduction that `vmap` made per-problem is a reduction over all
dimensions but the first here, and a per-problem `jnp.where` on a scalar
condition becomes a select with the (B,) mask broadcast over the rest.
"""

from __future__ import annotations

from typing import Callable

import torch


def lane_where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-lane select: `new` where mask[b], else `old`, with the (B,) mask
    broadcast over the rest. A select, never a multiply, so NaNs in the
    rejected branch cannot leak."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def lane_sum(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).sum(dim=1)


def lane_max(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).amax(dim=1)


def lane_min(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).amin(dim=1)


def lane_max_abs(*ts: torch.Tensor) -> torch.Tensor:
    """Per-lane max |t| over several tensors (JAX `_max_abs` under vmap)."""
    return torch.stack([lane_max(t.abs()) for t in ts]).amax(dim=0)


def lane_all_finite(*ts: torch.Tensor) -> torch.Tensor:
    out = None
    for t in ts:
        f = torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
        out = f if out is None else out & f
    return out


def tree_map(fn: Callable, tree, *rest):
    """Map over NamedTuples / tuples of tensors (a small `jax.tree_util`)."""
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree):
    """The tensors of a tree of NamedTuples / tuples, in order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [] if tree is None else [tree]


def tree_where(mask: torch.Tensor, new, old):
    """Per-lane select over a whole state tree."""
    return tree_map(lambda n, o: lane_where(mask, n, o), new, old)
