"""Parameter-tree arithmetic of the port.

Parameters are plain nested ``dict[str, ...]`` trees of tensors. Leaf order
is the reference's ``jax.tree_util`` order — sorted keys at every level —
because the sketch's per-leaf seeds (``core.sketch.leaf_seed_host(seed,
i)``) and the digest probe index the flat vector by that order.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (``jax.tree_util.tree_leaves`` of a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves):
    """Rebuild ``template``'s structure from leaves in sorted-key order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(template)


def grad(loss_fn: Callable, params, *args):
    """Gradient tree of ``loss_fn(params, *args)`` at ``params`` (the values
    are not modified; autograd runs on detached aliases)."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    return tree_unflatten_like(p, torch.autograd.grad(loss_fn(p, *args), leaves))


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_sq_norm(a) -> torch.Tensor:
    """Squared l2 norm of the flattened tree (float32 accumulation)."""
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(a))


def ring_update(data: torch.Tensor, row: torch.Tensor, count: int) -> int:
    """Write ``row`` into slot ``count % capacity`` of the stacked ring
    ``data`` IN PLACE and return the slot. The ring is server-private, so
    the in-place write aliases nothing a caller holds."""
    slot = count % data.shape[0]
    data[slot] = row
    return slot


class FlatSpec:
    """Flatten-once descriptor of a tree's flat f32 layout: the contiguous
    ``(d,)`` vector the server core operates on, leaves concatenated in
    sorted-key order."""

    def __init__(self, template):
        self._paths = _paths(template)
        leaves = tree_leaves(template)
        self.shapes = tuple(tuple(l.shape) for l in leaves)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.offsets = tuple(np.cumsum((0,) + self.sizes)[:-1].tolist())
        self.size = int(sum(self.sizes))

    def _sig(self):
        return (self._paths, self.shapes)

    def __eq__(self, other):
        return isinstance(other, FlatSpec) and self._sig() == other._sig()

    def __hash__(self):
        return hash(self._sig())

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> contiguous (d,) f32 vector (a fresh tensor)."""
        return torch.cat([l.float().reshape(-1) for l in tree_leaves(tree)])

    def unflatten(self, vec: torch.Tensor):
        """(d,) vector -> tree of views into ``vec`` with the template's
        shapes. Views, not copies: callers never write into them."""
        leaves = [vec[o:o + n].view(s) for o, n, s in
                  zip(self.offsets, self.sizes, self.shapes)]
        out: dict = {}
        for path, leaf in zip(self._paths, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out


def _paths(tree, prefix=()) -> tuple:
    if isinstance(tree, dict):
        return tuple(p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,)))
    return (prefix,)
