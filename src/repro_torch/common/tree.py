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


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b) -> torch.Tensor:
    """Sum of elementwise products across the whole tree (float32
    accumulation, leaf by leaf in sorted-key order)."""
    return sum(torch.sum(x.float() * y.float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_sq_norm(a) -> torch.Tensor:
    """Squared l2 norm of the flattened tree (float32 accumulation)."""
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(a))


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_size(a) -> int:
    """Total number of scalar parameters (a host int)."""
    return int(sum(x.numel() for x in tree_leaves(a)))


def tree_weighted_sum(trees, weights):
    """sum_i weights[i] * trees[i] for a list of trees, in float32, each
    leaf cast back to the first tree's dtype."""
    def leaf_sum(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        w = torch.as_tensor(weights, device=stacked.device).float().reshape(
            (-1,) + (1,) * (stacked.dim() - 1))
        return torch.sum(stacked * w, dim=0).to(leaves[0].dtype)

    return tree_map(leaf_sum, *trees)


def tree_cast(a, dtype):
    """Floating-point leaves cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


def tree_all_finite(a) -> torch.Tensor:
    return torch.stack([torch.all(torch.isfinite(x))
                        for x in tree_leaves(a)]).all()


def flatten_to_vector(a):
    """All leaves as one f32 vector, in sorted-key order. Returns ``(vec,
    unflatten)``; ``unflatten`` restores the shapes and dtypes."""
    leaves = tree_leaves(a)
    vec = torch.cat([l.float().reshape(-1) for l in leaves])

    def unflatten(v):
        return unflatten_from_vector(v, a)

    return vec, unflatten


def unflatten_from_vector(vec, like):
    """Reshape a flat vector into the structure, shapes and dtypes of
    ``like``."""
    out, off = [], 0
    for l in tree_leaves(like):
        n = l.numel()
        out.append(vec[off:off + n].reshape(l.shape).to(l.dtype))
        off += n
    return tree_unflatten_like(like, out)


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

    def flatten(self, tree, members: bool = False) -> torch.Tensor:
        """Tree -> contiguous (d,) f32 vector (a fresh tensor); with
        ``members``, a tree of (B, *shape) leaves -> (B, d)."""
        if members:
            return torch.cat([l.float().reshape(l.shape[0], -1)
                              for l in tree_leaves(tree)], dim=1)
        return torch.cat([l.float().reshape(-1) for l in tree_leaves(tree)])

    def unflatten(self, vec: torch.Tensor):
        """(d,) vector -> tree of views into ``vec`` with the template's
        shapes; a (B, d) stack -> tree of (B, *shape) views. Views, not
        copies: callers never write into them."""
        lead = tuple(vec.shape[:-1])
        leaves = [vec[..., o:o + n].view(lead + s) for o, n, s in
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
