"""Optimizers as ``(init, update)`` pairs over parameter trees (the
reference's optax-style ``repro.optim.base``).

An ``Optimizer`` is a NamedTuple of two functions:
  init(params) -> state
  update(grads, state, params, lr) -> (updates, state)
``updates`` are ADDED to the params (sign convention: update = -lr *
direction). State tensors are float32; step counts are host ``int``s, so no
step waits on the device. ``lr`` is a host float (a schedule's value).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.common.tree import tree_map, tree_norm


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params, updates):
    """params + updates in f32, each leaf cast back to its own dtype."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the whole tree so that its global l2 norm is at most
    ``max_norm``. Returns (clipped grads, the norm before clipping); the
    scale is f32, so a lower-precision leaf comes back in f32, as the
    reference's promotion gives it."""
    norm = tree_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), norm
