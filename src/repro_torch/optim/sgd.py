"""SGD and SGD with momentum (the paper's client optimizer is plain SGD)."""
from __future__ import annotations

import torch

from repro_torch.common.tree import tree_map
from repro_torch.optim.base import Optimizer


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: -lr * g.float(), grads), state

    return Optimizer(init, update)


def sgd_momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum m <- beta m + g (f32), update -lr m; with
    ``nesterov`` the update is -lr (beta m + g)."""
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(grads, state, params, lr):
        state = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -(lr * (beta * m + g.float())), state,
                           grads)
        else:
            upd = tree_map(lambda m: -lr * m, state)
        return upd, state

    return Optimizer(init, update)
