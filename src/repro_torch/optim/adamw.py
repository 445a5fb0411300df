"""AdamW with f32 moments (the LM pretrain example's optimizer)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.optim.base import Optimizer


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam's moments m, v (f32 trees) and the step count ``t`` (a host
    int); the bias corrections 1 - b**t in float32, as the reference
    computes them, and decoupled weight decay on the f32 parameters."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(t))
        bc2 = float(one - np.float32(b2) ** np.float32(t))

        def upd(m_, v_, p):
            step = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
            return -lr * (step + weight_decay * p.float())

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
