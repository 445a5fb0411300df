"""Parameter sensitivity (paper Eq. 3-8).

    s_i = | g_i * theta_i  -  1/2 * F_ii * theta_i^2 |          (Eq. 8)
    F_ii = mean_k ( (d loss_k / d theta_i)^2 )                  (Eq. 6)

Both the gradient and the empirical-Fisher diagonal are evaluated on the
shared calibration batch D_b; the Fisher mean runs over ``num_micro``
consecutive microbatches of it, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.tree import grad, tree_map


def fisher_diagonal(loss_fn: Callable, params, calib_batch: dict,
                    num_micro: int = 4):
    """Empirical Fisher diagonal: mean over microbatches of squared grads.
    ``loss_fn(params, batch) -> scalar``."""
    B = next(iter(calib_batch.values())).shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} % microbatches {num_micro} != 0")
    mb = B // num_micro
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for i in range(num_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in calib_batch.items()}
        g = grad(loss_fn, params, micro)
        acc = tree_map(lambda a, gi: a + torch.square(gi.float()), acc, g)
    return tree_map(lambda a: a / num_micro, acc)


def sensitivity_from_parts(params, grads, fisher):
    """|g*theta - 0.5*F*theta^2| elementwise over the tree (f32)."""
    return tree_map(lambda p, g, f: torch.abs(g.float() * p.float()
                                              - 0.5 * f * torch.square(p.float())),
                    params, grads, fisher)


def sensitivity(loss_fn: Callable, params, calib_batch: dict,
                num_micro: int = 4):
    """Eq. 8 sensitivity tree."""
    g = grad(loss_fn, params, calib_batch)
    fisher = fisher_diagonal(loss_fn, params, calib_batch, num_micro)
    return sensitivity_from_parts(params, g, fisher)
