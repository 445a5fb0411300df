"""Parameter sensitivity (paper Eq. 3-8).

    s_i = | g_i * theta_i  -  1/2 * F_ii * theta_i^2 |          (Eq. 8)
    F_ii = mean_k ( (d loss_k / d theta_i)^2 )                  (Eq. 6)

Both the gradient and the empirical-Fisher diagonal are evaluated on the
shared calibration batch D_b; the Fisher mean runs over ``num_micro``
consecutive microbatches of it, as in the reference. ``grad_and_fisher``
takes both with respect to flat parameter rows, one member or a whole
wave of them at once.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.tree import FlatSpec, grad, tree_map


def _flat_grad_fn(loss_fn: Callable, spec: FlatSpec, w: torch.Tensor):
    """batch -> the gradient of ``loss_fn`` at flat parameters ``w`` as a
    tensor of w's shape: the loss sees ``spec.unflatten`` views of one leaf
    tensor, so one ``torch.autograd.grad`` gives the flat gradient. A loss
    that returns (B,) per-member losses is summed: members are independent,
    so row b is member b's gradient."""
    leaf = w.detach().float().requires_grad_(True)

    def flat_grad(batch):
        loss = torch.sum(loss_fn(spec.unflatten(leaf), batch))
        return torch.autograd.grad(loss, leaf)[0]

    return flat_grad


def _fisher(flat_grad: Callable, calib_batch: dict, num_micro: int):
    """Mean over ``num_micro`` consecutive microbatches of the squared flat
    gradients, accumulated in place into one buffer."""
    B = next(iter(calib_batch.values())).shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} % microbatches {num_micro} != 0")
    mb = B // num_micro
    acc = None
    for i in range(num_micro):
        gi = flat_grad({k: v[i * mb:(i + 1) * mb]
                        for k, v in calib_batch.items()})
        if acc is None:
            acc = torch.zeros_like(gi)
        acc.addcmul_(gi, gi)
    return acc.div_(num_micro)


def fisher_diagonal(loss_fn: Callable, params, calib_batch: dict,
                    num_micro: int = 4):
    """Empirical Fisher diagonal tree: mean over microbatches of squared
    grads. ``loss_fn(params, batch) -> scalar``."""
    spec = FlatSpec(params)
    flat_grad = _flat_grad_fn(loss_fn, spec, spec.flatten(params))
    return spec.unflatten(_fisher(flat_grad, calib_batch, num_micro))


def grad_and_fisher(loss_fn: Callable, spec: FlatSpec, w: torch.Tensor,
                    calib_batch: dict, num_micro: int = 4):
    """The gradient and the empirical-Fisher diagonal at flat parameters
    ``w`` — (d,), or a (B, d) stack of members — as tensors of w's shape.
    ``loss_fn(params, batch)`` takes ``spec.unflatten(w)`` and returns a
    scalar, or (B,) per-member losses."""
    flat_grad = _flat_grad_fn(loss_fn, spec, w)
    return flat_grad(calib_batch), _fisher(flat_grad, calib_batch, num_micro)


def sensitivity_from_parts(params, grads, fisher):
    """|g*theta - 0.5*F*theta^2| elementwise over the tree (f32)."""
    return tree_map(lambda p, g, f: torch.abs(g.float() * p.float()
                                              - 0.5 * f * torch.square(p.float())),
                    params, grads, fisher)


def first_order_sensitivity(params, grads):
    """|g * theta| elementwise over the tree (f32): the SNIP-style
    first-order variant (ablation)."""
    return tree_map(lambda p, g: torch.abs(g.float() * p.float()), params,
                    grads)


def sensitivity(loss_fn: Callable, params, calib_batch: dict,
                num_micro: int = 4):
    """Eq. 8 sensitivity tree."""
    g = grad(loss_fn, params, calib_batch)
    fisher = fisher_diagonal(loss_fn, params, calib_batch, num_micro)
    return sensitivity_from_parts(params, g, fisher)
