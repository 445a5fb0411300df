"""Client-side local training (paper protocol: E epochs of SGD, batch 64).

``local_update`` returns the parameter delta dw = w_after - w_before and
the trained parameters, as the reference's ``repro.federated.client``.
Batches come from the reference's shuffle rule (``ClientDataset.epochs``)
and are copied to the parameters' device one at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import (grad, tree_leaves, tree_map,
                                     tree_sq_norm, tree_sub)
from repro_torch.data.loader import ClientDataset
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


def _head(params):
    """Classifier head leaves (last fc layer) of the paper models."""
    fc_keys = sorted(k for k in params if k.startswith("fc"))
    return params[fc_keys[-1]] if fc_keys else params


def _loss_for(cfg: ModelConfig, prox: float, align: float):
    base_fn = registry.get_family(cfg).client_loss

    def loss(params, batch, anchor):
        base = base_fn(params, batch, cfg)
        if prox > 0.0:  # FedProx-style proximal pull toward the anchor
            base = base + 0.5 * prox * tree_sq_norm(tree_sub(params, anchor))
        if align > 0.0:  # FedPAC-lite: align the classifier head with global
            base = base + 0.5 * align * tree_sq_norm(
                tree_sub(_head(params), _head(anchor)))
        return base
    return loss


def _sgd_step(lr32: float):
    """The reference's step ``p - lr * g.astype(p.dtype)`` with ``lr`` an
    f32 array: JAX promotes a narrower leaf to f32, so a bf16 leaf comes out
    of its first step as f32 (and stays f32); an f32 leaf stays f32."""
    def step(p, g):
        dt = torch.promote_types(p.dtype, torch.float32)
        return p.to(dt) - lr32 * g.to(p.dtype).to(dt)
    return step


def local_update(global_params, cfg: ModelConfig, dataset: ClientDataset, *,
                 epochs: int = 5, batch_size: int = 64, lr: float = 0.01,
                 seed: int = 0, prox: float = 0.0, align: float = 0.0):
    """Run E local epochs of SGD from ``global_params``; returns (delta, w_i).
    ``global_params`` is not modified (every step builds new tensors)."""
    loss = _loss_for(cfg, prox, align)
    fam = registry.get_family(cfg)
    device = tree_leaves(global_params)[0].device
    step = _sgd_step(float(np.float32(lr)))   # the reference's f32 lr
    params = global_params
    for hb in dataset.epochs(epochs, batch_size, seed):
        batch = fam.batch_fn(*(hb[k] for k in fam.keys), device)
        g = grad(loss, params, batch, global_params)
        with torch.no_grad():
            params = tree_map(step, params, g)
        del g   # the next step's gradients need the room (full width)
    return tree_sub(params, global_params), params
