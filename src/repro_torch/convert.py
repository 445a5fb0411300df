"""Move parameters between the reference's numpy trees and the port's.

The reference's parameters (``jax.numpy`` arrays, or numpy arrays from
them) keep their keys and layouts in the port, so conversion is a leafwise
copy into float32 tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu") -> dict:
    """Reference params tree (arrays) -> the port's tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_to_numpy(tree) -> dict:
    """The port's tree -> numpy float32 arrays (the inverse, for tests and
    fixtures)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().astype(np.float32)


def load_npz_params(path, device="cpu") -> dict:
    """A params tree stored as ``np.savez`` entries named ``"fc0.w"`` etc."""
    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            node = out
            *parents, leaf = name.split(".")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = torch.tensor(z[name], device=device)
    return out
