"""Move parameters between the reference's numpy trees and the port's.

The reference's parameters (``jax.numpy`` arrays, or numpy arrays from
them) keep their keys and layouts in the port, so conversion is a leafwise
copy onto ``device``: bfloat16 leaves (ml_dtypes' ``bfloat16``, the LM
configs' param dtype) arrive as ``torch.bfloat16`` bit for bit, and every
other leaf as float32 (the image models' dtype, and the leaves the
reference keeps in float32 in a bfloat16 LM: mamba's ``a_log`` and
``d_skip``). Every family's tree converts this way — the recurrent mixers'
leaves, an MoE FFN's ``{router, w_in, w_gate, w_out[, shared]}`` or a
``{moe, dense}`` pair — and ``FlatSpec`` then flattens it in
``jax.tree_util`` order (sorted keys), as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu") -> dict:
    """Reference params tree (arrays) -> the port's tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def params_to_numpy(tree) -> dict:
    """The port's tree -> numpy float32 arrays (for tests and fixtures;
    bfloat16 widens exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().float().numpy()


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
