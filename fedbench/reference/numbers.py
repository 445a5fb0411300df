"""The arithmetic of the comparison, shared by the policies' references."""
from __future__ import annotations

import numpy as np
import torch


def _leaf_norms(v: torch.Tensor, sizes) -> np.ndarray:
    return np.asarray([torch.linalg.vector_norm(x).item()
                       for x in torch.split(v.detach().double(), sizes)])


def norm_gaps(prog: torch.Tensor, ref: torch.Tensor, sizes) -> np.ndarray:
    """Per leaf: the gap between the two vectors' norms over the reference
    leaf's norm or the median leaf's, whichever is larger."""
    rn = _leaf_norms(ref, sizes)
    pn = _leaf_norms(prog, sizes)
    return np.abs(pn - rn) / np.maximum(np.maximum(rn, np.median(rn)),
                                        1e-300)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b) / torch.clamp(
        torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b), min=1e-12)
