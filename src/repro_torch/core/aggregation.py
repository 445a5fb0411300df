"""Buffer aggregation rules: FedPSA's temperature softmax (Eq. 19-20) and
the time-based staleness weighting of the buffered baselines."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.buffer_agg import buffer_agg


def psa_weights(kappas: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Eq. 19: Weight_i = softmax(kappa_i / Temp) over the buffer."""
    return torch.softmax(kappas.float() / torch.clamp(temp, min=1e-6), dim=0)


def uniform_weights(n: int, device="cpu") -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def aggregate_flat(global_vec: torch.Tensor, updates: torch.Tensor,
                   weights: torch.Tensor, server_lr: float = 1.0) -> torch.Tensor:
    """Eq. 20 over the flat layout: updates stacked (L, d), global (d,),
    through the ``buffer_agg`` kernel (the plain version on CPU tensors).
    Returns a fresh vector; ``global_vec`` is left as it was."""
    return buffer_agg(weights.float() * float(np.float32(server_lr)),
                      global_vec, updates)


def staleness_polynomial(tau, alpha: float = 0.6, a: float = 0.5) -> float:
    """alpha * (1 + tau)^-a in float32 arithmetic, on the host: ``tau`` is
    a host int, so the scale needs no device round trip."""
    return float(np.float32(alpha)
                 * np.power(np.float32(1.0 + tau), np.float32(-a)))
