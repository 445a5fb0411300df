"""Buffer aggregation rules: FedPSA's temperature softmax (Eq. 19-20) and
the time-based staleness weightings of the asynchronous baselines."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import tree
from repro_torch.kernels.buffer_agg import buffer_agg


def psa_weights(kappas: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Eq. 19: Weight_i = softmax(kappa_i / Temp) over the buffer."""
    return torch.softmax(kappas.float() / torch.clamp(temp, min=1e-6), dim=0)


def uniform_weights(n: int, device="cpu") -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def aggregate_buffer(global_params, updates, weights: torch.Tensor,
                     server_lr: float = 1.0):
    """Eq. 20 over parameter trees: w_g <- w_g + sum_i Weight_i * dw_i (in
    float32). The server's flat path is ``aggregate_flat``."""
    delta = tree.tree_weighted_sum(list(updates),
                                   weights.float() * server_lr)
    return tree.tree_add(global_params, delta)


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


def staleness_constant(tau, alpha: float = 0.6) -> float:
    """alpha, whatever the version gap (float32, on the host)."""
    return float(np.float32(alpha))


def staleness_hinge(tau, alpha: float = 0.6, a: float = 10.0,
                    b: float = 4.0) -> float:
    """alpha up to a gap of b, then alpha / (a * (tau - b) + 1), in float32
    arithmetic on the host."""
    tau, alpha = np.float32(tau), np.float32(alpha)
    if tau <= np.float32(b):
        return float(alpha)
    return float(alpha / (np.float32(a) * (tau - np.float32(b))
                          + np.float32(1.0)))
