"""FedPSA's client sketch (paper Eq. 6, 8 and 11) in plain PyTorch: the
Eq. 8 sensitivity on the calibration batch, projected by the hashed
Rademacher matrix, which is materialised here as a (k, d) table of signs.

The hash is a copy of the paper code's PCG mix on uint32 values carried
in int64: entry (r, j) of leaf i is the sign of
``pcg(leaf_seed(seed, i) ^ pcg(j * k + r))``, +1 when its top bit is 0.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF


def _pcg_host(x: int) -> int:
    state = (x * 747796405 + 2891336453) & _M
    word = ((state >> (((state >> 28) + 4) & 31)) ^ state) & _M
    word = (word * 277803737) & _M
    return ((word >> 22) ^ word) & _M


def leaf_seed(seed: int, leaf_index: int) -> int:
    return _pcg_host((seed ^ ((leaf_index * 0x9E3779B9) & _M)) & _M)


def _pcg(x: torch.Tensor) -> torch.Tensor:
    state = (x * 747796405 + 2891336453) & _M
    word = ((state >> ((state >> 28) + 4)) ^ state) & _M
    word = (word * 277803737) & _M
    return ((word >> 22) ^ word) & _M


def sign_table(sizes, seed: int, k: int, device) -> torch.Tensor:
    """(k, d) float32 +-1: the projection's signs, leaf after leaf."""
    cols = []
    for i, n in enumerate(sizes):
        s = leaf_seed(seed, i)
        lin = torch.arange(n, dtype=torch.int64, device=device)
        rows = []
        for r in range(k):
            h = _pcg(s ^ _pcg((lin * k + r) & _M))
            rows.append(torch.where((h >> 31) == 0, 1.0, -1.0))
        cols.append(torch.stack(rows).to(torch.float32))
    return torch.cat(cols, dim=1)


class Sketcher:
    """(d,) model -> (k,) sketch of its sensitivity on the calibration
    batch: ``|g * w - F * w^2 / 2|`` with g the gradient of the batch's
    mean loss and F the mean over ``micro`` consecutive microbatches of
    their squared gradients."""

    def __init__(self, model, calib_x, calib_y, seed: int, k: int,
                 micro: int):
        self.model, self.x, self.y = model, calib_x, calib_y
        self.k, self.micro = k, micro
        self.signs = sign_table(model.sizes, seed, k, calib_x.device)

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        g = self.model.grad(w, self.x, self.y)
        n = self.x.shape[0]
        mb = n // self.micro
        fisher = torch.zeros_like(w)
        for i in range(self.micro):
            gi = self.model.grad(w, self.x[i * mb:(i + 1) * mb],
                                 self.y[i * mb:(i + 1) * mb])
            fisher.addcmul_(gi, gi)
        fisher.div_(self.micro)
        s = torch.abs(g * w - 0.5 * fisher * torch.square(w))
        return (self.signs.to(s.dtype) @ s) / math.sqrt(self.k)
