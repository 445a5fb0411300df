"""The paper's CNN (FedPSA §6.1) in plain PyTorch, over named leaves in
the flat layout of ``fedbench.world.layout``: NHWC images, 5x5 SAME
convolutions each followed by ReLU and a 2x2 max-pool, then dense layers
with ReLU between them; the loss is the mean cross-entropy."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from fedbench.world import layout


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (round to nearest even),
    passed straight through to the gradient: the control's emulation of
    TF32 arithmetic on a device that has none."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


class CNN:
    """Unflattens a (d,) vector into the CNN's leaves and runs it."""

    def __init__(self, cfg: dict, emulate_tf32: bool = False):
        self.cfg = cfg
        self.leaves = layout(cfg)
        self.sizes = [math.prod(s) for _, s in self.leaves]
        self.n_conv = len(cfg["cnn_channels"])
        self.n_dense = len(cfg["mlp_hidden"]) + 1
        self.pad = cfg["cnn_kernel"] // 2
        self.emulate_tf32 = emulate_tf32

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        parts = torch.split(flat, self.sizes)
        return {path: p.view(shape)
                for (path, shape), p in zip(self.leaves, parts)}

    def _op(self, x):
        return tf32_round(x) if self.emulate_tf32 else x

    def logits(self, P: Dict[str, torch.Tensor], x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            w = P[f"conv{i}/w"].permute(3, 2, 0, 1)
            x = F.conv2d(self._op(x), self._op(w), padding=self.pad)
            x = F.max_pool2d(torch.relu(x + P[f"conv{i}/b"][:, None, None]),
                             2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(self.n_dense):
            x = self._op(x) @ self._op(P[f"fc{i}/w"]) + P[f"fc{i}/b"]
            if i < self.n_dense - 1:
                x = torch.relu(x)
        return x

    def loss(self, P, x, y):
        z = self.logits(P, x)
        return torch.mean(torch.logsumexp(z, dim=-1)
                          - torch.gather(z, 1, y[:, None])[:, 0])

    def grad(self, flat: torch.Tensor, x, y) -> torch.Tensor:
        """The flat gradient of the mean loss on (x, y) at ``flat``."""
        leaf = flat.detach().requires_grad_(True)
        return torch.autograd.grad(self.loss(self.unflatten(leaf), x, y),
                                   leaf)[0]

    def leaf_slices(self) -> List[slice]:
        out, off = [], 0
        for n in self.sizes:
            out.append(slice(off, off + n))
            off += n
        return out
