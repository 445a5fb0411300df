"""Client-side data loading: shuffled epoch batches (image data).

``epoch_batch_indices`` is a copy of the reference's one shuffle routine,
so the port visits exactly the batches the reference's per-client loop
would (same ``RandomState`` stream, same drop-last rule).
``StackedClients`` is the cohort engine's padded all-clients slab.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticClassification


def epoch_batch_indices(n: int, num_epochs: int, batch_size: int,
                        seed: int) -> np.ndarray:
    """Batch schedule for one client: ``(steps, bs)`` int32 indices into its
    ``n`` samples, ``bs = min(batch_size, n)``, drop-last, one fresh
    permutation per epoch from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    m = n // bs                       # drop-last batch count per epoch
    out = np.empty((num_epochs * m, bs), np.int32)
    for e in range(num_epochs):
        out[e * m:(e + 1) * m] = rng.permutation(n)[:m * bs].reshape(m, bs)
    return out


@dataclass
class ClientDataset:
    data: SyntheticClassification

    def __len__(self):
        return len(self.data)

    def epochs(self, num_epochs: int, batch_size: int, seed: int) -> Iterator[dict]:
        """Host batches ``{"x": float32, "y": int32}`` in schedule order."""
        if np.issubdtype(self.data.x.dtype, np.integer):
            raise NotImplementedError(
                "token datasets are not ported to repro_torch (ROADMAP.md "
                "Queue 1 item 10)")
        for idx in epoch_batch_indices(len(self.data), num_epochs,
                                       batch_size, seed):
            yield {"x": self.data.x[idx].astype(np.float32),
                   "y": self.data.y[idx].astype(np.int32)}


@dataclass
class StackedClients:
    """All clients' data as one padded slab (the cohort engine's layout),
    the reference's ``repro.data.loader.StackedClients`` for image data.

    ``x[c, :sizes[c]]`` are client ``c``'s real samples; rows beyond that
    are zero padding. Padding never reaches a loss term: the batch
    schedules index only real rows, and ragged batch tails are masked
    inside the engine's loss. x (C, n_max, ...) float32, y (C, n_max)
    int32.
    """
    x: np.ndarray
    y: np.ndarray
    sizes: np.ndarray    # (C,) int32 true per-client sample counts

    @classmethod
    def from_datasets(cls, datasets: Sequence[ClientDataset]
                      ) -> "StackedClients":
        d0 = datasets[0].data
        if np.issubdtype(d0.x.dtype, np.integer):
            raise NotImplementedError(
                "token datasets are not ported to repro_torch (ROADMAP.md "
                "Queue 1 item 10)")
        sizes = np.asarray([len(d) for d in datasets], np.int32)
        C, n_max = len(datasets), int(sizes.max())
        x = np.zeros((C, n_max) + d0.x.shape[1:], np.float32)
        y = np.zeros((C, n_max) + d0.y.shape[1:], np.int32)
        for c, d in enumerate(datasets):
            x[c, :sizes[c]] = d.data.x
            y[c, :sizes[c]] = d.data.y
        return cls(x=x, y=y, sizes=sizes)

    def to_device(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The slab as device tensors: x float32, y int64 (gather index)."""
        return (torch.as_tensor(self.x, device=device),
                torch.as_tensor(self.y.astype(np.int64), device=device))
