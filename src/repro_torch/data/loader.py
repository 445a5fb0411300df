"""Client-side data loading: shuffled epoch batches (image data).

``epoch_batch_indices`` is a copy of the reference's one shuffle routine,
so the port visits exactly the batches the reference's per-client loop
would (same ``RandomState`` stream, same drop-last rule).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

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
