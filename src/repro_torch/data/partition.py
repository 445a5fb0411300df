"""Client partitioning: Dirichlet label-skew (the paper's protocol) and IID.
A copy of the reference's ``repro.data.partition`` image path."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import SyntheticClassification


def dirichlet_partition(ds: SyntheticClassification, num_clients: int,
                        alpha: float, seed: int = 0,
                        min_size: int = 2) -> List[np.ndarray]:
    """Standard Dirichlet(alpha) label-skew split: for each class, sample a
    client proportion vector ~ Dir(alpha) and scatter that class's samples.
    Smaller alpha => more heterogeneous. Retries until every client has at
    least ``min_size`` samples (as in common FL benchmarks)."""
    rng = np.random.RandomState(seed)
    for _attempt in range(100):
        idx_by_client = [[] for _ in range(num_clients)]
        for c in range(ds.num_classes):
            idx_c = np.where(ds.y == c)[0]
            rng.shuffle(idx_c)
            p = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            return [np.asarray(sorted(ix)) for ix in idx_by_client]
    raise RuntimeError("dirichlet_partition failed to satisfy min_size")


def iid_partition(ds: SyntheticClassification, num_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds))
    return [np.asarray(sorted(part)) for part in np.array_split(idx, num_clients)]
