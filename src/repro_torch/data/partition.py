"""Client partitioning: Dirichlet label-skew (the paper's protocol), IID,
the log-normal client sizes of a lazy population, and the document split
of a token stream (federated LM fine-tuning). A copy of the reference's
``repro.data.partition``."""
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


def skewed_client_sizes(num_clients: int, *, mean: int = 64,
                        spread: float = 0.6, lo: int = 16, hi: int = 512,
                        seed: int = 0) -> np.ndarray:
    """Per-client dataset sizes for a lazy population: log-normal around
    ``mean`` (clipped to [lo, hi]) so a minority of clients hold most of the
    data — the size analogue of the Dirichlet label-skew protocol. One
    vectorized draw, O(C) at C=10^6; deterministic in (args, seed)."""
    if not (0 < lo <= mean <= hi):
        raise ValueError(f"need 0 < lo <= mean <= hi, got {lo}/{mean}/{hi}")
    rng = np.random.RandomState(seed)
    raw = np.exp(rng.normal(np.log(float(mean)), spread, size=num_clients))
    return np.clip(np.round(raw), lo, hi).astype(np.int64)


def iid_partition(ds: SyntheticClassification, num_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds))
    return [np.asarray(sorted(part)) for part in np.array_split(idx, num_clients)]


def document_partition(tokens: np.ndarray, num_clients: int, seq_len: int, *,
                       doc_len: int = 0, alpha: float = 0.0,
                       seed: int = 0) -> List[np.ndarray]:
    """Document-level split of a token stream for federated LM fine-tuning.

    The stream is chopped into contiguous documents of ``doc_len`` tokens
    (default ``4 * seq_len``); whole documents are dealt to clients,
    near-uniformly when ``alpha <= 0`` and with Dirichlet(alpha)-drawn
    proportions otherwise (every client keeps at least one document). Each
    client's documents are then windowed into non-overlapping ``seq_len``
    sequences, so no window straddles a document boundary.

    Returns one ``(n_i, seq_len)`` int32 array per client.
    """
    tokens = np.asarray(tokens)
    doc_len = doc_len or 4 * seq_len
    if doc_len % seq_len:
        raise ValueError(f"doc_len {doc_len} is not a multiple of seq_len "
                         f"{seq_len}")
    n_docs = len(tokens) // doc_len
    if n_docs < num_clients:
        raise ValueError(f"need >= {num_clients} documents of {doc_len} "
                         f"tokens, have {n_docs}")
    docs = tokens[:n_docs * doc_len].astype(np.int32).reshape(n_docs, doc_len)
    rng = np.random.RandomState(seed)
    order = rng.permutation(n_docs)
    counts = np.ones(num_clients, np.int64)       # min one document each
    rem = n_docs - num_clients
    if rem > 0:
        if alpha > 0:
            p = rng.dirichlet(np.full(num_clients, alpha))
            counts += rng.multinomial(rem, p)
        else:
            counts += np.diff(np.linspace(0, rem, num_clients + 1).astype(int))
    cuts = np.cumsum(counts)[:-1]
    return [part.reshape(-1, seq_len)
            for part in np.split(docs[order], cuts)]
