"""Synthetic classification data (offline stand-ins for MNIST/FMNIST/CIFAR).

A copy of the reference's ``repro.data.synthetic`` image path: an
anisotropic Gaussian mixture, one mean per class on a random simplex, plus
a class-dependent rotation, ``SyntheticPopulation``, the lazy
population of 10^5-10^6 clients behind the streaming slab store, and
``make_lm_corpus``, the bigram token stream of federated LM fine-tuning. Pure
numpy from ``RandomState(seed)``, so the port draws exactly the
reference's arrays (pinned by the CPU tests).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticClassification:
    x: np.ndarray       # (N, ...) float32
    y: np.ndarray       # (N,) int64
    num_classes: int

    def __len__(self):
        return self.x.shape[0]

    def subset(self, idx) -> "SyntheticClassification":
        return SyntheticClassification(self.x[idx], self.y[idx], self.num_classes)


def make_classification(num_samples: int = 10_000, num_classes: int = 10,
                        dim: int = 32, *, image_hw=None, seed: int = 0,
                        class_sep: float = 1.8,
                        noise: float = 1.0) -> SyntheticClassification:
    """Gaussian mixture. ``image_hw=(H, W, C)`` reshapes features to images
    (for the CNN family); dim is then H*W*C."""
    rng = np.random.RandomState(seed)
    if image_hw is not None:
        dim = int(np.prod(image_hw))
    means = rng.randn(num_classes, dim).astype(np.float32)
    means *= class_sep / np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.randint(0, num_classes, size=num_samples)
    x = means[y] + noise * rng.randn(num_samples, dim).astype(np.float32) / np.sqrt(dim) * np.sqrt(dim) * 0.3
    # mild class-dependent rotation so the task is not purely linear
    w = rng.randn(num_classes, dim, 8).astype(np.float32) / np.sqrt(dim)
    feats = np.einsum("nd,ndk->nk", x, w[y])
    x[:, :8] += 0.5 * np.tanh(feats)
    x = x.astype(np.float32)
    if image_hw is not None:
        x = x.reshape((num_samples,) + tuple(image_hw))
    return SyntheticClassification(x, y.astype(np.int64), num_classes)


def train_test_split(ds: SyntheticClassification, test_frac: float = 0.1,
                     seed: int = 7):
    """Paper protocol: 10% test split, remainder training."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds))
    n_test = int(len(ds) * test_frac)
    return ds.subset(idx[n_test:]), ds.subset(idx[:n_test])


# ---------------------------------------------------------------------------
# Lazy population: 10^5-10^6 clients materialized on demand
# ---------------------------------------------------------------------------
#
# ``SyntheticPopulation`` is the population-scale source behind the
# streaming slab store (``data.loader.ClientSlabStore``): per-client rows
# are a pure function of (population seed, client id, row, column), so any
# client can be generated at any time — in wave batches, in whole shards,
# or as a standalone ``ClientDataset`` for the sequential oracle — and
# shard-cache evictions can never change what a re-materialized shard
# holds. Randomness comes from fixed noise/uniform tables indexed by a
# multiplicative hash of (client, row, column, tag): one vectorized gather
# per wave instead of per-client ``RandomState`` construction.

_TABLE_BITS = 20
_TABLE = 1 << _TABLE_BITS
# distinct odd multipliers keep (client, row, column, tag) strides
# decorrelated modulo the table size
_HC, _HR, _HK, _HT = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE35, 0x27D4EB2F
# tag ids: per-(client,row,col) noise, per-(client,row) label draws,
# per-client dominant classes
_T_NOISE, _T_LABEL, _T_TAIL, _T_DOM1, _T_DOM2, _T_TEST = range(6)


def _table_idx(*parts) -> np.ndarray:
    """Hash broadcastable integer parts into noise-table indices."""
    muls = (_HC, _HR, _HK, _HT)
    acc = 0
    for p, m in zip(parts, muls):
        acc = acc + np.asarray(p, np.int64) * m
    return (acc ^ (acc >> 17)) % _TABLE


class SyntheticPopulation:
    """A lazy ``make_classification``-style population of C clients.

    Shares one class structure (simplex means + class-dependent rotation,
    drawn once from the population seed) across all clients; each client
    holds a label-skewed sample — two hash-chosen dominant classes carry
    ~70% of its mass, the rest is uniform — with log-normal per-client
    sizes (``partition.skewed_client_sizes``). Nothing of size O(C * n_max)
    is ever materialized: the resident state is O(C) size arrays plus the
    fixed noise tables.

    The simulator's population contract: ``sizes``, ``num_classes``,
    ``kind``, ``n_max``, ``member_rows(cids)`` (for the slab store) and
    ``__getitem__ -> ClientDataset`` / ``__len__`` (for the sequential
    oracle and the synchronous runner).
    """

    kind = "image"

    def __init__(self, num_clients: int, num_classes: int = 10,
                 dim: int = 32, *, seed: int = 0, class_sep: float = 1.8,
                 noise: float = 1.0, size_mean: int = 64,
                 size_spread: float = 0.5, size_lo: int = 16,
                 size_hi: int = 128, dominant_mass: float = 0.7):
        from repro_torch.data.partition import skewed_client_sizes
        self.num_clients = int(num_clients)
        self.num_classes = int(num_classes)
        self.dim = int(dim)
        self.seed = int(seed)
        self.noise = float(noise)
        self.dominant_mass = float(dominant_mass)
        rng = np.random.RandomState(seed)
        means = rng.randn(num_classes, dim).astype(np.float32)
        means *= class_sep / np.linalg.norm(means, axis=1, keepdims=True)
        self.means = means
        self.w = rng.randn(num_classes, dim, 8).astype(np.float32) \
            / np.sqrt(dim)
        self._normals = rng.randn(_TABLE).astype(np.float32)
        self._uniforms = rng.rand(_TABLE)
        self.sizes = skewed_client_sizes(
            num_clients, mean=size_mean, spread=size_spread, lo=size_lo,
            hi=size_hi, seed=seed + 1)
        self.n_max = int(self.sizes.max())

    def __len__(self) -> int:
        return self.num_clients

    def _labels(self, cids: np.ndarray, n: int) -> np.ndarray:
        """(B, n) int labels: dominant-class skew, hash-deterministic."""
        K = self.num_classes
        c = cids[:, None]
        rows = np.arange(n)[None, :]
        dom1 = (self._uniforms[_table_idx(cids, 0, 0, _T_DOM1)]
                * K).astype(np.int64)[:, None]
        dom2 = (self._uniforms[_table_idx(cids, 0, 0, _T_DOM2)]
                * K).astype(np.int64)[:, None]
        r = self._uniforms[_table_idx(c, rows, 0, _T_LABEL)]
        tail = (self._uniforms[_table_idx(c, rows, 0, _T_TAIL)]
                * K).astype(np.int64)
        q = self.dominant_mass
        return np.where(r < 0.6 * q, dom1,
                        np.where(r < q, dom2, tail))

    def _features(self, cids: np.ndarray, y: np.ndarray) -> np.ndarray:
        """(B, n, dim) float32 features for the given labels — the same
        mixture + rotation arithmetic as ``make_classification``."""
        B, n = y.shape
        c = cids[:, None, None]
        rows = np.arange(n)[None, :, None]
        cols = np.arange(self.dim)[None, None, :]
        g = self._normals[_table_idx(c, rows, cols, _T_NOISE)]
        x = self.means[y] + self.noise * 0.3 * g
        feats = np.einsum("bnd,bndk->bnk", x, self.w[y])
        x[:, :, :8] += 0.5 * np.tanh(feats)
        return x.astype(np.float32)

    def member_rows(self, cids) -> tuple:
        """Materialize clients as padded ``(B, n_max, dim)`` float32 /
        ``(B, n_max)`` int32 host arrays (rows past ``sizes[c]`` zeroed) —
        the slab-store row protocol. One vectorized build, no per-client
        RNG objects."""
        cids = np.asarray(cids, np.int64)
        y = self._labels(cids, self.n_max)
        x = self._features(cids, y)
        valid = np.arange(self.n_max)[None, :] < self.sizes[cids][:, None]
        x *= valid[:, :, None]
        y = (y * valid).astype(np.int32)
        return x, y

    def __getitem__(self, c: int):
        """Client ``c`` as a standalone ``ClientDataset`` (the sequential
        oracle's view) — identical rows to the streamed slab."""
        from repro_torch.data.loader import ClientDataset
        x, y = self.member_rows([int(c)])
        n = int(self.sizes[int(c)])
        return ClientDataset(SyntheticClassification(
            x[0, :n], y[0, :n].astype(np.int64), self.num_classes))

    def test_dataset(self, n: int = 2048) -> SyntheticClassification:
        """An i.i.d. uniform-label sample from the shared mixture (held-out
        evaluation set; reserved hash lane, no client overlap)."""
        cid = np.asarray([self.num_clients], np.int64)
        rows = np.arange(n)[None, :]
        y = (self._uniforms[_table_idx(cid[:, None], rows, 0, _T_TEST)]
             * self.num_classes).astype(np.int64)
        x = self._features(cid, y)
        return SyntheticClassification(x[0], y[0], self.num_classes)


def make_lm_corpus(num_tokens: int = 2_000_000, vocab: int = 512,
                   seed: int = 0, branching: int = 8) -> np.ndarray:
    """Sparse random bigram chain (the reference's ``make_lm_corpus``):
    each token has ``branching`` likely successors, so the cross-entropy
    floor is about log(branching) < log(vocab). int32 (num_tokens,)."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, size=(vocab, branching))
    probs = rng.dirichlet(np.ones(branching) * 0.5, size=vocab)
    out = np.empty(num_tokens, np.int32)
    t = rng.randint(vocab)
    for i in range(num_tokens):
        out[i] = t
        t = succ[t, rng.choice(branching, p=probs[t])]
    return out
