"""The inputs of a run, made from ``--seed`` by the benchmark itself and
handed alike to the program and to the reference.

Labels, the test split and the Dirichlet partition come from the
configuration's ``partition_seed``, so every seed trains clients of the
same sizes and label mixes and the work of a run does not move with the
seed. The image values, the calibration batch and the initial weights come
from ``--seed``, on the device, in a few large calls.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

# SimConfig seeds feed numpy's RandomState after ``seed * 100003 +
# receives``, which must stay below 2**32
SHUFFLE_SEED_RANGE = 40_000


def sub_seed(seed: int, *keys) -> int:
    """A stable shuffle seed in [0, SHUFFLE_SEED_RANGE) from ``seed`` and
    ``keys``."""
    h = hashlib.blake2b(repr((int(seed),) + keys).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % SHUFFLE_SEED_RANGE


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(path, shape)`` of every leaf of the CNN in the flat order the
    program and the sketch hash use: sorted keys, conv weights (k, k, in,
    out), dense weights (in, out)."""
    H, W, C = cfg["input_hw"]
    k = cfg["cnn_kernel"]
    leaves = {}
    c, h, w = C, H, W
    for i, ch in enumerate(cfg["cnn_channels"]):
        leaves[f"conv{i}/b"] = (ch,)
        leaves[f"conv{i}/w"] = (k, k, c, ch)
        c, h, w = ch, h // 2, w // 2
    dims = [h * w * c] + list(cfg["mlp_hidden"]) + [cfg["num_classes"]]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        leaves[f"fc{i}/b"] = (b,)
        leaves[f"fc{i}/w"] = (a, b)
    return sorted(leaves.items(), key=lambda kv: tuple(kv[0].split("/")))


def dirichlet_partition(labels: np.ndarray, num_classes: int,
                        num_clients: int, alpha: float,
                        rng: np.random.RandomState,
                        min_size: int = 2) -> List[np.ndarray]:
    """Dirichlet(alpha) label skew: per class a client proportion vector,
    the class's shuffled samples cut by it; redrawn until every client
    holds ``min_size`` samples (a copy of the repo's protocol)."""
    for _ in range(100):
        by_client = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx, cuts)):
                by_client[client].extend(part.tolist())
        if min(len(ix) for ix in by_client) >= min_size:
            return [np.asarray(sorted(ix), np.int64) for ix in by_client]
    raise RuntimeError("dirichlet_partition: no draw met min_size")


@dataclass
class World:
    x_train: np.ndarray          # (N, H, W, C) float32
    y_train: np.ndarray          # (N,) int64
    x_test: np.ndarray
    y_test: np.ndarray
    parts: List[np.ndarray]      # client -> indices into the training set
    calib_x: np.ndarray          # (B, H, W, C) float32
    calib_y: np.ndarray          # (B,) int32
    init_flat: torch.Tensor      # (d,) float32 on the device

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray([len(p) for p in self.parts], np.int64)


def init_weights(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(d,) float32: every weight truncated-normal within two sigma at
    ``1 / sqrt(fan_in)``, biases zero, drawn in one call on ``device``."""
    leaves = layout(cfg)
    d = sum(math.prod(s) for _, s in leaves)
    flat = torch.empty(d, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    off = 0
    for path, shape in leaves:
        n = math.prod(shape)
        if path.endswith("/b"):
            flat[off:off + n].zero_()
        else:
            flat[off:off + n].mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
        off += n
    return flat


def make_world(cfg: dict, seed: int, device) -> World:
    w = cfg["world"]
    H, W, C = cfg["input_hw"]
    K = cfg["num_classes"]
    N = int(w["samples"])
    rng = np.random.RandomState(int(w["partition_seed"]))
    labels = rng.randint(K, size=N).astype(np.int64)
    perm = rng.permutation(N)
    n_test = int(N * w["test_frac"])
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    parts = dirichlet_partition(labels[train_idx], K, int(w["clients"]),
                                float(w["dirichlet_alpha"]), rng)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 64))
    D = H * W * C
    means = torch.randn((K, D), generator=gen, device=device)
    y_dev = torch.as_tensor(labels, device=device)
    x = torch.randn((N, D), generator=gen, device=device)
    x.add_(means[y_dev], alpha=0.5)
    x = x.view(N, H, W, C).cpu().numpy()
    cb = int(w["calib_batch"])
    calib_x = torch.randn((cb, H, W, C), generator=gen,
                          device=device).cpu().numpy()
    calib_y = torch.randint(0, K, (cb,), generator=gen,
                            device=device).cpu().numpy().astype(np.int32)
    init = init_weights(cfg, gen, device)
    return World(x_train=x[train_idx], y_train=labels[train_idx],
                 x_test=x[test_idx], y_test=labels[test_idx], parts=parts,
                 calib_x=calib_x, calib_y=calib_y, init_flat=init)
