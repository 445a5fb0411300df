"""Sensitivity sketching via a never-materialised random projection.

Paper Eq. 11-15, as in the reference's ``repro.core.sketch``: every entry
of the (k x d) projection is a Rademacher sign hashed on the fly,

    R[r, j] = sign(pcg(seed_leaf ^ pcg(j * k + r))) / sqrt(k),

with ``j`` the element's linear index inside its leaf. The hash is uint32
arithmetic. Torch on the CPU implements no uint32 add or shift, so this
plain version carries the uint32 values in int64 and masks with
``& 0xFFFFFFFF`` after every multiply and add; the signs are bit-identical
to the reference's (pinned by the CPU tests) and to the CUDA kernel's
native ``uint32_t`` hash (``csrc/sens_sketch.cu``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves

DEFAULT_K = 16  # paper: compressed dimension k = 16
_M = 0xFFFFFFFF


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-XSH-RR style 32-bit mix on int64 tensors holding uint32 values.
    The products stay below 2**62, so int64 never overflows."""
    state = (x * 747796405 + 2891336453) & _M
    word = ((state >> ((state >> 28) + 4)) ^ state) & _M
    word = (word * 277803737) & _M
    return ((word >> 22) ^ word) & _M


def leaf_seed_host(seed: int, leaf_index: int) -> int:
    """Per-leaf hash seed as pure-python uint32 arithmetic."""
    def pcg(x: int) -> int:
        state = (x * 747796405 + 2891336453) & _M
        word = ((state >> (((state >> 28) + 4) & 31)) ^ state) & _M
        word = (word * 277803737) & _M
        return ((word >> 22) ^ word) & _M

    return pcg((seed ^ ((leaf_index * 0x9E3779B9) & _M)) & _M)


def rademacher_row(seed: int, lin: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """+-1 f32 signs of projection row ``r`` at int64 linear indices ``lin``
    (uint32 values): +1 iff the hash's top bit is 0."""
    h = pcg_hash(seed ^ pcg_hash((lin * k + r) & _M))
    return torch.where((h >> 31) == 0, 1.0, -1.0).to(torch.float32)


def sketch_leaf(leaf: torch.Tensor, seed: int, k: int = DEFAULT_K) -> torch.Tensor:
    """(k,) partial sketch of one leaf, signed (no absolute value)."""
    x = leaf.reshape(-1).float()
    lin = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    rows = [torch.sum(x * rademacher_row(seed, lin, r, k)) for r in range(k)]
    return torch.stack(rows) / math.sqrt(k)


def sketch_tree(tree, seed: int = 0, k: int = DEFAULT_K) -> torch.Tensor:
    """Full-model sketch of a tree: the sum of per-leaf partial sketches
    (R @ concat(leaves) for the blockwise-defined R). The fused
    sensitivity path is ``kernels.ops.sketch_flat``; this one sketches
    raw values (the w/o-S ablation)."""
    leaves = tree_leaves(tree)
    total = torch.zeros((k,), dtype=torch.float32, device=leaves[0].device)
    for i, leaf in enumerate(leaves):
        total = total + sketch_leaf(leaf, leaf_seed_host(seed, i), k)
    return total


def dense_projection(seed: int, leaf_shapes, k: int = DEFAULT_K) -> np.ndarray:
    """The (k, d) projection R materialised, for SMALL models: a test
    oracle of ``sketch_tree``, whose leaf order its columns follow."""
    cols = []
    for i, shape in enumerate(leaf_shapes):
        lin = torch.arange(math.prod(shape), dtype=torch.int64)
        seed_i = leaf_seed_host(seed, i)
        cols.append(torch.stack([rademacher_row(seed_i, lin, r, k)
                                 for r in range(k)]).numpy())
    return np.concatenate(cols, axis=1) / np.sqrt(k)


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Sketch-space cosine similarity (paper Eq. 12), in [-1, 1]."""
    num = torch.sum(a * b)
    den = torch.sqrt(torch.sum(torch.square(a))) * torch.sqrt(torch.sum(torch.square(b)))
    return num / torch.clamp(den, min=eps)
