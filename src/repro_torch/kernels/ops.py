"""Public entry points over the port's kernels, and their launch counts.

``sketch_tree_fused`` is the whole-model sensitivity sketch through the
fused ``sens_sketch`` kernel: one launch per leaf, leaf ``i`` hashed with
seed ``leaf_seed_host(seed, i)`` — the reference's
``repro.kernels.ops.sketch_tree_fused``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core.sketch import DEFAULT_K, leaf_seed_host
from repro_torch.kernels.buffer_agg import buffer_agg
from repro_torch.kernels.sens_sketch import sens_sketch

KERNELS = {"buffer_agg": buffer_agg, "sens_sketch": sens_sketch}


def sketch_tree_fused(params, grads, fisher, *, k: int = DEFAULT_K,
                      seed: int = 0) -> torch.Tensor:
    """(k,) sketch of the Eq. 8 sensitivity of a whole parameter tree."""
    total = None
    for i, (p, g, f) in enumerate(zip(tree_leaves(params), tree_leaves(grads),
                                      tree_leaves(fisher))):
        part = sens_sketch(p.reshape(-1), g.reshape(-1), f.reshape(-1), k=k,
                           seed=leaf_seed_host(seed, i))
        total = part if total is None else total + part
    return total


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset (CUDA tensors only; the plain
    CPU path launches nothing)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
