"""Public entry points over the port's kernels, and their launch counts.

``sketch_flat`` is the whole-model sensitivity sketch of flat rows through
the fused ``sens_sketch`` kernel: one launch for every leaf of every
member, leaf ``i`` hashed with seed ``leaf_seed_host(seed, i)``.
``sketch_tree_fused`` is the same on one tree — the reference's
``repro.kernels.ops.sketch_tree_fused``, which launches once per leaf.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.tree import FlatSpec
from repro_torch.core.sketch import DEFAULT_K
from repro_torch.kernels.buffer_agg import buffer_agg
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.sens_sketch import (layout_table, sens_sketch,
                                             sens_sketch_rows)

KERNELS = {"buffer_agg": buffer_agg, "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "grouped_matmul": grouped_matmul, "sens_sketch": sens_sketch}


def sketch_flat(spec: FlatSpec, w: torch.Tensor, g: torch.Tensor,
                f: torch.Tensor, *, k: int = DEFAULT_K,
                seed: int = 0) -> torch.Tensor:
    """(B, d) parameters, gradients and Fisher diagonals in ``spec``'s flat
    layout -> (B, k) sketches of their Eq. 8 sensitivity, in one launch."""
    return sens_sketch_rows(w, g, f, layout_table(spec.sizes, seed, k,
                                                  w.device))


def sketch_tree_fused(params, grads, fisher, *, k: int = DEFAULT_K,
                      seed: int = 0) -> torch.Tensor:
    """(k,) sketch of the Eq. 8 sensitivity of a whole parameter tree, in
    one launch (the trees are flattened first)."""
    spec = FlatSpec(params)
    w, g, f = (spec.flatten(t)[None] for t in (params, grads, fisher))
    return sketch_flat(spec, w, g, f, k=k, seed=seed)[0]


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset (CUDA tensors only; the plain
    CPU path launches nothing)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
