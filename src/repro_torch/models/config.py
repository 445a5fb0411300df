"""Model configuration for the paper's image families (cnn / mlp).

The reference ``repro.models.config.ModelConfig`` covers every architecture
family; the port carries only the fields the paper models read. Frozen, so
a config hashes and can key caches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                                  # "cnn" | "mlp"
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 5
    mlp_hidden: Tuple[int, ...] = ()
    input_hw: Tuple[int, int, int] = (0, 0, 0)   # H, W, C for cnn; (features,) via H
    num_classes: int = 10
