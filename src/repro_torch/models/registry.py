"""Model-family registry of the port: the paper's image families.

One ``ModelFamily`` entry per family holds the callables the client
runtime and the simulator's evaluation loop share (the reference's
``repro.models.registry`` image entries, without the cohort engine's
``masked_batch``, which arrives with the cohort port).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


class ModelFamily(NamedTuple):
    name: str                 # registry key == ModelConfig.family
    client_loss: Callable     # (params, batch, cfg) -> scalar
    batch_fn: Callable        # (x, y, device) -> batch dict (host -> device)
    eval_accuracy: Callable   # (params, batch, cfg) -> scalar


def _batch_fn(x, y, device) -> dict:
    return {"x": torch.as_tensor(np.asarray(x, np.float32), device=device),
            "y": torch.as_tensor(np.asarray(y, np.int64), device=device)}


_REGISTRY = {
    "cnn": ModelFamily("cnn", model_lib.cnn_loss, _batch_fn, model_lib.accuracy),
    "mlp": ModelFamily("mlp", model_lib.mlp_loss, _batch_fn, model_lib.accuracy),
}


def get_family(family) -> ModelFamily:
    """Resolve a family name (or a ModelConfig) to its registry entry."""
    if isinstance(family, ModelConfig):
        family = family.family
    entry = _REGISTRY.get(family)
    if entry is None:
        raise NotImplementedError(
            f"model family {family!r} is not ported to repro_torch (ported: "
            f"{sorted(_REGISTRY)}); see ROADMAP.md Queue 1 item 10")
    return entry
