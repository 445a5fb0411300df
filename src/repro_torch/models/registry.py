"""Model-family registry of the port: the paper's image families.

One ``ModelFamily`` entry per family holds the callables the client
runtime, the cohort engine and the simulator's evaluation loop share (the
reference's ``repro.models.registry`` image entries).

``client_loss(params, batch, cfg, members=False)`` is the local-SGD loss.
Without ``batch["sample_weight"]`` it is the plain mean cross-entropy,
bit-identical to the sequential client's loss. With it (the cohort
engine's ``masked_batch``) it is ``sum((lse - gold) * vm) / cnt``, so
masked rows are exact no-ops; with ``members=True`` the params and the
batch carry a leading member axis and the result is the (B,) vector of
per-member losses.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


class ModelFamily(NamedTuple):
    name: str                 # registry key == ModelConfig.family
    data_kind: str            # "image" (the only kind ported)
    client_loss: Callable     # (params, batch, cfg, members=False) -> loss
    masked_batch: Callable    # (xb, yb, vm, cnt) -> batch dict
    batch_fn: Callable        # (x, y, device) -> batch dict (host -> device)
    eval_accuracy: Callable   # (params, batch, cfg) -> scalar


def _batch_fn(x, y, device) -> dict:
    return {"x": torch.as_tensor(np.asarray(x, np.float32), device=device),
            "y": torch.as_tensor(np.asarray(y, np.int64), device=device)}


def _masked_batch(xb, yb, vm, cnt) -> dict:
    return {"x": xb, "y": yb, "sample_weight": vm, "weight_total": cnt}


def _image_entry(name: str, mean_loss: Callable) -> ModelFamily:
    def client_loss(params, batch, cfg, members: bool = False):
        vm = batch.get("sample_weight")
        if vm is None:
            # unmasked path: bit-identical to the sequential per-batch loss
            return mean_loss(params, batch, cfg)
        logits = model_lib.forward(params, batch["x"], cfg, members).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["y"].long()[..., None])[..., 0]
        return torch.sum((lse - gold) * vm, dim=-1) / batch["weight_total"]

    return ModelFamily(name=name, data_kind="image", client_loss=client_loss,
                       masked_batch=_masked_batch, batch_fn=_batch_fn,
                       eval_accuracy=model_lib.accuracy)


_REGISTRY = {
    "cnn": _image_entry("cnn", model_lib.cnn_loss),
    "mlp": _image_entry("mlp", model_lib.mlp_loss),
}


def is_registered(family: str) -> bool:
    return family in _REGISTRY


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
