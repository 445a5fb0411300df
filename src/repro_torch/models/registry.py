"""Model-family registry of the port: the paper's image families and the
token families (dense, moe, ssm, hybrid).

One ``ModelFamily`` entry per family holds the callables the client
runtime, the cohort engine and the simulator's evaluation loop share (the
reference's ``repro.models.registry`` entries). ``keys`` names a batch's
two host arrays (``ClientDataset.epochs``, the calibration batch).

``client_loss(params, batch, cfg, members=False)`` is the local-SGD loss;
with ``members=True`` the params and the batch carry a leading member axis
and the result is the (B,) vector of per-member losses. Image families:
without ``batch["sample_weight"]`` the plain mean cross-entropy,
bit-identical to the sequential client's loss; with it (the cohort
engine's ``masked_batch``) ``sum((lse - gold) * vm) / cnt``, so masked rows
are exact no-ops. The token families (``"dense"``, ``"moe"``, ``"ssm"``,
``"hybrid"``, as the reference registers them): ``model.loss_fn``, the mean
next-token cross-entropy over the labels >= 0 after the causal shift (plus
the MoE aux loss); ``masked_batch`` turns a masked row's labels into -1, so
the row is an exact no-op in the loss and in its count (for an MoE only at
lossless capacity and ``router_aux_coef = 0``, as ``fed-lm-moe-smoke`` sets
them: a masked row's tokens still route and take expert slots). The
reference registers no family for its frontends (audio, vision), and
neither does the port.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


class ModelFamily(NamedTuple):
    name: str                 # registry key == ModelConfig.family
    data_kind: str            # "image" | "tokens"
    client_loss: Callable     # (params, batch, cfg, members=False) -> loss
    masked_batch: Callable    # (xb, yb, vm, cnt) -> batch dict
    batch_fn: Callable        # (x, y, device) -> batch dict (host -> device)
    eval_accuracy: Callable   # (params, batch, cfg) -> scalar
    keys: tuple               # the batch's (x, y) keys


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
                       eval_accuracy=model_lib.accuracy, keys=("x", "y"))


def _token_batch_fn(x, y, device) -> dict:
    return {"tokens": torch.as_tensor(np.asarray(x, np.int64), device=device),
            "labels": torch.as_tensor(np.asarray(y, np.int64), device=device)}


def _token_masked_batch(xb, yb, vm, cnt) -> dict:
    # a masked row's labels all become -1, the loss's no-target sentinel:
    # the row adds nothing to the loss, its count or the gradient
    return {"tokens": xb,
            "labels": torch.where(vm[..., None] > 0.0, yb,
                                  torch.full_like(yb, -1))}


def _token_entry(name: str) -> ModelFamily:
    return ModelFamily(name=name, data_kind="tokens",
                       client_loss=model_lib.loss_fn,
                       masked_batch=_token_masked_batch,
                       batch_fn=_token_batch_fn,
                       eval_accuracy=model_lib.token_accuracy,
                       keys=("tokens", "labels"))


_REGISTRY = {
    "cnn": _image_entry("cnn", model_lib.cnn_loss),
    "mlp": _image_entry("mlp", model_lib.mlp_loss),
    **{fam: _token_entry(fam) for fam in model_lib.TOKEN_FAMILIES},
}


def register_family(entry: ModelFamily, *, override: bool = False) -> None:
    """Register ``entry`` under ``entry.name``; the cohort engine and the
    simulator pick it up at once. A name already registered raises unless
    ``override``."""
    if entry.name in _REGISTRY and not override:
        raise ValueError(f"family {entry.name!r} already registered "
                         f"(pass override=True to replace)")
    if entry.data_kind not in ("image", "tokens"):
        raise ValueError(f"family {entry.name!r}: data_kind must be 'image' "
                         f"or 'tokens', got {entry.data_kind!r}")
    _REGISTRY[entry.name] = entry


def is_registered(family: str) -> bool:
    return family in _REGISTRY


def registered_families() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_family(family) -> ModelFamily:
    """Resolve a family name (or a ModelConfig) to its registry entry."""
    if isinstance(family, ModelConfig):
        family = family.family
    entry = _REGISTRY.get(family)
    if entry is None:
        raise NotImplementedError(
            f"model family {family!r} is not registered in repro_torch "
            f"(registered: {registered_families()}); the reference "
            f"registers no family for its frontends (vlm, audio), whose "
            f"batches need patch or frame embeddings that the federated data "
            f"layer does not make")
    return entry
