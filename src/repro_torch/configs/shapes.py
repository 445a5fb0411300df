"""The assigned input shapes and ``input_specs()``: the reference's
``repro.configs.shapes``.

Four shapes, each mapping to one step of ``launch/steps.py``:

  train_4k    seq=4,096   global_batch=256   -> train_step   (loss + grads)
  prefill_32k seq=32,768  global_batch=32    -> prefill_step (or encode)
  decode_32k  seq=32,768  global_batch=128   -> serve_step   (1 token + cache)
  long_500k   seq=524,288 global_batch=1     -> serve_step   (sub-quadratic)

``input_specs(cfg, shape)`` returns ``(mode, specs, axes)``:
* ``mode``  — "train" | "prefill" | "encode" | "decode"
* ``specs`` — the step's keyword inputs as tensors on the ``meta`` device
              (shapes and dtypes, no storage): the reference's
              ``jax.ShapeDtypeStruct``s
* ``axes``  — the matching tree of logical-axis tuples

Encoder-only archs (hubert) have no decode; dense archs swap in the
sliding-window config variant for long_500k (``cfg.for_long_context()``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "training" | "inference-prefill" | "inference-decode" | "long-context-decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "training"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "inference-prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "inference-decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "long-context-decode"),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-not)."""
    s = SHAPES[shape]
    if s.kind in ("inference-decode", "long-context-decode") and not cfg.has_decode:
        return False, f"{cfg.name} is encoder-only (no decode step)"
    if shape == "long_500k" and cfg.family == "dense" and cfg.long_context_window is None:
        return False, f"{cfg.name} is pure full-attention with no sub-quadratic variant"
    return True, ""


def config_for_shape(cfg: ModelConfig, shape: str) -> ModelConfig:
    """long_500k uses the sliding-window variant for attention layers."""
    if shape == "long_500k":
        return cfg.for_long_context()
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_specs(cfg: ModelConfig, B: int, S: int):
    dt = dtype_of(cfg)
    if cfg.frontend == "audio":
        specs = {"features": _meta((B, S, cfg.d_model), dt),
                 "labels": _meta((B, S), torch.int32)}
        axes = {"features": ("batch", "seq", "embed_act"),
                "labels": ("batch", "seq")}
    elif cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        specs = {"tokens": _meta((B, S - P), torch.int32),
                 "patches": _meta((B, P, cfg.d_model), dt),
                 "labels": _meta((B, S - P), torch.int32)}
        axes = {"tokens": ("batch", "seq"),
                "patches": ("batch", "seq", "embed_act"),
                "labels": ("batch", "seq")}
    else:
        specs = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return specs, axes


def input_specs(cfg: ModelConfig, shape: str):
    """Returns (mode, specs, axes). Raises if the pair is a noted skip."""
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    s = SHAPES[shape]
    cfg = config_for_shape(cfg, shape)
    B, S = s.global_batch, s.seq_len

    if s.kind == "training":
        specs, axes = _train_specs(cfg, B, S)
        return "train", {"batch": specs}, {"batch": axes}

    if s.kind == "inference-prefill":
        specs, axes = _train_specs(cfg, B, S)
        specs.pop("labels")
        axes.pop("labels")
        mode = "encode" if cfg.is_encoder_only else "prefill"
        return mode, {"batch": specs}, {"batch": axes}

    # decode: one new token against a seq_len-deep cache
    specs = {"cache": model_lib.init_cache(cfg, B, S, device="meta"),
             "tokens": _meta((B, 1), torch.int32),
             "pos": _meta((), torch.int32)}
    axes = {"cache": model_lib.cache_axes(cfg),
            "tokens": ("batch", "seq"),
            "pos": ()}
    return "decode", specs, axes


def all_pairs(arch_ids, shape_names=None):
    """Enumerate (arch, shape, supported, reason) over the assignment matrix."""
    from repro_torch.configs import get_config
    shape_names = shape_names or list(SHAPES)
    out = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in shape_names:
            ok, why = shape_supported(cfg, s)
            out.append((a, s, ok, why))
    return out
