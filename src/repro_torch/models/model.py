"""The paper's models: CNN (MNIST / CIFAR) and linear / MLP (FMNIST).

Parameters keep the reference's layouts — HWIO conv kernels, ``(in, out)``
dense weights — so a tree converted from the reference
(``repro_torch.convert.params_from_numpy``) runs unchanged. The forward
permutes for torch's NCHW convolution and permutes back to NHWC before
flattening, because ``fc0.w`` was laid out against the reference's NHWC
flatten order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def _dense_init(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, the reference's
    ``layers.dense_init`` law. Values come from ``gen``: they are not the
    reference's threefry draws (convert the reference's tree for parity)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device)


def init_cnn(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> dict:
    H, W, C = cfg.input_hw
    params = {}
    in_c, h, w = C, H, W
    k = cfg.cnn_kernel
    for i, ch in enumerate(cfg.cnn_channels):
        params[f"conv{i}"] = {
            "w": _dense_init(gen, (k, k, in_c, ch), 1.0 / math.sqrt(k * k * in_c),
                             device),
            "b": torch.zeros((ch,), dtype=torch.float32, device=device),
        }
        in_c = ch
        h, w = h // 2, w // 2  # 2x2 maxpool each conv
    dims = (h * w * in_c,) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    for i in range(len(dims) - 1):
        params[f"fc{i}"] = {
            "w": _dense_init(gen, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), device),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
    return params


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> dict:
    dims = (cfg.input_hw[0],) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    return {
        f"fc{i}": {
            "w": _dense_init(gen, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), device),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
        for i in range(len(dims) - 1)
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> dict:
    if cfg.family == "cnn":
        return init_cnn(gen, cfg, device)
    if cfg.family == "mlp":
        return init_mlp(gen, cfg, device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported (ROADMAP.md Queue 1 item 10)")


def _dense_stack(params, x, n: int):
    for i in range(n):
        p = params[f"fc{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def cnn_forward(params, x, cfg: ModelConfig):
    """x: (B, H, W, C) f32 -> logits (B, num_classes). 'SAME' convolution
    (odd kernel: padding k // 2), VALID 2x2 max-pool, NHWC flatten."""
    x = x.permute(0, 3, 1, 2)
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=cfg.cnn_kernel // 2)
        x = torch.relu(x + p["b"][:, None, None])
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _dense_stack(params, x, len(cfg.mlp_hidden) + 1)


def mlp_forward(params, x, cfg: ModelConfig):
    return _dense_stack(params, x, len(cfg.mlp_hidden) + 1)


def _mean_xent(logits, y):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def cnn_loss(params, batch, cfg: ModelConfig):
    return _mean_xent(cnn_forward(params, batch["x"], cfg), batch["y"])


def mlp_loss(params, batch, cfg: ModelConfig):
    return _mean_xent(mlp_forward(params, batch["x"], cfg), batch["y"])


def forward(params, x, cfg: ModelConfig):
    if cfg.family == "cnn":
        return cnn_forward(params, x, cfg)
    if cfg.family == "mlp":
        return mlp_forward(params, x, cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported (ROADMAP.md Queue 1 item 10)")


def loss_fn(params, batch, cfg: ModelConfig):
    return _mean_xent(forward(params, batch["x"], cfg), batch["y"])


def predict(params, x, cfg: ModelConfig):
    return torch.argmax(forward(params, x, cfg), dim=-1)


def accuracy(params, batch, cfg: ModelConfig) -> torch.Tensor:
    return torch.mean((predict(params, batch["x"], cfg) == batch["y"]).float())
