"""Frozen arithmetic of the yardstick: the H100's published peaks, the
model FLOPs of a training sample, and the work each FL kernel must do.

The kernel formulas are copies of ``repro_torch.kernels.buffer_agg.cost``
and ``repro_torch.kernels.sens_sketch.cost`` as they stood when this
benchmark was defined; the program may change its own, these stay.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4

# integer operations per (element, projection row) of the sketch's hash
SKETCH_INT_OPS_PER_ELEM_ROW = 9


def cnn_layers(cfg: dict):
    """``(kind, macs_per_sample, params)`` of each layer of the paper's CNN
    (``cnn_channels`` 5x5 SAME convolutions, each then a 2x2 max-pool, then
    the dense stack ``mlp_hidden`` and the classes)."""
    H, W, C = cfg["input_hw"]
    k = cfg["cnn_kernel"]
    out = []
    h, w, c = H, W, C
    for ch in cfg["cnn_channels"]:
        out.append(("conv", h * w * ch * k * k * c, k * k * c * ch + ch))
        h, w, c = h // 2, w // 2, ch
    dims = [h * w * c] + list(cfg["mlp_hidden"]) + [cfg["num_classes"]]
    for a, b in zip(dims[:-1], dims[1:]):
        out.append(("dense", a * b, a * b + b))
    return out


def forward_flops_per_sample(cfg: dict) -> int:
    """Multiply-adds of one sample's forward pass, two FLOPs each (bias,
    activation and pooling not counted)."""
    return 2 * sum(m for _, m, _ in cnn_layers(cfg))


def num_params(cfg: dict) -> int:
    return sum(p for _, _, p in cnn_layers(cfg))


def trained_samples(n: int, epochs: int, batch_size: int) -> int:
    """Samples one client's local update trains on: ``epochs`` passes of
    ``n // bs`` full batches of ``bs = min(batch_size, n)`` (drop-last)."""
    bs = min(batch_size, n)
    return epochs * (n // bs) * bs


def buffer_agg_cost(L: int, d: int) -> dict:
    """One Eq. 20 apply: ``2 L d`` flops, U, g and w read once and the
    output written once (float32)."""
    return {"flops": 2.0 * L * d, "nbytes": 4.0 * (L * d + 2 * d + L)}


def sens_sketch_cost(members: int, n: int, k: int) -> dict:
    """One sketch launch over ``members`` rows of ``n`` elements: 12 bytes
    an element (theta, g, F) and 4k a member's output; 9k integer
    operations an element; 6 + 2k flops an element."""
    return {"flops": float(members * n * (6 + 2 * k)),
            "nbytes": float(12 * members * n + 4 * k * members),
            "int_ops": float(SKETCH_INT_OPS_PER_ELEM_ROW * k * members * n)}


def bound_s(cost: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth, the flops over the f32 peak and the integer operations
    over the INT32 peak."""
    return max(cost.get("nbytes", 0.0) / HBM_BYTES_PER_S,
               cost.get("flops", 0.0) / F32_FLOPS_PER_S,
               cost.get("int_ops", 0.0) / INT32_OPS_PER_S)

