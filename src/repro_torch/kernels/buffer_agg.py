"""Buffered weighted sum, FedPSA Eq. 20 apply: ``g + sum_l w[l] * U[l]``.

Replaces the Pallas TPU kernel ``repro/kernels/buffer_agg.py``
(``buffer_agg_pallas``). On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/buffer_agg.cu``; on a CPU tensor it runs the
plain version below. It never falls back from one to the other.

Bound on the H100: HBM bandwidth — ``(L + 2) * d * 4`` bytes for ``2 L d``
flops. The kernel streams the slab once with coalesced grid-stride loads,
weights in shared memory, and folds the rows in a fixed order with
``fmaf`` (see the source for the design notes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_L = 256
_P = ctypes.c_void_p
_SIG = {"buffer_agg_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P]}


def buffer_agg_plain(weights: torch.Tensor, global_vec: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in eager torch: the same row order, one
    multiply-add per row into a fresh f32 output."""
    out = global_vec.float().clone()
    for l in range(updates.shape[0]):
        out = torch.addcmul(out, weights[l], updates[l])
    return out


def buffer_agg(weights: torch.Tensor, global_vec: torch.Tensor,
               updates: torch.Tensor) -> torch.Tensor:
    """weights (L,), global_vec (d,), updates (L, d) -> fresh (d,) f32."""
    if updates.dim() != 2 or weights.shape != (updates.shape[0],) \
            or global_vec.shape != (updates.shape[1],):
        raise ValueError(f"buffer_agg: shapes w{tuple(weights.shape)} "
                         f"g{tuple(global_vec.shape)} U{tuple(updates.shape)} "
                         f"do not match (L,), (d,), (L, d)")
    L, d = updates.shape
    if not 1 <= L <= MAX_L or d < 1:
        raise ValueError(f"buffer_agg: need 1 <= L <= {MAX_L} and d >= 1, "
                         f"got L={L} d={d}")
    dev = updates.device
    if weights.device != dev or global_vec.device != dev:
        raise ValueError("buffer_agg: all inputs must be on one device")
    w = _build.as_f32(weights, "buffer_agg", "weights")
    g = _build.as_f32(global_vec, "buffer_agg", "global_vec")
    u = _build.as_f32(updates, "buffer_agg", "updates")
    if dev.type == "cpu":
        return buffer_agg_plain(w, g, u)
    if dev.type != "cuda":
        raise ValueError(f"buffer_agg: unsupported device {dev}")
    lib = _build.load("buffer_agg", _SIG)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.buffer_agg_f32(w.data_ptr(), g.data_ptr(), u.data_ptr(),
                             out.data_ptr(), L, d, stream)
    _build.check(err, "buffer_agg")
    buffer_agg.launches += 1
    return out


buffer_agg.launches = 0
