"""Fused Eq. 8 sensitivity + hashed Rademacher sketch of flat vectors.

Replaces the Pallas TPU kernel ``repro/kernels/sens_sketch.py``
(``sens_sketch_pallas``, hash ``_pcg``). On a CUDA tensor the wrapper
launches the hand-written two-pass kernel ``csrc/sens_sketch.cu``; on a
CPU tensor it runs the plain version below. It never falls back from one
to the other.

Bound on the H100: the INT32 pipe — 2k PCG hashes (9 operations per
element and row on that pipe, 3 more multiplies on the FMA pipe) against
12 bytes of HBM per element. The kernel
keeps the k sums in registers, hashes each sign where it is used, and
reduces in a fixed order in two passes with no atomics, so repeated runs
give identical bits (see the source for the design notes).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.sketch import rademacher_row
from repro_torch.kernels import _build

KS = (1, 4, 16, 32)       # k values the kernel is instantiated for
THREADS = 256             # pass-1 block size (csrc/sens_sketch.cu kThreads)
MAX_BLOCKS = 132 * 4      # pass-1 grid cap: 4 blocks on each of 132 SMs
_P = ctypes.c_void_p
_SIG = {"sens_sketch_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                            ctypes.c_int, _P]}


def num_blocks(d: int) -> int:
    """Pass-1 grid size: a function of d only, so the partial sums — and
    the result's bits — do not depend on anything but the inputs."""
    return max(1, min(-(-d // THREADS), MAX_BLOCKS))


def sens_sketch_plain(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor,
                      *, k: int = 16, seed: int = 0,
                      index_offset: int = 0) -> torch.Tensor:
    """The kernel's function in eager torch, one projection row at a time
    with the int64 emulation of the uint32 hash."""
    s = torch.abs(g * theta - 0.5 * f * torch.square(theta))
    lin = (torch.arange(s.shape[0], dtype=torch.int64, device=s.device)
           + index_offset) & 0xFFFFFFFF
    rows = [torch.sum(s * rademacher_row(seed, lin, r, k)) for r in range(k)]
    return torch.stack(rows) / math.sqrt(k)


def sens_sketch(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor, *,
                k: int = 16, seed: int = 0, index_offset: int = 0) -> torch.Tensor:
    """Flat theta, g, F (d,) -> (k,) f32 sketch of |g*theta - F*theta^2/2|,
    including the 1/sqrt(k) scale. ``index_offset`` hashes element i as
    global index ``index_offset + i`` (per-shard sketches then sum to the
    full one)."""
    if theta.dim() != 1 or g.shape != theta.shape or f.shape != theta.shape:
        raise ValueError(f"sens_sketch: theta{tuple(theta.shape)} "
                         f"g{tuple(g.shape)} f{tuple(f.shape)} must be equal "
                         f"(d,) vectors")
    if k not in KS:
        raise ValueError(f"sens_sketch: k={k} not in the kernel's {KS}")
    d = theta.shape[0]
    if d < 1:
        raise ValueError("sens_sketch: empty input")
    dev = theta.device
    if g.device != dev or f.device != dev:
        raise ValueError("sens_sketch: all inputs must be on one device")
    t, gg, ff = (_build.as_f32(x, "sens_sketch", n)
                 for x, n in ((theta, "theta"), (g, "g"), (f, "f")))
    seed &= 0xFFFFFFFF
    if dev.type == "cpu":
        return sens_sketch_plain(t, gg, ff, k=k, seed=seed,
                                 index_offset=index_offset)
    if dev.type != "cuda":
        raise ValueError(f"sens_sketch: unsupported device {dev}")
    lib = _build.load("sens_sketch", _SIG)
    nb = num_blocks(d)
    partials = torch.empty((nb, k), dtype=torch.float32, device=dev)
    out = torch.empty(k, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sens_sketch_f32(t.data_ptr(), gg.data_ptr(), ff.data_ptr(),
                              partials.data_ptr(), out.data_ptr(), d, seed,
                              index_offset & 0xFFFFFFFF, k, nb, stream)
    _build.check(err, "sens_sketch")
    sens_sketch.launches += 1
    return out


sens_sketch.launches = 0
