"""Grouped member GEMM: ``lhs (G, M, K) @ rhs (G, K, N) -> (G, M, N)``.

Replaces the Pallas TPU kernel ``repro/kernels/grouped_matmul.py``
(``grouped_matmul_pallas``). The cohort engine's ``member_kernel="grouped"``
routes every member-batched dense product of a wave through it
(``models/member_math.py``), forward and backward. On a CUDA tensor the
wrapper launches the hand-written kernel ``csrc/grouped_matmul.cu``; on a
CPU tensor it runs the plain version below; on a ``meta`` tensor it
returns an empty result and computes nothing. It never falls back from one
to the other. On the card and on meta it reports the launch's cost
(``cost``) to the op counter in use (``launch/op_cost.py``), or without
one, while a profiler records, to ``common.trace``'s kernel tally.

Contract (the reference's, oracle ``repro/kernels/ref.py``
``grouped_matmul_ref``): f32 accumulation; float32 or bfloat16 inputs,
output in the promoted dtype (bf16 x f32 -> f32); an optional per-group
``valid`` mask, and a group with ``valid == 0`` comes back exactly zero.
The kernel reads both operands through their strides, so transposed views
cost no copy; bf16 operands are cast to f32 first (exact).

The kernel splits K into ``split_k(M, N, K)`` slices: pass 1 computes
each (group, 64 x 64 tile, slice) block, and for more than one slice a
second pass sums the slices' f32 partials (a ``torch.empty`` workspace on
the current stream) in the fixed order s = 0 .. S-1. No atomics, so
repeated runs give identical bits. ``grouped_matmul.launches`` counts
wrapper calls: one per call, also when a call issues both passes.

Bound on the H100 at the main path's fc0 shape: FP32 operations on the
CUDA cores (parity runs without TF32); see the source for the design.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import op_cost

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"grouped_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _I, _I, _I, _P],
        "grouped_matmul_blocks": [_I, _I, _I, _I, ctypes.POINTER(_L)]}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_G = 65535
TILE = 64          # output tile edge of a pass-1 block
SLAB = 32          # K depth of one shared-memory slab
MIN_SLICE = 256    # K depth below which a slice is not worth its partials
SMS = 132          # streaming multiprocessors of the H100 SXM
# groups that split_k sizes the split for: the smallest wave of the image
# bucket grid (federated.cohort.bucket_size), the cohort main path's usual G
FILL_GROUPS = 4


def cost(G: int, M: int, K: int, N: int) -> dict:
    """One call's work: ``2 G M N K`` flops, and the float32 operands read
    and the output written once (the bound's bytes)."""
    return {"flops": 2.0 * G * M * N * K,
            "nbytes": 4.0 * G * (M * K + K * N + M * N)}


def split_k(M: int, N: int, K: int) -> Tuple[int, int]:
    """(S, slice): the K slices of one group's product, a function of its
    (M, N, K) alone, so a member's sums come out the same in a wave of any
    width G (a sweep lane equals its standalone run).

    Enough (group, tile, slice) blocks for two per SM at ``FILL_GROUPS``
    groups, each slice a multiple of the slab and at least ``MIN_SLICE``
    deep (the last one too), S * slice >= K > (S - 1) * slice; S = 1 when
    that many groups' tiles already fill the card or K is too short to
    split. Wider waves get more blocks, not fewer slices."""
    tiles = FILL_GROUPS * -(-M // TILE) * -(-N // TILE)
    S = max(1, min(-(-2 * SMS // tiles), K // MIN_SLICE))
    while True:
        depth = -(-K // S)
        depth = max(SLAB, -(-depth // SLAB) * SLAB)
        S = max(1, -(-K // depth))
        if S == 1 or K - (S - 1) * depth >= MIN_SLICE:
            return S, depth
        S -= 1


def pass1_blocks(G: int, M: int, N: int, K: int) -> int:
    """Blocks of pass 1 for this shape at ``split_k``'s slice count, from
    the kernel's own launcher (builds the library, so it needs nvcc)."""
    blocks = _L()
    lib = _build.load("grouped_matmul", _SIG)
    _build.check(lib.grouped_matmul_blocks(G, M, N, split_k(M, N, K)[0],
                                           ctypes.byref(blocks)),
                 "grouped_matmul_blocks")
    return blocks.value


def _check(lhs: torch.Tensor, rhs: torch.Tensor, valid) -> None:
    if lhs.dim() != 3 or rhs.dim() != 3 or lhs.shape[0] != rhs.shape[0] \
            or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul: shapes lhs{tuple(lhs.shape)} "
                         f"rhs{tuple(rhs.shape)} do not match (G, M, K), "
                         f"(G, K, N)")
    for what, x in (("lhs", lhs), ("rhs", rhs)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"grouped_matmul: {what} must be float32 or "
                            f"bfloat16, got {x.dtype}")
    if rhs.device != lhs.device:
        raise ValueError("grouped_matmul: all inputs must be on one device")
    if valid is not None and (valid.shape != (lhs.shape[0],)
                              or valid.device != lhs.device):
        raise ValueError(f"grouped_matmul: valid must be ({lhs.shape[0]},) "
                         f"on {lhs.device}, got {tuple(valid.shape)} on "
                         f"{valid.device}")


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function in eager torch: one f32 product per group, then the
    mask (``valid == 0`` groups exactly zero), cast to the promoted dtype."""
    out = torch.stack([torch.matmul(lhs[g].float(), rhs[g].float())
                       for g in range(lhs.shape[0])])
    if valid is not None:
        v = valid.float()[:, None, None]
        out = torch.where(v == 0, torch.zeros_like(out), out * v)
    return out.to(torch.promote_types(lhs.dtype, rhs.dtype))


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lhs (G, M, K) @ rhs (G, K, N) -> fresh contiguous (G, M, N)."""
    _check(lhs, rhs, valid)
    dev = lhs.device
    if dev.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, valid)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"grouped_matmul: unsupported device {dev}")
    G, M, K = lhs.shape
    N = rhs.shape[2]
    S, depth = split_k(M, N, K)
    if G * S > MAX_G or -(-M // TILE) > MAX_G:
        raise ValueError(f"grouped_matmul: G={G} or M={M} exceeds the grid")
    out = torch.empty((G, M, N), device=dev,
                      dtype=torch.promote_types(lhs.dtype, rhs.dtype))
    if out.numel() == 0:
        return out
    a, b = lhs.float(), rhs.float()        # bf16 -> f32 is exact
    v = None if valid is None else valid.to(torch.float32).contiguous()
    ws = torch.empty((S, G, M, N), device=dev) if S > 1 else None
    op_cost.report("grouped_matmul", **cost(G, M, K, N))
    if dev.type == "meta":
        return out
    lib = _build.load("grouped_matmul", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.grouped_matmul(
        a.data_ptr(), b.data_ptr(), None if v is None else v.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), G, M, K, N,
        *a.stride(), *b.stride(), S, depth,
        int(out.dtype == torch.bfloat16), stream)
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
