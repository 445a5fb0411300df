"""Fused Eq. 8 sensitivity + hashed Rademacher sketch of flat layouts.

Replaces the Pallas TPU kernel ``repro/kernels/sens_sketch.py``
(``sens_sketch_pallas``, hash ``_pcg``). On CUDA tensors the wrappers
launch the hand-written kernel ``csrc/sens_sketch.cu``; on CPU tensors
they run the plain versions below; on ``meta`` tensors they return empty
results and compute nothing. They never fall back from one to the other.
On the card and on meta they report a launch's cost (``cost``) to the op
counter in use (``launch/op_cost.py``), or without one, while a profiler
records, to ``common.trace``'s kernel tally. Two entries share the kernel and
its launch count (one per call):

- ``sens_sketch_rows(theta, g, f, table)``: (B, d) rows of one flat
  layout -> (B, k), every leaf of every member in one call. ``table``
  (``layout_table``) holds each leaf's offset, size, seed and hash base,
  and on a card its tiles' records, cached per (layout, seed, k, device)
  so that a call copies nothing to the device and never syncs.
- ``sens_sketch(theta, g, f, k=, seed=, index_offset=)``: one (d,)
  vector -> (k,), the one-leaf case, hashing element i as global index
  ``index_offset + i`` (per-shard sketches then sum to the full one).

Bound on the H100: the INT32 pipe — 2k PCG hashes an element (9
operations per element and row on that pipe) against 12 bytes of HBM.
The kernel keeps the k sums in registers, hashes each sign where it is
used, and reduces in a fixed order (the last block of each member sums
its tiles' partials, picked by an integer ticket; no floating-point
atomics), so repeated runs give identical bits (see the source for the
design notes).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sketch import leaf_seed_host, rademacher_row
from repro_torch.kernels import _build
from repro_torch.launch import op_cost

KS = (1, 4, 16, 32)       # k values the kernel is instantiated for
# integer operations per (element, projection row) on the INT32 pipe: the
# inner PCG hash 5, the outer 3 (its dead shift and XOR dropped), the
# sign's move onto s 1 (chip_smoke.py's SKETCH_INT_OPS_PER_ELEM_ROW)
INT_OPS_PER_ELEM_ROW = 9
TILE = 2048               # elements of a kernel item: a tile of one leaf
_MUL_A, _ADD_C, _M = 747796405, 2891336453, 0xFFFFFFFF
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "sens_sketch_rows_f32": [_P, _P, _P, _LL, _I, _P, _I, _I, _P, _P, _P, _I,
                             _I, _P],
    "sens_sketch_probe_f32": [_P, _P, _P, _LL, _I, _P, _I, _I, _P, _P, _P, _I,
                              _I, _P, _P],
    "sens_sketch_grid": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}


def cost(members: int, n: int, k: int) -> dict:
    """One launch's work on ``members`` rows of ``n`` elements: the bound's
    12 bytes an element (theta, g, F read once) and 4k a member's output,
    ``INT_OPS_PER_ELEM_ROW`` x k integer operations an element, and the
    float work (s in 6 flops an element, k multiply-adds into the rows)."""
    return {"flops": float(members * n * (6 + 2 * k)),
            "nbytes": float(12 * members * n + 4 * k * members),
            "int_ops": float(INT_OPS_PER_ELEM_ROW * k * members * n)}


class SketchTable(NamedTuple):
    """One flat layout's sketch parameters: ``leaves`` are (offset, size,
    seed, hash base) per leaf; ``tiles`` the kernel's (ntiles, 4) int64
    records on a CUDA device (``tile_records``), None on the CPU."""
    k: int
    size: int
    leaves: Tuple[Tuple[int, int, int, int], ...]
    tiles: Optional[torch.Tensor]


def tile_records(leaves, k: int, tile: int = TILE) -> np.ndarray:
    """(ntiles, 4) int64: every leaf cut into tiles of ``tile`` elements
    (the last one shorter), each as [its first element in a row, its
    length, its leaf's seed, the inner hash state of its first element,
    ((base + j) * k * A + C) mod 2**32]."""
    recs = []
    for off, size, seed, base in leaves:
        j0 = np.arange(0, size, tile, dtype=np.int64)
        j = (base + j0).astype(np.uint64)      # uint64 wraps: exact mod 2**32
        state = (j * np.uint64(k * _MUL_A & _M) + np.uint64(_ADD_C)) \
            & np.uint64(_M)
        recs.append(np.stack([off + j0, np.minimum(tile, size - j0),
                              np.full_like(j0, seed),
                              state.astype(np.int64)], axis=1))
    return np.concatenate(recs).astype(np.int64)


def _table(leaves, k: int, device) -> SketchTable:
    if k not in KS:
        raise ValueError(f"sens_sketch: k={k} not in the kernel's {KS}")
    size = sum(n for _, n, _, _ in leaves)
    tiles = None
    if torch.device(device).type == "cuda":
        tiles = torch.from_numpy(tile_records(leaves, k)).to(device)
    return SketchTable(k, size, tuple(leaves), tiles)


@functools.lru_cache(maxsize=64)
def layout_table(sizes: Tuple[int, ...], seed: int, k: int,
                 device) -> SketchTable:
    """The table of a flat layout of leaves with ``sizes`` (in order):
    leaf i hashed with ``leaf_seed_host(seed, i)`` from index 0, as the
    reference's ``sketch_tree_fused`` does leaf by leaf."""
    offsets = np.cumsum((0,) + tuple(sizes[:-1])).tolist()
    return _table([(o, int(n), leaf_seed_host(seed & _M, i), 0)
                   for i, (o, n) in enumerate(zip(offsets, sizes))],
                  k, device)


@functools.lru_cache(maxsize=64)
def vector_table(d: int, seed: int, index_offset: int, k: int,
                 device) -> SketchTable:
    """The one-leaf table of a (d,) vector hashed with ``seed`` from global
    index ``index_offset``."""
    return _table([(0, d, seed & _M, index_offset & _M)], k, device)


def sens_sketch_plain(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor,
                      *, k: int = 16, seed: int = 0,
                      index_offset: int = 0) -> torch.Tensor:
    """The kernel's function on one (d,) vector in eager torch: the
    one-leaf case of ``sens_sketch_rows_plain``."""
    table = vector_table(theta.shape[0], seed, index_offset, k, "cpu")
    return sens_sketch_rows_plain(theta[None], g[None], f[None], table)[0]


def sens_sketch_rows_plain(theta: torch.Tensor, g: torch.Tensor,
                           f: torch.Tensor, table: SketchTable) -> torch.Tensor:
    """The kernel's function on (B, d) rows in eager torch: per leaf and
    projection row, the sum of s times the int64-emulated signs."""
    k = table.k
    s = torch.abs(g * theta - 0.5 * f * torch.square(theta))
    out = torch.zeros((s.shape[0], k), dtype=torch.float32, device=s.device)
    for off, n, seed, base in table.leaves:
        lin = (torch.arange(n, dtype=torch.int64, device=s.device) + base) & _M
        leaf = s[:, off:off + n]
        out += torch.stack([torch.sum(leaf * rademacher_row(seed, lin, r, k),
                                      dim=-1) for r in range(k)], dim=-1)
    return out / math.sqrt(k)


def _inputs(theta, g, f, what: str):
    if g.shape != theta.shape or f.shape != theta.shape:
        raise ValueError(f"sens_sketch: theta{tuple(theta.shape)} "
                         f"g{tuple(g.shape)} f{tuple(f.shape)} must be "
                         f"equal {what}")
    dev = theta.device
    if g.device != dev or f.device != dev:
        raise ValueError("sens_sketch: all inputs must be on one device")
    if theta.numel() < 1:
        raise ValueError("sens_sketch: empty input")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"sens_sketch: unsupported device {dev}")
    return tuple(_build.as_f32(x, "sens_sketch", n)
                 for x, n in ((theta, "theta"), (g, "g"), (f, "f")))


_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _tickets(dev: torch.device, members: int) -> torch.Tensor:
    """The kernel's per-member ticket counters on ``dev``: zeros, and left
    zero by every launch, so one buffer serves every call on the stream."""
    buf = _TICKETS.get(dev)
    if buf is None or buf.shape[0] < members:
        buf = torch.zeros(max(members, 64), dtype=torch.int32, device=dev)
        _TICKETS[dev] = buf
    return buf


def _launch(t, gg, ff, members: int, table: SketchTable, *, grid: int = 0,
            mode: int = 0, clocks: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """The kernel on ``members`` rows of ``table.size`` elements, contiguous
    in the CUDA tensors t, gg, ff; returns (members * k,) sketches. Mode 0
    is the kernel, 1-2 the probe instantiations (see ``probe``)."""
    dev = t.device
    if table.tiles is None or table.tiles.device != dev:
        raise ValueError(f"sens_sketch: the table is not on {dev}")
    lib = _build.load("sens_sketch", _SIG)
    ntiles, k = table.tiles.shape[0], table.k
    # the (members * ntiles, k) partials, then the output, in one block
    scratch = torch.empty((members * (ntiles + 1) * k,), dtype=torch.float32,
                          device=dev)
    out = scratch[members * ntiles * k:]
    ptrs = (t.data_ptr(), gg.data_ptr(), ff.data_ptr())
    aligned = int(all(p % 16 == 0 for p in ptrs))
    args = (*ptrs, table.size, members, table.tiles.data_ptr(), ntiles,
            aligned, scratch.data_ptr(), _tickets(dev, members).data_ptr(),
            out.data_ptr())
    # the current stream's handle, without a Python Stream object a call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if mode == 0:
        err = lib.sens_sketch_rows_f32(*args, k, grid, stream)
    else:
        err = lib.sens_sketch_probe_f32(*args, grid, mode, clocks.data_ptr(),
                                        stream)
    _build.check(err, "sens_sketch")
    return out


def sens_sketch_rows(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor,
                     table: SketchTable) -> torch.Tensor:
    """(B, d) theta, g, F rows of ``table``'s layout -> (B, k) f32 sketches
    of |g*theta - F*theta^2/2|, including the 1/sqrt(k) scale: one kernel
    launch for all B members and all leaves."""
    if theta.dim() != 2:
        raise ValueError(f"sens_sketch_rows: theta{tuple(theta.shape)} is "
                         f"not (B, d)")
    t, gg, ff = _inputs(theta, g, f, "(B, d) rows")
    if t.shape[1] != table.size:
        raise ValueError(f"sens_sketch_rows: rows of {t.shape[1]} elements, "
                         f"the table's layout has {table.size}")
    if t.device.type == "cpu":
        return sens_sketch_rows_plain(t, gg, ff, table)
    op_cost.report("sens_sketch", **cost(t.shape[0], t.shape[1], table.k))
    if t.device.type == "meta":
        return torch.empty((t.shape[0], table.k), dtype=torch.float32,
                           device="meta")
    out = _launch(t, gg, ff, t.shape[0], table).view(t.shape[0], table.k)
    sens_sketch.launches += 1
    return out


def sens_sketch(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor, *,
                k: int = 16, seed: int = 0, index_offset: int = 0) -> torch.Tensor:
    """Flat theta, g, F (d,) -> (k,) f32 sketch of |g*theta - F*theta^2/2|,
    including the 1/sqrt(k) scale. ``index_offset`` hashes element i as
    global index ``index_offset + i`` (per-shard sketches then sum to the
    full one)."""
    if theta.dim() != 1:
        raise ValueError(f"sens_sketch: theta{tuple(theta.shape)} is not a "
                         f"(d,) vector")
    if k not in KS:
        raise ValueError(f"sens_sketch: k={k} not in the kernel's {KS}")
    t, gg, ff = _inputs(theta, g, f, "(d,) vectors")
    if t.device.type == "cpu":
        return sens_sketch_plain(t, gg, ff, k=k, seed=seed,
                                 index_offset=index_offset)
    op_cost.report("sens_sketch", **cost(1, t.shape[0], k))
    if t.device.type == "meta":
        return torch.empty((k,), dtype=torch.float32, device="meta")
    table = vector_table(t.shape[0], seed, index_offset, k, t.device)
    out = _launch(t, gg, ff, 1, table)
    sens_sketch.launches += 1
    return out


sens_sketch.launches = 0


def grid_of(k: int, items: int) -> Tuple[int, int, int]:
    """(blocks, SMs, resident blocks an SM) of the grid that a call of
    ``items`` = B x tiles items launches at ``k``, as the kernel's launcher
    sizes it on the current device."""
    lib = _build.load("sens_sketch", _SIG)
    sms, per = ctypes.c_int(0), ctypes.c_int(0)
    grid = lib.sens_sketch_grid(k, items, ctypes.byref(sms), ctypes.byref(per))
    return grid, sms.value, per.value


def probe(theta: torch.Tensor, g: torch.Tensor, f: torch.Tensor,
          table: SketchTable, *, grid: int, loads: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k = 16 kernel on (B, d) CUDA rows with a given ``grid``,
    also writing each block's SM clock and global timer (ns) at its start
    and end: returns ``(out (B, 16), clocks (grid, 4) int64)``. With
    ``loads=False`` s is made from the index instead of read, which times
    the hashing alone. For measurement only: not counted in
    ``sens_sketch.launches``."""
    if table.k != 16:
        raise ValueError("sens_sketch.probe: k must be 16")
    t, gg, ff = _inputs(theta, g, f, "(B, d) rows")
    clocks = torch.zeros((grid, 4), dtype=torch.int64, device=t.device)
    out = _launch(t, gg, ff, t.shape[0], table, grid=grid,
                  mode=1 if loads else 2, clocks=clocks)
    return out.view(t.shape[0], 16), clocks


def sm_clock_ghz(clocks: torch.Tensor) -> float:
    """Mean SM clock over a probe's blocks: their clock cycles over their
    global-timer nanoseconds."""
    c = clocks.cpu().numpy().astype(np.float64)
    return float(np.sum(c[:, 1] - c[:, 0]) / np.sum(c[:, 3] - c[:, 2]))

