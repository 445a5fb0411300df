"""Spans and kernel tallies on the profiler's clock.

``span(name)`` marks a stretch of the FL main path as
``repro_torch.<name>``: a ``torch.profiler.record_function`` while a
profiler records, so that it lands in the same kineto trace as the CUDA
activity, on the same clock; and one shared no-op otherwise, which costs a
read of the profiler's flag and allocates nothing. Any ``torch.profiler``
session over a simulation sees the spans, and a Chrome trace it exports
shows them on the host's timeline above the kernels:

    with torch.profiler.profile(activities=[...CPU, ...CUDA]) as prof:
        run_async(...)
    prof.export_chrome_trace("sim.json")

While a profiler records, the program also tallies: each hand-written
kernel's launch adds one count under its cost (``op_cost.report``, when
no ``launch.op_cost.OpCounter`` is active; ``kernel_tally()``), and named
counters add what the program counts (``count``; ``counts()``: the cohort
engine's ``member_steps_run`` and ``member_steps_live``). The tallies
hold what was counted in the process while a profiler recorded. Nothing
here adds device work, a sync or a device allocation, and there is no
switch: tracing is on exactly while a profiler records.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "repro_torch."

# (name, flops, nbytes, transcendentals, int_ops) -> launches; and the
# named counters
_TALLY: Counter = Counter()
_COUNTS: Counter = Counter()


def recording() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records: the flag
    its start and stop set, the cheapest test that is true exactly then."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while no profiler records: enters and exits, nothing
    more."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A context manager over the stretch named ``repro_torch.<name>``:
    ``OFF`` unless a profiler records."""
    if not recording():
        return OFF
    return torch.profiler.record_function(PREFIX + name)


def tally_kernel(name: str, flops: float, nbytes: float,
                 transcendentals: float, int_ops: float) -> None:
    """One launch of ``name`` at this cost, counted while a profiler
    records."""
    _TALLY[(name, float(flops), float(nbytes), float(transcendentals),
            float(int_ops))] += 1


def kernel_tally() -> Dict[Tuple[str, float, float, float, float], int]:
    """A copy of the launches counted so far, by (name, flops, nbytes,
    transcendentals, int_ops)."""
    return dict(_TALLY)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """A copy of the named counters."""
    return dict(_COUNTS)
