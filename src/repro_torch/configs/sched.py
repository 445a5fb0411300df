"""Scheduler x staleness-metric benchmark presets: a copy of the
reference's ``repro.configs.sched`` with the same presets and numbers.

A preset pins the grid of ``benchmarks/sched_staleness.py``: which dispatch
schedulers (``federated.scheduler.SCHEDULERS``), which asyncfeded distance
metrics (``core.psa.DISTANCE_METRICS``), which concurrency levels and which
tolerance (alpha) levels get an AULC operating-point cell, plus how many
seed lanes back each cell. ``sched-paper`` is the study grid on the paper
protocol (Dirichlet alpha=0.1 hardest setting, paper concurrency 0.1 plus a
2x level for the staleness-vs-update-frequency axis); ``sched-smoke`` is
the tier-1 CI cell — a tiny grid proving the whole bench path end to end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class SchedBenchPreset:
    schedulers: Tuple[str, ...] = ("uniform", "period", "staleness")
    metrics: Tuple[str, ...] = ("l2", "cosine", "sketch")
    concurrencies: Tuple[float, ...] = (0.1, 0.2)
    # asyncfeded mixing alpha — the tolerance knob of the operating point
    alphas: Tuple[float, ...] = (0.3, 0.6)
    seeds: Tuple[int, ...] = (0, 1)
    dirichlet_alpha: float = 0.1      # paper's hardest heterogeneity setting

    @property
    def cells(self) -> int:
        return (len(self.schedulers) * len(self.metrics)
                * len(self.concurrencies) * len(self.alphas))


SCHED_PRESETS = {
    "sched-paper": SchedBenchPreset(),
    # CI smoke: 2 schedulers x 3 metrics x 1 concurrency x 1 alpha,
    # 2 seed lanes — every code path (incl. the structural sketch step),
    # minutes not hours
    "sched-smoke": SchedBenchPreset(schedulers=("uniform", "period"),
                                    concurrencies=(0.1,), alphas=(0.6,),
                                    seeds=(0, 1)),
}


def get_sched_preset(name: str) -> SchedBenchPreset:
    if name not in SCHED_PRESETS:
        raise KeyError(f"unknown sched preset {name!r}; "
                       f"known: {sorted(SCHED_PRESETS)}")
    return SCHED_PRESETS[name]
