"""Finds a cell's pieces by the names in ``BENCHMARK.json``: its
configuration file, ``traffic/<traffic>.json``, ``limits/<workload>.json``
and ``metrics/<metric>.py`` for each per-layer metric that lists it (or
lists no cells). A new cell, mix or metric is new files and entries, never
an edit here."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def _load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "fedbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark at ``root`` (the checkout's
    root, which holds ``BENCHMARK.json``); the mixes, limits and readers
    lie in the first of its ``paths``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    wl = cells[workload]
    base = root / bench["paths"][0]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[wl["config"]]["file"]).read_text())
    mix = json.loads((base / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: _load_reader(base / "metrics" / f"{m['name']}.py")
               for m in per_layer}
    return Cell(name=workload, chips=int(wl["chips"]), cfg=cfg, mix=mix,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=per_layer, readers=readers)
