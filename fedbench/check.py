"""The comparison that decides ``correct``.

The simulation is chaotic: two runs that differ only in rounding drift
apart receive by receive (on the card a float32 reference and a float64
one differ by about 0.2 of the global model's change by the second
aggregation), so a whole simulation cannot be held to a reference at
float32's precision. So the plain reference (float64,
``fedbench.reference``) follows the window's first simulation stage by
stage from the simulation's own state: for each global update that the
mix judges (``judge_versions``, ranges of 1-based updates: the first ones,
and a late one past the thermometer's queue and the lr decay's first
steps), it trains each client of that update again from the global model
the record says the client was dispatched with, and works the policy's
step out again from the record's updates, sketches and global models
(``fedbench/reference/policies/<policy>.py``). The schedule is compared
over the whole horizon.

Numbers, each against the cell's limit (``limits/<workload>.json``):

- ``schedule``: receives whose (time, version gap, client) differ from the
  reference's, plus the difference in their count. Exact: limit 0.
- ``update_norm_gap``: each judged client update, leaf by leaf: the gap
  between the program's norm and the reference's, over the reference's
  norm in that leaf or in the median leaf, whichever is larger; the worst
  leaf of the worst update.
- ``update_gap_med``: the same by the median leaf (steadier: a long local
  SGD moves a few leaves first).
- ``update_gap_mid``: the median over the first range's updates of each
  update's median-leaf gap. Steady against what moves single updates: on
  a few seeds in some tens a float32 local SGD crosses a ReLU or max-pool
  tie the other way than float64 and one update reads some hundred times
  its peers, while a lower precision moves every update.
- ``late_update_norm_gap``, ``late_update_gap_med``: the same over the
  later ranges' updates. Apart from the first ones, which all start from
  the initial model: from a trained model a local SGD of up to 50 steps
  amplifies rounding by some tens of times, and a client dispatched from a
  stale global model reads only some tens of times above that.
- the policy's numbers (its module's ``NUMBERS``; ``late_`` ones over the
  later ranges).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from fedbench.reference.numbers import norm_gaps
from fedbench.reference.sim import (Local, judged_receives, policy,
                                    precision, schedule)
from fedbench.world import layout


def schedule_mismatch(prog: List[tuple], ref: List[tuple]) -> int:
    bad = abs(len(prog) - len(ref))
    for (t, tau, c), (rt, rtau, rc) in zip(prog, ref):
        bad += (t != rt) or (int(tau) != int(rtau)) or (int(c) != int(rc))
    return int(bad)


def numbers(mix: dict) -> tuple:
    """The names of a mix's numbers, in order."""
    return ("schedule", "update_norm_gap", "update_gap_med",
            "update_gap_mid", "late_update_norm_gap",
            "late_update_gap_med") \
        + policy(mix["policy"]).NUMBERS


def judged_versions(mix: dict) -> List[tuple]:
    """``(version, prefix)`` of every judged update: ``""`` in the first
    range, ``"late_"`` in the others."""
    return [(v, "late_" if n else "")
            for n, (lo, hi) in enumerate(mix["judge_versions"])
            for v in range(int(lo), int(hi) + 1)]


def kept_receives(mix: dict) -> int:
    """How many receives of a simulation the record keeps: those up to the
    last judged update."""
    return judged_receives(mix, max(v for v, _ in
                                    judged_versions(mix)))[-1] + 1


def compare(cfg: dict, mix: dict, world, rec: dict,
            device) -> Dict[str, float]:
    """``rec``: the judged simulation's record (``Program.run`` with
    ``keep``), or a record of the same layout: ``receive_log``,
    ``lane_seeds``, ``timeline_seed``, each lane's ``rows`` [(update,
    client model, global model after, sketch)] of the first
    ``kept_receives`` receives and its per-update ``logs``."""
    pol = policy(mix["policy"])
    out = dict.fromkeys(numbers(mix), 0.0)
    out["schedule"] = 0
    sched = schedule(cfg, mix, rec["timeline_seed"])
    ref_log = [(r.t, r.tau, r.client) for r in sched]
    judged = [(v, p, judged_receives(mix, v))
              for v, p in judged_versions(mix)]
    need = kept_receives(mix)
    mids = []
    sizes = [math.prod(s) for _, s in layout(cfg)]
    for rows in rec["rows"]:
        out["schedule"] += schedule_mismatch(rec["receive_log"], ref_log)
        if len(rows) < need or len(sched) < need:
            return {k: (v if k == "schedule" else math.inf)
                    for k, v in out.items()}
    with precision(device, "f64"):
        local = Local(cfg, world, device, torch.float64)
        sketcher = pol.sketcher(local.model, world, mix, device,
                                torch.float64)
        w0 = world.init_flat.to(device=device, dtype=torch.float64)

        def on(v):
            return v.detach().to(device, torch.float64)

        for s, (rows, log) in enumerate(zip(rec["rows"], rec["logs"])):
            ctx = SimpleNamespace(
                mix=mix, rows=rows, log=log, on=on, sizes=sizes,
                sketcher=sketcher, taus=[r.tau for r in sched],
                global_after=lambda i, rows=rows: (
                    w0 if i < 0 else on(rows[i][2])))
            for v, pre, receives in judged:
                for i in receives:
                    start = ctx.global_after(sched[i].trigger)
                    want = local.train(start, sched[i].client, i,
                                       rec["lane_seeds"][s]) - start
                    g = norm_gaps(on(rows[i][0]), want, sizes)
                    for k, x in (("update_norm_gap", g.max()),
                                 ("update_gap_med", np.median(g))):
                        out[pre + k] = max(out[pre + k], float(x))
                    if not pre:
                        mids.append(float(np.median(g)))
                pol.judge(ctx, v, receives, out, pre)
    out["update_gap_mid"] = float(np.median(mids)) if mids else 0.0
    return out


def judge(numbers_: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """Every number the cell has a limit for is within it (a NaN never
    is)."""
    return all(numbers_[k] <= v["limit"] for k, v in limits.items())
