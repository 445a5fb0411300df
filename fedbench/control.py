"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m fedbench.control --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults stale_redispatch,drop_slot] \\
        [--fault-seeds 1,2,3]

For each seed the window's first simulation is judged as a run judges it
(``fedbench.check``), made by

- the program itself (``sound``: the lower readings), on ``--seeds``;
- the control, on ``--control-seeds``: the plain reference in the nearest
  precision below, TF32 (cuBLAS and cuDNN on the tensor cores; on a CPU,
  TF32 rounding of every product's operands), put in the program's place;
- the program with each fault named planted (``fedbench.faults``), on
  ``--fault-seeds``.

Prints one JSON line a seed and case with the numbers compared, the
seconds of the comparison, and whether the cell's limits pass them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext

import torch

from fedbench import check
from fedbench.faults import FAULTS
from fedbench.reference.sim import simulate
from fedbench.world import make_world, sub_seed


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def control_record(cfg: dict, mix: dict, world, lane_seeds, T: int,
                   device) -> dict:
    """The reference in TF32, in the layout of ``Program.run``'s record."""
    refs = [simulate(cfg, mix, world, seed=s, timeline_seed=T, device=device,
                     mode="tf32",
                     versions=max(v for v, _ in check.judged_versions(mix)))
            for s in lane_seeds]
    return {"receive_log": refs[0]["receive_log"],
            "lane_seeds": list(lane_seeds), "timeline_seed": T,
            "rows": [r["rows"] for r in refs],
            "logs": [[{k: _host(v) for k, v in e.items()} for e in r["log"]]
                     for r in refs]}


def cases(cell, seed: int, device: str, faults=(), control: bool = True
          ) -> list:
    """``[(case, numbers, seconds)]``: the control's (with ``control``) and
    each case's in ``faults`` (``"sound"``: the program as it is)."""
    cfg, mix = cell.cfg, cell.mix
    S, T = int(mix["lanes"]), int(mix["timeline_seed"])
    lane_seeds = [sub_seed(seed, "sim", 0, s) for s in range(S)]
    world = make_world(cfg, seed, device)
    out = []

    def judged(case, rec):
        t0 = time.perf_counter()
        numbers = check.compare(cfg, mix, world, rec, device)
        out.append((case, numbers, time.perf_counter() - t0))

    if control:
        judged("control_tf32",
               control_record(cfg, mix, world, lane_seeds, T, device))
    if faults:
        from fedbench.program import Program
        prog = Program(cfg, mix, world, device)
        try:
            for name in faults:
                with FAULTS.get(name, nullcontext)():
                    rec = prog.run(mix["horizon"], lane_seeds, T,
                                   keep=check.kept_receives(mix))
                judged(name, rec)
                del rec
        finally:
            prog.close()
    return out


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    from fedbench.discover import load_cell
    from fedbench.run import ROOT
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("fedbench.control: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    faults = [f for f in args.faults.split(",") if f]
    sound, ctl, bad = (_seeds(args.seeds), _seeds(args.control_seeds),
                       _seeds(args.fault_seeds))
    for seed in sorted(set(sound) | set(ctl) | set(bad)):
        names = (["sound"] if seed in sound else []) \
            + (faults if seed in bad else [])
        try:
            found = cases(cell, seed, "cuda", names, control=seed in ctl)
        except Exception as e:   # a case that raises reads as failed
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "error": repr(e)}), flush=True)
            continue
        for case, numbers, secs in found:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "case": case, "numbers": numbers,
                              "compare_s": secs,
                              "passes_limits": check.judge(numbers,
                                                           cell.limits)}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
