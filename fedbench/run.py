"""Runs one cell of the benchmark and prints its result as the last line.

    python3 -m fedbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the kernel libraries, the inputs from ``--seed``, one
short warm-up simulation at the cell's shapes) runs first; then whole
simulations of the mix's horizon run back to back, each started while the
window has time left, and ``receives_per_s`` is every lane's client
updates over all their wall time, ended by a device synchronisation. With
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the per-layer metrics instead. Once the window has closed, the plain
reference follows the window's first simulation, stage by stage from its
own state, through the global updates the mix judges, and the comparison
decides ``correct`` (``fedbench.check``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
_CACHE = ROOT / "build" / "fedbench-cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float = T_START) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch

    from fedbench import check
    from fedbench import trace as trace_lib
    from fedbench.program import Program
    from fedbench.world import make_world, sub_seed

    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels import _build
        _build.build_all()
    mix, cfg = cell.mix, cell.cfg
    S, T = int(mix["lanes"]), int(mix["timeline_seed"])
    world = make_world(cfg, seed, device)
    prog = Program(cfg, mix, world, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prog.run(mix["warmup_horizon"],
             [sub_seed(seed, "warmup", s) for s in range(S)], T)
    keep = check.kept_receives(mix)
    sims = []
    # a traced window holds the simulations started in its first
    # ``TRACE_SECONDS`` at most, so that reading the trace stays short
    if trace:
        seconds = min(seconds, trace_lib.TRACE_SECONDS)
    prof = trace_lib.profiler(device) if trace else nullcontext()
    with prof:
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace_lib.WINDOW_SPAN):
            while not sims or time.perf_counter() - t0 < seconds:
                i = len(sims)
                ts = time.perf_counter()
                with torch.profiler.record_function("fedbench.sim"):
                    sims.append(prog.run(
                        mix["horizon"],
                        [sub_seed(seed, "sim", i, s) for s in range(S)], T,
                        keep=0 if i else keep))
                sims[-1]["seconds"] = time.perf_counter() - ts
            sync()
        t1 = time.perf_counter()
    setup_s, window_s = t0 - t_start, t1 - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    receives = sum(s["dispatches"] * s["lanes"] for s in sims)
    summary = trace_lib.summarize(prof) if trace else None
    del prof

    # the program goes before the reference runs; what is judged is the
    # first simulation's kept rows (``fedbench.check``)
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, mix, world, sims[0], device)
    correct = check.judge(numbers, cell.limits)
    for s in sims:
        s.pop("rows")

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        rec = {"cfg": cfg, "mix": mix, "sizes": world.sizes, "sims": sims,
               "receives": receives, "trace": summary}
        values = {name: read(rec) for name, read in cell.readers.items()}
    else:
        values = {"receives_per_s": receives / window_s, "setup_s": setup_s}
    metrics = {k: {"value": float(v), "unit": units[k]}
               for k, v in values.items() if v is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(receives), "failed": 0,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    # each simulation's host seconds (the last ends before the final
    # synchronisation)
    out["simulation_s"] = [s["seconds"] for s in sims]
    # the numbers compared, each beside its limit, come last
    out["checks"] = {k: {"value": float(numbers[k]), "limit": v["limit"]}
                     for k, v in cell.limits.items()}
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from fedbench.discover import load_cell
    cell = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fedbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"fedbench: the run loaded {found}; nothing of JAX or the JAX "
              f"package may run in the measured process", file=sys.stderr)
        return 3
    print(f"fedbench: {args.workload} seed {args.seed}: "
          f"{power_limit()}; device {json.dumps(out['device'])}",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"fedbench check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
