"""The device's idle time in a traced window, split by the program's spans.

    python3 -m fedbench.spans --workload <name> --seed <n> [--seconds <s>]
    python3 -m fedbench.spans --off-cost

Runs the cell as ``python3 -m fedbench.run ... --trace 1`` does and prints
that run's result line with two keys more: ``spans``, each
``repro_torch.*`` span (``repro_torch.common.trace``) with its ``count``,
``host_s`` (summed, clipped to the window) and ``idle_s``, the window's
device-idle time during which it was the innermost span open (``outside``:
none was); and ``idle_pct``, those idle times grouped by layer, in % of
the window. The groups sum to ``device_idle_pct``.

The harness's trace summary (``fedbench.trace.summarize``) keeps no spans,
so the readers ``loop_idle_pct``, ``train_idle_pct`` and
``policy_idle_pct`` call ``install`` as they are loaded: each profiler
that ``fedbench.trace.profiler`` makes then hands its trace, as it stops,
to ``window_spans`` (``on_trace_ready``), and the readers read that split
(``idle_share``). ``--off-cost`` prints instead what the instrumentation
costs the host with no profiler recording: ns per ``span`` entered and
left, and per kernel launch's ``op_cost.report``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch

from fedbench import trace as trace_lib

SPAN_PREFIX = "repro_torch."
OUTSIDE = "outside"
# each layer's spans, by the names ``span`` is given in the program
LAYERS = {"loop": ("loop", "redispatch"), "train": ("train",),
          "policy": ("sketch", "receive", "aggregate", "refresh"),
          "eval": ("eval",), "setup": ("setup",)}


def idle_gaps(busy, w0: int, w1: int) -> List[tuple]:
    """The stretches of ``[w0, w1]`` that no ``(start, end)`` of ``busy``
    covers, in order."""
    gaps, pos = [], w0
    for s, t in sorted(busy):
        if s > pos:
            gaps.append((pos, s))
        pos = max(pos, t)
    if pos < w1:
        gaps.append((pos, w1))
    return gaps


def idle_by_span(gaps, spans) -> Dict[str, dict]:
    """``{name: {count, host_s, idle_s}}`` of the spans ``(start, end,
    name)`` over the idle ``gaps`` (sorted, disjoint ``(start, end)``; all in
    nanoseconds): ``count`` the spans, ``host_s`` their summed lengths,
    ``idle_s`` the idle time during which the span was the innermost one
    open. A gap is cut at the spans' boundaries and each piece goes to the
    innermost span over it, or to ``OUTSIDE`` when none is open, so the
    ``idle_s`` sum to the gaps' total. The spans nest, as those one thread
    opens do."""
    out: Dict[str, dict] = {OUTSIDE: {"count": 0, "host_s": 0.0,
                                      "idle_s": 0.0}}
    for s, t, n in spans:
        e = out.setdefault(n, {"count": 0, "host_s": 0.0, "idle_s": 0.0})
        e["count"] += 1
        e["host_s"] += (t - s) * 1e-9
    # the stretches under some span: (start, end, the innermost one)
    pieces: list = []
    stack: list = []
    pos = None

    def advance(to):
        nonlocal pos
        while stack and stack[-1][0] <= to:
            end, name = stack.pop()
            if end > pos:
                pieces.append((pos, end, name))
                pos = end
        if stack and to > pos:
            pieces.append((pos, to, stack[-1][1]))
        pos = to if pos is None else max(pos, to)

    for s, t, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        advance(s)
        stack.append((t, n))
    if stack:
        advance(max(t for t, _ in stack))
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, n = pieces[k]
            ov = max(0, min(b, g1) - max(a, g0))
            out[n]["idle_s"] += ov * 1e-9
            covered += ov
            k += 1
        out[OUTSIDE]["idle_s"] += (g1 - g0 - covered) * 1e-9
    return out


def window_spans(prof) -> Optional[dict]:
    """``None`` when the trace holds no window span; else ``window_s``,
    ``busy_s`` (kernels and copies, as ``trace.summarize`` counts them) and
    ``spans`` (``idle_by_span``) of the window. One pass over the events,
    each host event's name and kind read once: the trace holds millions."""
    cpu = torch.autograd.DeviceType.CPU
    win, ranges, dev, spans = None, set(), [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cpu:
            dev.append((e.start_ns(), e.end_ns(), name))
            continue
        ranges.add(name)
        if name.startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name))
        elif win is None and name == trace_lib.WINDOW_SPAN:
            win = (e.start_ns(), e.end_ns())
    if win is None:
        return None
    w0, w1 = win

    def clipped(items):
        return [(max(s, w0), min(t, w1), n) for s, t, n in items
                if t > w0 and s < w1]

    # a host range is mirrored on the device's timeline: not device work
    busy = [(s, t) for s, t, n in clipped(dev) if n not in ranges]
    gaps = idle_gaps(busy, w0, w1)
    window = (w1 - w0) * 1e-9
    return {"window_s": window,
            "busy_s": window - sum(b - a for a, b in gaps) * 1e-9,
            "spans": idle_by_span(gaps, clipped(spans))}


def idle_pct(win: dict) -> Dict[str, float]:
    """The window's idle time by layer (``LAYERS``, and ``outside``), in %
    of the window."""
    sp = win["spans"]
    out = {layer: 100.0 * sum(sp.get(SPAN_PREFIX + n, {}).get("idle_s", 0.0)
                              for n in names) / win["window_s"]
           for layer, names in LAYERS.items()}
    out[OUTSIDE] = 100.0 * sp[OUTSIDE]["idle_s"] / win["window_s"]
    return out


# the split of the newest window traced since ``install`` (None: that
# trace held no window span)
_last: Optional[dict] = None


def _keep(prof) -> None:
    global _last
    _last = window_spans(prof)


def install() -> None:
    """Have each profiler that ``fedbench.trace.profiler`` makes from now on
    keep its window's split as it stops (``on_trace_ready``); once a
    process."""
    make = trace_lib.profiler
    if getattr(make, "keeps_spans", False):
        return

    def profiler(device: str):
        prof = make(device)
        prof.on_trace_ready = _keep
        return prof

    profiler.keeps_spans = True
    trace_lib.profiler = profiler


def last() -> Optional[dict]:
    """The split of the newest traced window (``window_spans``)."""
    return _last


def idle_share(rec, layer: str) -> Optional[float]:
    """``layer``'s share of the idle time (``idle_pct``) in the traced
    window of the result ``rec``; ``None`` without a trace, device work or
    the program's spans (a program that emits none)."""
    win = _last
    if rec["trace"] is None or win is None or win["busy_s"] <= 0.0:
        return None
    if not any(n.startswith(SPAN_PREFIX) for n in win["spans"]):
        return None
    return idle_pct(win)[layer]


def traced(cell, seed: int, seconds: float, device: str) -> dict:
    """``fedbench.run.run`` of ``cell`` with ``--trace 1``, its result line
    with ``spans`` and ``idle_pct`` added from the profiler it ran."""
    from fedbench import run
    install()
    out = run.run(cell, seed, seconds, True, device)
    out["spans"] = _last["spans"]
    out["idle_pct"] = idle_pct(_last)
    return out


def off_cost_ns(n: int = 1_000_000) -> Dict[str, float]:
    """ns per ``with span(...)`` and per ``op_cost.report`` call with no
    profiler recording, less an empty loop's ns an iteration; the median
    of five rounds of ``n``."""
    import statistics
    import time

    from repro_torch.common.trace import span
    from repro_torch.launch.op_cost import report

    def spans_(k):
        for _ in range(k):
            with span("train"):
                pass

    def reports(k):
        for _ in range(k):
            report("grouped_matmul", 1.0, 2.0)

    def empty(k):
        for _ in range(k):
            pass

    out = {}
    for name, fn in (("empty", empty), ("span", spans_),
                     ("report", reports)):
        times = []
        for _ in range(5):
            t = time.perf_counter_ns()
            fn(n)
            times.append((time.perf_counter_ns() - t) / n)
        out[name] = statistics.median(times)
    return {"span_ns": out["span"] - out["empty"],
            "report_ns": out["report"] - out["empty"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--off-cost", action="store_true")
    ap.add_argument("--seconds", type=float,
                    default=trace_lib.TRACE_SECONDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # as the benchmark's command: ``src/`` on the path, caches in the tree
    from fedbench import run
    if args.off_cost:
        print(json.dumps(off_cost_ns()), flush=True)
        return 0
    if args.workload is None or args.seed is None:
        ap.error("--workload and --seed are required")
    from fedbench.discover import load_cell
    cell = load_cell(run.ROOT, args.workload)
    print(json.dumps(traced(cell, args.seed, args.seconds, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    # run as ``fedbench.spans``, the module whose split the readers fill
    from fedbench.spans import main
    sys.exit(main())
