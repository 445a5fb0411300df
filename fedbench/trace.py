"""Reduces a ``torch.profiler`` trace of the window, held in memory, to
what the per-layer metrics read: each device operation's count and
seconds, the union of the device's busy intervals, and the idle gaps by
what the host was doing when they began."""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Optional

import torch

WINDOW_SPAN = "fedbench.window"
TRACE_SECONDS = 20.0
TOP = 10


def profiler(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarize(prof) -> Optional[dict]:
    """``None`` when the trace holds no window span. Otherwise
    ``window_s`` (the span's length), ``busy_s`` (the union of device
    kernels and copies inside it), ``kernels`` {name: [count, seconds]} of
    device operations inside it, ``kernel_launches`` (kernels, copies
    apart), ``device_ops`` and ``idle_gaps``: the ten largest [name,
    seconds] by operation and by the innermost host operation open when a
    gap began."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    # a host range (``record_function``) is mirrored on the device's
    # timeline as an annotation: not device work
    ranges = {e.name() for e in events if not _is_device(e)}
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if _is_device(e):
            if e.name() not in ranges:
                dev.append((max(s, w0), min(t, w1), e.name()))
        else:
            host.append((max(s, w0), min(t, w1), e.name()))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    launches = 0
    for s, t, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (t - s) * 1e-9
        launches += not _is_copy(name)
    busy_ns, gaps = 0, []
    cur_s = cur_t = None
    for s, t, _ in sorted(dev):
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy_ns += cur_t - cur_s
                gaps.append((cur_t, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_ns += cur_t - cur_s
        if cur_t < w1:
            gaps.append((cur_t, w1))
    else:
        gaps.append((w0, w1))
    by_host = _gaps_by_host(gaps, host)
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "kernel_launches": launches,
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": by_host[:TOP]}


def _gaps_by_host(gaps, host) -> List[list]:
    """Sum each gap into the name of the latest-started host operation that
    is still open at the gap's start (the window span when none is)."""
    host = sorted((s, t, n) for s, t, n in host if n != WINDOW_SPAN)
    open_: list = []
    total: Dict[str, float] = defaultdict(float)
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] <= g0:
            s, t, n = host[i]
            heapq.heappush(open_, (-s, t, n))
            i += 1
        while open_ and open_[0][1] < g0:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else WINDOW_SPAN
        total[name] += (g1 - g0) * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])]


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Summed device seconds of the operations whose name holds
    ``fragment``."""
    return float(sum(v[1] for n, v in summary["kernels"].items()
                     if fragment in n))
