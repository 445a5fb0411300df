"""Run-merged event timeline: the simulator's event queue.

A copy of the reference's ``repro.federated.timeline`` (the cohort
engine's ``peek_wave_cids`` and the checkpoint helpers ``events``/``clear``
arrive with those ports), pinned to it by the CPU tests.

The legacy timeline was a ``heapq`` of ``_Event`` tuples — one python push
per dispatch, one pop per completion. At C=10^5-10^6 with thousands of
in-flight dispatches the per-event python cost dominates the run. This
module replaces the heap with a *k-way run merge*: a batched dispatch (one
wave's replacements, or the whole initial concurrency block) inserts ONE
presorted run of numpy arrays, and ``pop()`` merges run heads through a
small heap whose size is the number of live runs (~ in-flight / wave size),
not the number of in-flight events.

Ordering is identical to the legacy heap: events sort by ``(t_done, seq)``
and ``seq`` is unique, so the merge is a total order and the simulator's
wave boundaries, RNG consumption and receive order are unchanged.
``extend_arrays`` is the single insertion choke point — scalar ``push``
delegates to it — which is also what the event-spy tests hook.
"""
from __future__ import annotations

import heapq
from typing import List, NamedTuple, Optional

import numpy as np


class _Event(NamedTuple):
    """One in-flight dispatch. ``snapshot`` is the global model captured at
    dispatch time — a flat (d,) vector or a ``(source, row)`` reference into
    a batched-ingest snapshot sequence (cohort engine), or the params pytree
    (sequential engine); ``ok`` is the availability draw — False means the
    client never reports back and the slot re-dispatches at ``t_done``."""
    t_done: float
    seq: int
    cid: int
    snapshot: object
    version: int
    ok: bool


class _Run:
    """One presorted batch of events (column arrays + snapshot refs)."""
    __slots__ = ("t", "seq", "cid", "version", "ok", "snaps")

    def __init__(self, t, seq, cid, version, ok, snaps):
        self.t, self.seq, self.cid = t, seq, cid
        self.version, self.ok, self.snaps = version, ok, snaps


class Timeline:
    """Min-ordered event queue over ``(t_done, seq)`` with batch insertion.

    ``_heap`` holds ``(t_head, seq_head, run, i)`` cursors, one per
    non-exhausted run; ``(t, seq)`` pairs are unique so tuple comparison
    never reaches the run object. Scalar pushes create single-event runs —
    the sequential engine's timeline degenerates to the legacy heap with
    identical complexity.
    """

    def __init__(self):
        self._heap: List[tuple] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def head_t(self) -> Optional[float]:
        """The next event's ``t_done`` (None when empty) — the wave-boundary
        probe, replacing ``heap[0].t_done``."""
        return float(self._heap[0][0]) if self._heap else None

    def extend_arrays(self, t_done, seqs, cids, versions, oks,
                      snapshots) -> None:
        """Insert one batch of events. Array-likes of equal length n plus a
        length-n list of snapshot refs; sorted here by ``(t_done, seq)`` so
        callers pass dispatch order. THE insertion choke point: every event
        — batched or scalar — enters the timeline through this call."""
        t = np.asarray(t_done, np.float64)
        seqs = np.asarray(seqs, np.int64)
        n = t.shape[0]
        if n == 0:
            return
        cids = np.asarray(cids, np.int64)
        versions = np.asarray(versions, np.int64)
        oks = np.asarray(oks, bool)
        assert len(snapshots) == n
        order = np.lexsort((seqs, t))
        if not np.array_equal(order, np.arange(n)):
            t, seqs, cids = t[order], seqs[order], cids[order]
            versions, oks = versions[order], oks[order]
            snapshots = [snapshots[i] for i in order]
        run = _Run(t, seqs, cids, versions, oks, list(snapshots))
        heapq.heappush(self._heap, (t[0], seqs[0], run, 0))
        self._n += n

    def push(self, ev: _Event) -> None:
        self.extend_arrays([ev.t_done], [ev.seq], [ev.cid], [ev.version],
                           [ev.ok], [ev.snapshot])

    def pop(self) -> _Event:
        t, s, run, i = heapq.heappop(self._heap)
        ev = _Event(float(t), int(s), int(run.cid[i]), run.snaps[i],
                    int(run.version[i]), bool(run.ok[i]))
        run.snaps[i] = None            # release the snapshot ref promptly
        j = i + 1
        if j < run.seq.shape[0]:
            heapq.heappush(self._heap, (run.t[j], run.seq[j], run, j))
        self._n -= 1
        return ev
