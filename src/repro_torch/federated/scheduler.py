"""Pluggable dispatch schedulers: WHO to dispatch and WHEN a slot relaunches.

A copy of the reference's ``repro.federated.scheduler``, pinned to it
stream-for-stream by the CPU tests, with its checkpoint round trip
(``checkpointable``, ``state_arrays``).

Historically the dispatch rule — "sample a client uniformly, relaunch the
freed concurrency slot immediately" — was inlined twice, as twin
``dispatch``/``dispatch_many`` closures in ``run_async`` and ``run_sweep``.
This module extracts that copy into ONE shared layer, and makes the rule a
first-class research axis (the ROADMAP's scheduler/staleness-metric
surface):

``Scheduler``
    owns *client selection* (``select``) and *refill timing*
    (``launch_times``). Everything else about a dispatch — latency draw,
    availability draw, snapshot/version capture, timeline insertion —
    stays in ``Dispatcher`` and is scheduler-independent.

``UniformRefillScheduler``  (default, ``SimConfig.scheduler="uniform"``)
    the historical rule, bit-for-bit: ``rng.randint(num_clients, size=n)``
    on the bare ``RandomState(timeline_seed)`` dispatch stream with slots
    relaunching at the instant they free. Every golden digest stream under
    ``tests/golden/`` is pinned to this scheduler.

``PeriodTriggeredScheduler``  (``"period"``)
    FLGo fedasync-style period-triggered sampling: freed slots wait for
    the next wall-clock tick (``ceil(t / period) * period``) before
    relaunching, so dispatches leave the server in synchronized bursts.
    Selection stays uniform on the same dispatch stream.

``StalenessAwareScheduler``  (``"staleness"``)
    CSMAAFL-style utility/staleness-weighted selection: client c is drawn
    with probability proportional to

        (1 + version_lag_c)^staleness_weight
        * (data_size_c / mean_size)^size_weight
        * availability_c^avail_weight

    where ``version_lag_c`` is the server-version gap since c was last
    dispatched — preferring clients whose contribution is most stale
    (participation freshness), larger (utility), and likely to arrive
    (availability state from ``latency.per_client_availability``).
    Selection is sequential per dispatch (each draw updates the lag
    table). The default sampler is SUBLINEAR in C per draw (rejection
    sampling against the static base-utility cumsum — see the class
    docstring), which is what makes staleness-aware selection usable on
    the population-scale streaming path at C=10^5-10^6;
    ``scheduler_params={"exact": True}`` keeps the historical O(C)
    full-recompute loop as the exact-distribution oracle.

RNG-stream contract (see ``latency._subseed``): a scheduler may draw ONLY
from the dispatch stream handed to ``bind`` — the bare
``RandomState(timeline_seed)`` that historically produced the uniform cid
draws. Latency jitter, availability Bernoullis, and the synchronous-fedavg
round sampling live on their own sub-streams and are never the
scheduler's to consume.

Wave-safety contract: ``launch_times(ts) >= ts`` elementwise. The cohort
drain trains a wave up front on the premise that any replacement dispatch
completes no earlier than ``t_first + latency_lo``; deferring a launch
keeps that bound, advancing one would break re-dispatch safety.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.federated.latency import (STREAM_AVAIL_DRAWS, _subseed,
                                     make_availability_trace,
                                     per_client_availability,
                                     per_client_latency)

SCHEDULERS = ("uniform", "period", "staleness")


@dataclass
class SimStreams:
    """The host-side randomness of one simulation run, built once by
    ``make_streams`` (previously triplicated across ``run_async`` /
    ``run_sweep`` / ``run_fedavg``).

    ``rng`` is THE dispatch stream — the bare ``RandomState(tseed)`` that
    client selection draws from (handed to the scheduler at bind time).
    ``latency`` carries its own jitter stream (``latency.rng``); the
    availability Bernoulli draws live on ``avail_rng`` (stream
    ``STREAM_AVAIL_DRAWS``) so batched cid draws never reorder them. The
    ``trace`` kind replays a deterministic schedule and consumes no RNG.
    """
    tseed: int
    rng: np.random.RandomState
    latency: object                  # latency.PerClientLatency
    lat_means: np.ndarray
    avail: np.ndarray                # (C,) per-client success probabilities
    avail_rng: np.random.RandomState
    trace: Optional[object]          # latency.AvailabilityTrace
    use_trace: bool
    use_avail: bool


def make_streams(sim) -> SimStreams:
    """Build every host RNG stream of a run from ``SimConfig`` — one
    implementation for all three entry points, preserving the historical
    stream layout exactly."""
    tseed = sim.seed if sim.timeline_seed is None else sim.timeline_seed
    latency, lat_means = per_client_latency(
        sim.latency_kind, sim.latency_lo, sim.latency_hi, sim.num_clients,
        tseed)
    avail = per_client_availability(sim.availability_kind, sim.dropout_rate,
                                    sim.num_clients, tseed,
                                    latency_means=lat_means)
    use_trace = sim.availability_kind == "trace" and sim.dropout_rate > 0.0
    trace = (make_availability_trace(sim.num_clients, sim.horizon,
                                     sim.dropout_rate, tseed)
             if use_trace else None)
    use_avail = (sim.availability_kind not in ("always", "trace")
                 and sim.dropout_rate > 0.0)
    return SimStreams(
        tseed=tseed, rng=np.random.RandomState(tseed),
        latency=latency, lat_means=lat_means, avail=avail,
        avail_rng=np.random.RandomState(_subseed(tseed, STREAM_AVAIL_DRAWS)),
        trace=trace, use_trace=use_trace, use_avail=use_avail)


class Scheduler:
    """The dispatch-policy protocol (see module docstring for the contract).

    Lifecycle: ``bind`` is called once per run with the run's dispatch RNG
    stream and the scheduler-visible client state; then, per dispatch batch,
    ``launch_times`` maps slot-freed times to launch times (pure, no RNG)
    and ``select`` draws one client per launch (the only RNG consumer).

    ``checkpointable`` says whether a simulator checkpoint can hold the
    scheduler: true when its only mutable state is the bound RNG (which
    checkpoints already persist), or when ``state_arrays`` /
    ``load_state_arrays`` round-trip the rest (the staleness scheduler's
    lag table). Checkpointed runs refuse the others up front. (The
    reference spells this as two flags, ``stateless`` and
    ``checkpoint_state``; checkpointable = stateless or checkpoint_state.)
    """

    name = "scheduler"
    checkpointable = True

    def bind(self, *, num_clients: int, rng: np.random.RandomState,
             latency_means=None, avail_probs=None, data_sizes=None) -> None:
        self.num_clients = int(num_clients)
        self.rng = rng
        self.latency_means = latency_means
        self.avail_probs = avail_probs
        self.data_sizes = data_sizes

    def launch_times(self, ts) -> np.ndarray:
        """When each freed slot actually relaunches; must be >= ts."""
        return np.asarray(ts, np.float64)

    def select(self, ts: np.ndarray, versions: np.ndarray) -> np.ndarray:
        """(n,) client ids for launches at ``ts`` with the given
        version-at-dispatch per slot. The ONLY method that may draw RNG."""
        raise NotImplementedError

    def state_arrays(self) -> dict:
        """The scheduler's incremental host state as name -> numpy array,
        persisted by simulator checkpoints (nothing when there is none).
        Stateless schedulers have nothing to persist."""
        return {}

    def load_state_arrays(self, arrays: dict) -> None:
        """Restore ``state_arrays`` output into a bound scheduler."""
        if arrays:
            raise NotImplementedError(
                f"scheduler {self.name!r} does not restore state")


class UniformRefillScheduler(Scheduler):
    """The historical inline rule: uniform client sampling, immediate
    refill. ``select`` consumes the MT19937 dispatch stream bit-for-bit as
    the pre-refactor ``rng.randint(num_clients, size=n)`` (numpy's legacy
    array fill equals n scalar calls), so golden digests are unchanged."""

    name = "uniform"

    def select(self, ts, versions):
        return self.rng.randint(self.num_clients, size=len(ts))


class PeriodTriggeredScheduler(UniformRefillScheduler):
    """FLGo fedasync-style period-triggered sampling: a freed slot waits
    for the next wall-clock tick before relaunching (FLGo's ``iterate``
    samples only when ``current_time % period == 0``). Selection stays
    uniform on the same stream.

    The initial concurrency fill at t=0 lands on a tick by construction
    (``ceil(0/p)*p == 0``). Snapshot/version are still captured when the
    slot frees — the period defers only the launch instant, which also
    keeps wave safety: ``tick + latency >= t + latency_lo``."""

    name = "period"

    def __init__(self, period: float = 20.0):
        if not period > 0.0:
            raise ValueError(f"period must be > 0, got {period}")
        self.period = float(period)

    def launch_times(self, ts):
        ts = np.asarray(ts, np.float64)
        return np.ceil(ts / self.period) * self.period


class StalenessAwareScheduler(Scheduler):
    """CSMAAFL-style utility/staleness-weighted client selection (see the
    module docstring for the weight law). Holds a per-client table of the
    server version at last dispatch; each draw updates it, so selection is
    a sequential per-dispatch loop — identical RNG consumption whether
    called with a batch or one slot at a time (the cohort flush and the
    sequential oracle stay stream-identical).

    Two samplers draw from the SAME distribution:

    ``exact=True`` — the historical oracle: rebuild the full C-length
    weight vector and ``rng.choice(p=...)`` per draw, O(C). Fine at paper
    scale, a hot-path blocker on the streaming path at C=10^5-10^6.

    ``exact=False`` (default) — sublinear rejection sampling. The weight
    factors as ``base_c * (1 + lag_c)^w`` where ``base_c`` (size x
    availability) is STATIC after ``bind`` and ``lag_c = v - lv_c`` with
    ``lv_c`` the version at c's last dispatch. Proposals come from the
    static base cumsum (one ``searchsorted``, O(log C)); since versions
    only advance, ``lv_floor <= min_c lv_c`` gives the envelope
    ``base_c * (1 + v - lv_floor)^w >= weight_c``, so accepting a proposal
    with probability ``((1 + lag_c) / (1 + v - lv_floor))^w`` is EXACT.
    Per draw: O(log C) expected — untouched clients (the overwhelming mass
    at population scale) accept at rate ~1, only the O(launched) touched
    clients reject. Pathological states (every client recently dispatched,
    stale floor) self-heal: after ``_REJECT_REFRESH`` rejections the floor
    is recomputed (amortized — only then is an O(C) ``min`` paid), and
    after ``_REJECT_EXACT`` rejections the draw falls back to one exact
    O(C) recompute, still the exact distribution. The fast and exact
    samplers consume the dispatch stream differently (both are valid
    consumptions under the RNG contract); batch == scalar holds for each.
    """

    name = "staleness"
    checkpointable = True   # its lag table round-trips via state_arrays

    _REJECT_REFRESH = 16    # rejections before recomputing the lag floor
    _REJECT_EXACT = 64      # rejections before one exact O(C) fallback

    def __init__(self, staleness_weight: float = 1.0,
                 size_weight: float = 1.0, avail_weight: float = 1.0,
                 exact: bool = False):
        if staleness_weight < 0.0:
            raise ValueError("staleness_weight must be >= 0")
        self.staleness_weight = float(staleness_weight)
        self.size_weight = float(size_weight)
        self.avail_weight = float(avail_weight)
        self.exact = bool(exact)

    def bind(self, **kw):
        super().bind(**kw)
        self.last_version = np.zeros(self.num_clients, np.float64)
        base = np.ones(self.num_clients, np.float64)
        if self.size_weight != 0.0 and self.data_sizes is not None:
            sizes = np.asarray(self.data_sizes, np.float64)
            base = base * np.power(
                np.maximum(sizes / max(sizes.mean(), 1e-12), 1e-6),
                self.size_weight)
        if self.avail_weight != 0.0 and self.avail_probs is not None:
            base = base * np.power(
                np.clip(np.asarray(self.avail_probs, np.float64), 1e-6, 1.0),
                self.avail_weight)
        self._base = base
        # fast-path proposal structure: cumsum over the STATIC base utility
        # (never updated — lag lives outside it, in last_version)
        self._cum = np.cumsum(base)
        self._total = float(self._cum[-1])
        self._lv_floor = 0.0
        self.sample_stats = {"draws": 0, "proposals": 0,
                             "floor_refreshes": 0, "exact_fallbacks": 0}

    # -- checkpoint round-trip ----------------------------------------------

    def state_arrays(self) -> dict:
        return {"last_version": np.asarray(self.last_version, np.float64),
                "lv_floor": np.asarray([self._lv_floor], np.float64)}

    def load_state_arrays(self, arrays: dict) -> None:
        self.last_version[:] = np.asarray(arrays["last_version"], np.float64)
        self._lv_floor = float(np.asarray(arrays["lv_floor"]).ravel()[0])

    # -- samplers ------------------------------------------------------------

    def _exact_draw(self, v: float) -> int:
        lag = np.maximum(v - self.last_version, 0.0)
        w = self._base * np.power(1.0 + lag, self.staleness_weight)
        return int(self.rng.choice(self.num_clients, p=w / w.sum()))

    def _refresh_floor(self) -> None:
        self.sample_stats["floor_refreshes"] += 1
        self._lv_floor = float(self.last_version.min())

    def _fast_draw(self, v: float) -> int:
        sw = self.staleness_weight
        st = self.sample_stats
        st["draws"] += 1
        env = (1.0 + max(v - self._lv_floor, 0.0)) ** sw
        rejects = 0
        while True:
            st["proposals"] += 1
            u = self.rng.random_sample() * self._total
            c = min(int(np.searchsorted(self._cum, u, side="right")),
                    self.num_clients - 1)
            a = self.rng.random_sample()
            lag = max(v - self.last_version[c], 0.0)
            p = (1.0 + lag) ** sw / env
            if p > 1.0:
                # the floor drifted above the true min (state was mutated
                # externally): re-derive it so the envelope dominates again,
                # then re-test the SAME proposal under the valid envelope
                self._refresh_floor()
                env = (1.0 + max(v - self._lv_floor, 0.0)) ** sw
                p = (1.0 + lag) ** sw / env
            if a < p:
                return c
            rejects += 1
            if rejects == self._REJECT_REFRESH:
                self._refresh_floor()
                env = (1.0 + max(v - self._lv_floor, 0.0)) ** sw
            elif rejects >= self._REJECT_EXACT:
                st["exact_fallbacks"] += 1
                return self._exact_draw(v)

    def select(self, ts, versions):
        versions = np.asarray(versions, np.float64)
        draw = self._exact_draw if self.exact else self._fast_draw
        out = np.empty(len(ts), np.int64)
        for i in range(len(ts)):
            c = draw(versions[i])
            self.last_version[c] = versions[i]
            out[i] = c
        return out


def make_scheduler(sim) -> Scheduler:
    """Build the scheduler named by ``SimConfig.scheduler`` with
    ``SimConfig.scheduler_params`` keyword overrides. The period default
    scales with the latency floor (FLGo's period=20 at latency_lo=10)."""
    params = dict(sim.scheduler_params or {})
    if sim.scheduler == "uniform":
        return UniformRefillScheduler(**params)
    if sim.scheduler == "period":
        params.setdefault("period", max(2.0 * sim.latency_lo, 1.0))
        return PeriodTriggeredScheduler(**params)
    if sim.scheduler == "staleness":
        return StalenessAwareScheduler(**params)
    raise ValueError(f"unknown scheduler {sim.scheduler!r}; "
                     f"known: {SCHEDULERS}")


class Dispatcher:
    """The ONE dispatch path shared by ``run_async`` and ``run_sweep``
    (previously twin inline closures that had already begun to diverge).

    Issues a batch of dispatches as one presorted timeline run: the
    scheduler picks launch times and clients, then latency / availability /
    snapshot / version capture happen here, in the exact historical stream
    order (cids, then latencies, then availability Bernoullis). Stream-
    identical to n scalar dispatches — numpy's legacy array fills consume
    the MT state exactly as n scalar calls, and cid/jitter/ok live on
    separate streams so batching one does not reorder another.
    """

    def __init__(self, sim, streams: SimStreams, scheduler: Scheduler,
                 timeline, server, result, *, batched: bool,
                 data_sizes=None):
        self.sim, self.streams, self.scheduler = sim, streams, scheduler
        self.timeline, self.server, self.result = timeline, server, result
        self.batched = batched
        self.seq = 0
        scheduler.bind(num_clients=sim.num_clients, rng=streams.rng,
                       latency_means=streams.lat_means,
                       avail_probs=streams.avail, data_sizes=data_sizes)

    def dispatch_many(self, ts, snaps=None, versions=None) -> None:
        st = self.streams
        n = len(ts)
        ts = self.scheduler.launch_times(ts)
        if versions is None:
            versions = np.full(n, self.server.version, np.int64)
        else:
            versions = np.asarray(versions, np.int64)
        cids = self.scheduler.select(ts, versions)
        t_done = ts + st.latency.sample_for(cids)
        if st.use_trace:
            oks = st.trace.on_at(cids, ts)
        elif st.use_avail:
            oks = st.avail_rng.rand(n) < st.avail[cids]
        else:
            oks = np.ones(n, bool)
        if snaps is None:
            # (d,) flat vector (cohort), (S, d) lane stack (sweep), or the
            # params pytree (sequential oracle) — shared by the whole batch
            cur = self.server.flat_params if self.batched else self.server.params
            snaps = [cur] * n
        self.timeline.extend_arrays(t_done, np.arange(self.seq, self.seq + n),
                                    cids, versions, oks, snaps)
        self.seq += n
        self.result.launched += n

    def dispatch(self, t: float, snap=None, version=None) -> None:
        self.dispatch_many([t], None if snap is None else [snap],
                           None if version is None else [version])
