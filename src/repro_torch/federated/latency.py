"""Client response-time and availability models (paper §6.2 heterogeneity).

A copy of the reference's ``repro.federated.latency``, pinned to it
stream-for-stream by the CPU tests.

Latency: Uniform(lo, hi) plus two heavy-tailed distributions over the same
support — ``longtail`` (Pareto-shaped) and ``lognormal`` (log-space normal)
— with most clients near ``lo`` and a straggler tail toward ``hi`` (the
paper notes long-tail response times cluster around the minimum).

Every sampler exposes a batched ``sample(n)`` drawing n values in ONE
vectorized call from the SAME RandomState stream a loop of scalar calls
would consume — the population-scale simulator draws a whole wave's (or the
whole initial concurrency block's) latencies at once, and the batch API is
what keeps those draws bit-identical to the historical per-dispatch scalars
(the golden digest streams depend on this).

Availability: FLGo-style intermittent clients — each dispatch succeeds with
a per-client probability; a failed dispatch still occupies its concurrency
slot for the full response time (the server only learns about the dropout
when the reply fails to arrive) and is then re-dispatched. ``SimConfig``
plumbs this through as ``availability_kind`` / ``dropout_rate``. The
``trace`` kind replaces the Bernoulli draw with a deterministic replay of a
per-client on/off ping schedule (FLGo phone-simulator style) — see
``AvailabilityTrace``.

RNG streams: one base seed fans out into decorrelated sub-streams via
``_subseed`` — stream 0 the per-client latency means, stream 1 the
per-dispatch jitter, stream 2 the availability probabilities, stream 3 the
per-dispatch availability Bernoulli draws (owned by the simulator), stream
4 the synthetic availability traces, stream 5 the synchronous fedavg round
sampling (``run_fedavg`` used to draw its per-round client choice from the
bare dispatch stream, which made the sync and async paths perturb each
other's draws at equal base seeds). Distinct streams must never share an
MT19937 state: the probabilities used to seed ad hoc as ``seed + 0x5EED``,
which collides with the latency sub-streams for adversarially chosen seeds.
"""
from __future__ import annotations

import numpy as np


def _subseed(seed: int, stream: int) -> int:
    """Derive decorrelated 32-bit sub-seeds from one base seed (multiplicative
    hashing): distinct streams must never share a MT19937 state."""
    return (int(seed) * 0x9E3779B1 + 0x85EBCA77 * (stream + 1)) % (2 ** 32)


# _subseed stream ids (see module docstring)
STREAM_MEANS = 0
STREAM_JITTER = 1
STREAM_AVAILABILITY = 2
STREAM_AVAIL_DRAWS = 3
STREAM_TRACE = 4
STREAM_SYNC_CHOICE = 5


class LatencySampler:
    """One latency distribution over [lo, hi] with a batched ``sample(n)``.

    ``sample(n)`` consumes the underlying ``RandomState`` stream exactly as
    n scalar ``sampler()`` calls would (numpy's legacy array fills loop the
    same per-value routine), so batched and per-dispatch callers interleave
    freely without perturbing each other's draws.
    """

    def __init__(self, kind: str, lo: float, hi: float, seed: int = 0):
        if kind not in ("uniform", "longtail", "lognormal"):
            raise ValueError(f"unknown latency kind {kind!r}")
        self.kind = kind
        self.lo, self.hi = float(lo), float(hi)
        self.rng = np.random.RandomState(seed)

    def sample(self, n: int) -> np.ndarray:
        """Draw ``n`` latencies as one vectorized call; (n,) float64."""
        lo, hi = self.lo, self.hi
        if self.kind == "uniform":
            return self.rng.uniform(lo, hi, size=n)
        if self.kind == "longtail":
            # Pareto-shaped: mass near lo, tail to hi
            x = np.power(1.0 - self.rng.rand(n), -1.0 / 1.5) - 1.0
            return np.clip(lo * (1.0 + x), lo, hi)
        # lognormal — heavy-tail in log space: median at the lower quartile
        # of the log-range, sigma a quarter of the log-range; most clients
        # sit near ``lo`` with a long straggler tail toward ``hi`` (clipped
        # to the support, like the other kinds).
        span = np.log(hi / lo)
        mu = np.log(lo) + 0.25 * span
        sigma = 0.25 * span
        return np.clip(np.exp(self.rng.normal(mu, sigma, size=n)), lo, hi)

    def __call__(self) -> float:
        return float(self.sample(1)[0])


def make_latency_sampler(kind: str, lo: float, hi: float,
                         seed: int = 0) -> LatencySampler:
    return LatencySampler(kind, lo, hi, seed)


class PerClientLatency:
    """Fixed mean latency per client + per-dispatch jitter, as in FLGO:
    heterogeneity lives across clients, not only across dispatches.

    The per-client means and the per-dispatch jitter draw from DISTINCT
    sub-seeded RNG streams (they used to share ``RandomState(seed)``, which
    correlated the means with the first jitter draws). The means are one
    batched ``sample(num_clients)`` draw — bit-identical to the historical
    python loop of scalar calls, and O(1) python cost at C=10^6. The jitter
    stream is exposed as ``self.rng`` so the simulator can snapshot/restore
    it across checkpoints; ``sample_for(cids)`` draws a whole wave's
    jittered latencies from it in one call.
    """

    def __init__(self, kind: str, lo: float, hi: float, num_clients: int,
                 seed: int = 0):
        sampler = make_latency_sampler(kind, lo, hi,
                                       _subseed(seed, STREAM_MEANS))
        self.means = sampler.sample(num_clients)
        self.lo, self.hi = lo, hi
        self.rng = np.random.RandomState(_subseed(seed, STREAM_JITTER))

    def sample_for(self, client_ids) -> np.ndarray:
        """Jittered response times for a batch of dispatches, one vectorized
        draw; consumes the jitter stream exactly as len(client_ids) scalar
        calls would."""
        cids = np.asarray(client_ids, np.int64)
        jitter = self.rng.uniform(0.9, 1.1, size=cids.shape[0])
        return np.clip(self.means[cids] * jitter, self.lo, self.hi)

    def __call__(self, client_id: int) -> float:
        return float(self.sample_for([client_id])[0])


def per_client_latency(kind: str, lo: float, hi: float, num_clients: int,
                       seed: int = 0):
    """Build the per-client latency process; returns (sampler, means) where
    ``sampler(client_id)`` draws one jittered response time,
    ``sampler.sample_for(cids)`` a batch (and carries its RNG as
    ``sampler.rng`` — see ``PerClientLatency``)."""
    lat = PerClientLatency(kind, lo, hi, num_clients, seed)
    return lat, lat.means


AVAILABILITY_KINDS = ("always", "uniform", "hetero", "slow-fragile", "trace")


def per_client_availability(kind: str, dropout_rate: float, num_clients: int,
                            seed: int = 0,
                            latency_means=None) -> np.ndarray:
    """Per-client probability that a dispatch completes successfully.

    ``always``        every dispatch succeeds (dropout disabled)
    ``uniform``       every client succeeds w.p. 1 - dropout_rate
    ``hetero``        per-client Beta-distributed success probs with mean
                      1 - dropout_rate — some clients are chronically flaky
                      (FLGo's intermittently-available population)
    ``slow-fragile``  dropout concentrated on the slowest clients (success
                      prob decays with the client's mean latency) — couples
                      system heterogeneity to availability, the adversarial
                      case for staleness policies
    ``trace``         handled by ``AvailabilityTrace`` (deterministic on/off
                      schedule replay); this helper returns all-ones since
                      no Bernoulli probabilities are drawn for it
    """
    if kind in ("always", "trace") or dropout_rate <= 0.0:
        return np.ones(num_clients)
    if not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in (0, 1), got {dropout_rate}")
    rng = np.random.RandomState(_subseed(seed, STREAM_AVAILABILITY))
    if kind == "uniform":
        return np.full(num_clients, 1.0 - dropout_rate)
    if kind == "hetero":
        # Beta(a, b) with mean 1-rate and fixed concentration a+b=8
        conc = 8.0
        a = conc * (1.0 - dropout_rate)
        return rng.beta(a, conc - a, size=num_clients)
    if kind == "slow-fragile":
        if latency_means is None:
            raise ValueError("slow-fragile availability needs latency_means")
        m = np.asarray(latency_means, np.float64)
        rank = (m - m.min()) / max(m.max() - m.min(), 1e-12)
        # fastest client ~always available; slowest drops at 2x the mean rate
        p = 1.0 - dropout_rate * 2.0 * rank
        return np.clip(p, 0.05, 1.0)
    raise ValueError(f"unknown availability kind {kind!r}; "
                     f"known: {AVAILABILITY_KINDS}")


class AvailabilityTrace:
    """Per-client on/off ping schedules, replayed deterministically.

    FLGo's phone simulator replays real mobile-usage pings: a client is
    reachable only inside its recorded on-intervals. This is the synthetic
    equivalent: each client holds a sorted array of toggle times — the
    client starts in ``start_on[c]`` state at t=0 and flips state at every
    toggle — and a dispatch at virtual time ``t`` succeeds iff the client is
    on at ``t``. Replay is pure lookup (``searchsorted`` into the client's
    toggle run), so availability consumes NO RNG stream at dispatch time:
    trace runs share the exact client-sampling and latency streams of a
    dropout-free run.

    Storage is one concatenated toggle array with per-client offsets, so a
    trace over C clients costs O(total toggles), not O(C x horizon).
    """

    def __init__(self, toggles: np.ndarray, offsets: np.ndarray,
                 start_on: np.ndarray):
        self.toggles = np.asarray(toggles, np.float64)
        self.offsets = np.asarray(offsets, np.int64)      # (C + 1,)
        self.start_on = np.asarray(start_on, bool)        # (C,)
        assert self.offsets.shape[0] == self.start_on.shape[0] + 1
        assert self.offsets[-1] == self.toggles.shape[0]

    @property
    def num_clients(self) -> int:
        return self.start_on.shape[0]

    def on_at(self, client_ids, ts) -> np.ndarray:
        """(B,) bool: is each client on at its dispatch time? Vectorized
        over the batch; each lookup counts the client's toggles before t
        (an odd count flips the start state)."""
        cids = np.asarray(client_ids, np.int64)
        ts = np.asarray(ts, np.float64)
        lo = self.offsets[cids]
        hi = self.offsets[cids + 1]
        # one searchsorted over the concatenated runs: biasing each query
        # by its client's window keeps the lookup inside that client's run
        flips = np.empty(cids.shape[0], np.int64)
        for i in range(cids.shape[0]):
            flips[i] = np.searchsorted(self.toggles[lo[i]:hi[i]], ts[i],
                                       side="right")
        return self.start_on[cids] ^ (flips % 2 == 1)

    def on_fraction(self, horizon: float) -> np.ndarray:
        """(C,) per-client fraction of [0, horizon] spent on (for tests)."""
        out = np.empty(self.num_clients)
        for c in range(self.num_clients):
            tg = self.toggles[self.offsets[c]:self.offsets[c + 1]]
            edges = np.concatenate([[0.0], np.clip(tg, 0.0, horizon),
                                    [horizon]])
            spans = np.diff(edges)
            state = self.start_on[c]
            on = 0.0
            for s in spans:
                if state:
                    on += s
                state = not state
            out[c] = on / horizon
        return out


def make_availability_trace(num_clients: int, horizon: float,
                            off_fraction: float, seed: int = 0, *,
                            mean_session: float = 0.0) -> AvailabilityTrace:
    """Synthetic trace generator: alternating exponential on/off sessions.

    Each client alternates on-sessions (mean ``mean_session``) and
    off-sessions (scaled so the long-run off fraction is ``off_fraction``),
    with its own phase — the FLGo-phone-style intermittent population
    without needing real usage logs. ``mean_session`` defaults to
    ``horizon / 20`` so a default trace toggles ~tens of times per run.
    Deterministic in (num_clients, horizon, off_fraction, seed).
    """
    if not 0.0 <= off_fraction < 1.0:
        raise ValueError(f"off_fraction must be in [0, 1), got {off_fraction}")
    rng = np.random.RandomState(_subseed(seed, STREAM_TRACE))
    mean_on = mean_session or horizon / 20.0
    mean_off = (mean_on * off_fraction / (1.0 - off_fraction)
                if off_fraction > 0.0 else 0.0)
    runs, offsets, start_on = [], [0], np.empty(num_clients, bool)
    total = 0
    for c in range(num_clients):
        start_on[c] = bool(rng.rand() >= off_fraction)
        if off_fraction <= 0.0:
            offsets.append(total)
            continue
        t, toggles, on = 0.0, [], bool(start_on[c])
        while t < horizon:
            t += rng.exponential(mean_on if on else mean_off)
            if t >= horizon:
                break
            toggles.append(t)
            on = not on
        runs.append(np.asarray(toggles))
        total += len(toggles)
        offsets.append(total)
    toggles = (np.concatenate(runs) if runs else np.zeros(0))
    return AvailabilityTrace(toggles, np.asarray(offsets, np.int64), start_on)
