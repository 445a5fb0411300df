"""Staleness-policy core of the port: every async server is one step.

A ``Policy`` has an ``init(params, hyper)`` building a ``ServerState``
(flat contiguous f32 parameter vector, fixed-size stacked ring buffers)
and a ``step(state, arrival) -> (state, updated, log_entry)``. As in the
reference (``repro.federated.policies``), hyperparameters live in
``ServerState.hyper``; here they are host floats, and the "buffer full"
branch the reference takes under ``lax.cond`` is a host ``int``
comparison. The global vector is never written in place: an applied
update produces a fresh tensor (``buffer_agg`` writes a new output), so a
dispatch snapshot taken at an earlier version stays as it was. The rings
and the CA2FL cache are server-private and are written in place.

A receive costs no device sync: fill counts, versions and the CA2FL
count of clients seen are host ``int``s, and a coefficient computed from
device norms (asyncfeded's) stays a 0-d device tensor, in the step and in
the log entry, until ``PolicyServer.host_log`` reads the log.

All seven policies of the reference: fedasync, fedbuff, fedpsa, ca2fl,
fedfa, fedpac and asyncfeded (metrics l2, cosine and sketch).

``state_arrays``/``load_state_arrays`` turn a ``ServerState`` into named
host arrays and back (simulator checkpoints).

A step reads the width of the flat vector from the state, never from the
spec, so the same steps run on one shard of the mesh-sharded server
(``servers.ShardedPolicyServer``), whose d-sized tensors hold a slice of
the (padded) flat axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.tree import FlatSpec, ring_update
from repro_torch.core import aggregation, psa as psa_lib
from repro_torch.kernels.sens_sketch import KS


class PolicyParams(NamedTuple):
    """Timeline-preserving hyperparameters (host values), one record for
    every policy, with the reference's fields and defaults; a policy reads
    the fields it uses."""
    alpha: float = 0.6            # fedasync / asyncfeded mixing
    a: float = 0.5                # staleness polynomial exponent
    server_lr: float = 1.0        # buffered-apply learning rate
    beta: float = 0.5             # fedfa recency decay
    gamma: float = 5.0            # fedpsa temperature slope
    delta: float = 0.5            # fedpsa temperature floor
    eps: float = 1e-8             # asyncfeded distance epsilon
    use_thermometer: bool = True  # fedpsa w/o-T ablation switch
    dist_mode: float = psa_lib.DIST_MODE_L2  # asyncfeded metric (0=l2, 1=cosine)


HYPER_FIELDS = PolicyParams._fields

# Metric names accepted for ``dist_mode`` (the arithmetic variants);
# "sketch" is a structural choice: ``asyncfeded_policy(metric="sketch")``.
_DIST_MODE_CODES = {"l2": psa_lib.DIST_MODE_L2,
                    "cosine": psa_lib.DIST_MODE_COSINE}


def make_hyper(**kw) -> PolicyParams:
    """``PolicyParams`` from keyword overrides over the defaults. Raises on
    unknown keys; ``dist_mode`` also accepts the metric names "l2" and
    "cosine". The messages are the reference's."""
    bad = sorted(set(kw) - set(HYPER_FIELDS))
    if bad:
        raise ValueError(
            f"unknown policy hyperparameter(s) {bad}; per-lane tunables are "
            f"{sorted(HYPER_FIELDS)} (shape parameters like buffer_size/"
            f"queue_len/sketch_k are static and must be shared)")
    if isinstance(kw.get("dist_mode"), str):
        try:
            kw["dist_mode"] = _DIST_MODE_CODES[kw["dist_mode"]]
        except KeyError:
            raise ValueError(
                f"dist_mode {kw['dist_mode']!r} is not a traced metric; "
                f"traced: {sorted(_DIST_MODE_CODES)} ('sketch' alters the "
                f"program — request it via asyncfeded_policy(metric="
                f"'sketch'))") from None
    return PolicyParams(**kw)


@dataclasses.dataclass
class RingState:
    """Fixed-size stacked ring buffer over the flat parameter layout."""
    data: torch.Tensor   # (L, d) f32, written in place (server-private)
    count: int           # fill level since the last flush


@dataclasses.dataclass
class CacheState:
    """CA2FL per-client cached deltas h_i plus their running sum."""
    data: torch.Tensor   # (num_clients, d) f32, written in place
    valid: np.ndarray    # (num_clients,) host bool: client seen at least once
    total: torch.Tensor  # (d,) f32 running sum of cached deltas, in place

    @property
    def n_cached(self) -> int:
        return int(self.valid.sum())


@dataclasses.dataclass
class ServerState:
    """One state for every policy; unused sub-states are None."""
    params: torch.Tensor                     # (d,) flat f32 global model
    version: int                             # completed global updates
    ring: Optional[RingState] = None
    psa: Optional[psa_lib.PSAState] = None
    cache: Optional[CacheState] = None
    hyper: PolicyParams = PolicyParams()


class Arrival(NamedTuple):
    """One client completion as the server sees it. ``update`` and
    ``client_params`` are parameter trees; ``tau`` is the host version
    gap at ingest."""
    update: Any
    client_params: Any
    tau: int
    client_id: int
    data_size: float
    sketch: Optional[torch.Tensor]   # (k,) behavioral sketch (fedpsa)


@dataclasses.dataclass(frozen=True)
class Policy:
    """``hyper`` holds the factory-call hyperparameters: a standalone
    server inits with them, a sweep lane with its overrides merged over
    them (``servers.make_lane_server``)."""
    name: str
    init: Callable[[Any, PolicyParams], ServerState]
    step: Callable[[ServerState, Arrival], tuple]   # -> (state, updated, log)
    spec: FlatSpec
    hyper: PolicyParams = PolicyParams()
    sketch_k: int = 0
    needs_sketch: bool = False
    client_align: float = 0.0


def base_state(spec: FlatSpec, params, hyper: PolicyParams) -> ServerState:
    # flatten builds a fresh vector: the caller's tree is never aliased
    return ServerState(params=spec.flatten(params), version=0, hyper=hyper)


def _ring(L: int, d: int, device) -> RingState:
    return RingState(data=torch.zeros((L, d), dtype=torch.float32,
                                      device=device), count=0)


@functools.lru_cache(maxsize=8)
def _zeros(d: int, device: torch.device) -> torch.Tensor:
    """A (d,) zero vector per (d, device), never written: fedfa's global
    input to the Eq. 20 apply."""
    return torch.zeros((d,), dtype=torch.float32, device=device)


def _log_mix(tau: int, s) -> dict:
    """Log entry of a mix policy: the version gap and the mixing
    coefficient (a host float, or a 0-d device tensor until
    ``PolicyServer.host_log``)."""
    return {"tau": tau, "weight": s}


# ---------------------------------------------------------------------------
# Immediate-mix policies (one global update per arrival)
# ---------------------------------------------------------------------------

def fedasync_policy(spec: FlatSpec, alpha: float = 0.6,
                    a: float = 0.5) -> Policy:
    """FedAsync: w <- (1-s)w + s*w_i with s = alpha*(1+tau)^-a, a host
    float."""
    def step(state: ServerState, arr: Arrival):
        h = state.hyper
        s = aggregation.staleness_polynomial(arr.tau, h.alpha, h.a)
        wi = spec.flatten(arr.client_params)
        # the reference's arithmetic: (1 - s) in float32, two products, a sum
        state.params = float(np.float32(1.0) - np.float32(s)) * state.params \
            + s * wi
        state.version += 1
        return state, True, _log_mix(arr.tau, s)

    return Policy(name="fedasync", init=functools.partial(base_state, spec),
                  step=step, spec=spec, hyper=make_hyper(alpha=alpha, a=a))


def asyncfeded_policy(spec: FlatSpec, alpha: float = 0.6, eps: float = 1e-8,
                      metric: str = "l2", sketch_k: int = 16,
                      sketch_seed: int = 42) -> Policy:
    """AsyncFedED-style distance-metric staleness: w <- w + s * dw, with s
    from the drift between the returning client model and the current
    global (``core.psa.DISTANCE_METRICS``): "l2" (the original rule),
    "cosine", or "sketch" (the l2 rule on k-dim magnitude sketches, one
    ``sens_sketch`` launch over dw and the drift). s is a 0-d device
    tensor."""
    if metric not in psa_lib.DISTANCE_METRICS:
        raise ValueError(f"unknown distance metric {metric!r}; known: "
                         f"{psa_lib.DISTANCE_METRICS}")
    if metric == "sketch" and sketch_k not in KS:
        raise ValueError(f"asyncfeded: sketch_k={sketch_k} not in the "
                         f"sens_sketch kernel's {KS}")
    # "sketch" keeps the l2 code in hyper (as the reference) and is
    # selected by ``metric``, a constant of the policy
    hyper = make_hyper(alpha=alpha, eps=eps,
                       dist_mode="l2" if metric == "sketch" else metric)

    def step(state: ServerState, arr: Arrival):
        h = state.hyper
        dw = spec.flatten(arr.update)
        wi = spec.flatten(arr.client_params)
        if metric == "sketch":
            s = psa_lib.sketch_distance_scale(state.params, wi, dw,
                                              alpha=h.alpha, eps=h.eps,
                                              k=sketch_k, seed=sketch_seed)
        else:
            s = psa_lib.distance_staleness_scale(state.params, wi, dw,
                                                 alpha=h.alpha, eps=h.eps,
                                                 dist_mode=h.dist_mode)
        state.params = state.params + s * dw
        state.version += 1
        return state, True, _log_mix(arr.tau, s)

    return Policy(name="asyncfeded", init=functools.partial(base_state, spec),
                  step=step, spec=spec, hyper=hyper)


# ---------------------------------------------------------------------------
# Buffered policies (flush every L-th arrival)
# ---------------------------------------------------------------------------

def _buffered_policy(name: str, spec: FlatSpec, buffer_size: int,
                     hyper: PolicyParams, scale_fn,
                     client_align: float = 0.0) -> Policy:
    """Shared skeleton for FedBuff/FedPAC-lite: ring the (optionally
    staleness-scaled) deltas, apply their uniform mean when full.
    ``scale_fn(arr, hyper) -> float`` is evaluated on the host."""
    L = buffer_size

    def init(params, h: PolicyParams) -> ServerState:
        st = base_state(spec, params, h)
        st.ring = _ring(L, spec.size, st.params.device)
        return st

    def step(state: ServerState, arr: Arrival):
        h = state.hyper
        dw = spec.flatten(arr.update)
        ring_update(state.ring.data, dw * scale_fn(arr, h), state.ring.count)
        state.ring.count += 1
        if state.ring.count < L:
            return state, False, None
        w = aggregation.uniform_weights(L, state.params.device)
        state.params = aggregation.aggregate_flat(state.params, state.ring.data,
                                                  w, h.server_lr)
        state.version += 1
        state.ring.count = 0
        return state, True, None

    return Policy(name=name, init=init, step=step, spec=spec, hyper=hyper,
                  client_align=client_align)


def fedbuff_policy(spec: FlatSpec, buffer_size: int = 5,
                   server_lr: float = 1.0, a: float = 0.5) -> Policy:
    """FedBuff: buffer K staleness-scaled deltas, apply their mean."""
    return _buffered_policy(
        "fedbuff", spec, buffer_size, make_hyper(server_lr=server_lr, a=a),
        lambda arr, h: aggregation.staleness_polynomial(arr.tau, 1.0, h.a))


def fedpac_policy(spec: FlatSpec, buffer_size: int = 5,
                  server_lr: float = 1.0) -> Policy:
    """FedPAC-lite: FedBuff-style buffering of raw deltas; clients train with
    an extra classifier-alignment term (``client.local_update(align=...)``
    and the cohort engine's ``align``)."""
    return _buffered_policy("fedpac", spec, buffer_size,
                            make_hyper(server_lr=server_lr),
                            lambda arr, h: 1.0, client_align=0.1)


def fedpsa_policy(spec: FlatSpec, cfg: psa_lib.PSAConfig,
                  sketch_refresh: Callable) -> Policy:
    """FedPSA (Algorithm 1): behavioral-staleness softmax over the buffer.
    ``sketch_refresh(flat_params) -> (k,)`` computes the global sketch at
    init and after each aggregation (without it every kappa would be 0 and
    FedPSA would degenerate to uniform weighting)."""
    hyper = make_hyper(gamma=cfg.gamma, delta=cfg.delta,
                       server_lr=cfg.server_lr,
                       use_thermometer=cfg.use_thermometer)

    def init(params, h: PolicyParams) -> ServerState:
        st = base_state(spec, params, h)
        st.psa = psa_lib.init_state(cfg, spec.size, sketch_refresh(st.params),
                                    device=st.params.device)
        return st

    def step(state: ServerState, arr: Arrival):
        h = state.hyper
        dw = spec.flatten(arr.update)
        state.psa, state.params, info = psa_lib.server_step(
            state.psa, state.params, dw, arr.sketch, cfg, sketch_refresh,
            gamma=h.gamma, delta=h.delta, server_lr=h.server_lr,
            thermo_on=h.use_thermometer)
        if not info.updated:
            return state, False, None
        state.version += 1
        # device tensors until PolicyServer.host_log: no sync here
        log = {"weights": info.weights, "kappas": info.kappas,
               "temp": info.temp if info.temp_valid else None}
        return state, True, log

    return Policy(name="fedpsa", init=init, step=step, spec=spec,
                  hyper=hyper, sketch_k=cfg.sketch_k, needs_sketch=True)


def ca2fl_policy(spec: FlatSpec, num_clients: int, buffer_size: int = 5,
                 server_lr: float = 1.0) -> Policy:
    """CA2FL: cached-update calibration. Buffers the residual vs the
    client's previous delta; aggregation adds the cache mean back. The
    (num_clients, d) cache lives on the run's device and is indexed with a
    host ``int``."""
    L = buffer_size
    hyper = make_hyper(server_lr=server_lr)

    def init(params, h: PolicyParams) -> ServerState:
        st = base_state(spec, params, h)
        dev = st.params.device
        st.ring = _ring(L, spec.size, dev)
        st.cache = CacheState(
            data=torch.zeros((num_clients, spec.size), dtype=torch.float32,
                             device=dev),
            valid=np.zeros((num_clients,), bool),
            total=torch.zeros((spec.size,), dtype=torch.float32, device=dev))
        return st

    def step(state: ServerState, arr: Arrival):
        h, cache, cid = state.hyper, state.cache, arr.client_id
        dw = spec.flatten(arr.update)
        prev = cache.data[cid]          # zeros until the client is first seen
        ring_update(state.ring.data, dw - prev, state.ring.count)
        cache.total.add_(dw).sub_(prev)  # total + dw - prev, in that order
        cache.data[cid] = dw             # after every read of prev (a view)
        cache.valid[cid] = True
        state.ring.count += 1
        if state.ring.count < L:
            return state, False, None
        w = aggregation.uniform_weights(L, state.params.device)
        params = aggregation.aggregate_flat(state.params, state.ring.data, w,
                                            h.server_lr)
        state.params = params + h.server_lr * cache.total \
            / max(cache.n_cached, 1)
        state.version += 1
        state.ring.count = 0
        return state, True, None

    return Policy(name="ca2fl", init=init, step=step, spec=spec,
                  hyper=hyper)


def fedfa_policy(spec: FlatSpec, queue_len: int = 5,
                 beta: float = 0.5) -> Policy:
    """FedFa: the global model is a recency-weighted average of the ring of
    the last ``queue_len`` client models, refreshed on every arrival (one
    ``buffer_agg`` launch over a zero global). The ring count grows
    monotonically; slot ages are recovered from it. The weights depend only
    on the host count and beta: each of the at most 2L - 1 vectors is made
    once, in numpy float32 as the reference computes them, and kept on the
    device."""
    L = queue_len
    hyper = make_hyper(beta=beta)
    weights = {}

    def recency_weights(count: int, beta_: float, device) -> torch.Tensor:
        n, newest = min(count, L), (count - 1) % L
        key = (n, newest, beta_, device)
        w = weights.get(key)
        if w is None:
            age = np.mod(newest - np.arange(L), L).astype(np.float32)
            w = np.where(age < n, np.power(np.float32(beta_), age),
                         np.float32(0.0)).astype(np.float32)
            w = torch.from_numpy(w / np.sum(w, dtype=np.float32)).to(device)
            weights[key] = w
        return w

    def init(params, h: PolicyParams) -> ServerState:
        st = base_state(spec, params, h)
        st.ring = _ring(L, spec.size, st.params.device)
        return st

    def step(state: ServerState, arr: Arrival):
        dev = state.params.device
        ring_update(state.ring.data, spec.flatten(arr.client_params),
                    state.ring.count)
        state.ring.count += 1
        w = recency_weights(state.ring.count, state.hyper.beta, dev)
        state.params = aggregation.aggregate_flat(
            _zeros(state.params.shape[0], dev), state.ring.data, w)
        state.version += 1
        return state, True, None

    return Policy(name="fedfa", init=init, step=step, spec=spec,
                  hyper=hyper)


# ---------------------------------------------------------------------------
# Server state as named host arrays (simulator checkpoints)
# ---------------------------------------------------------------------------

def _state_fields(state: ServerState):
    """(name, holder, attribute) of every field a step reads; ``hyper``
    comes from the policy factory and is not among them."""
    yield "params", state, "params"
    yield "version", state, "version"
    if state.ring is not None:
        yield "ring/data", state.ring, "data"
        yield "ring/count", state.ring, "count"
    if state.psa is not None:
        p = state.psa
        for attr in ("buffer", "kappas", "count", "global_sketch"):
            yield f"psa/{attr}", p, attr
        for attr in ("queue", "count", "m0"):
            yield f"psa/thermo/{attr}", p.thermo, attr
    if state.cache is not None:
        for attr in ("data", "total", "valid"):
            yield f"cache/{attr}", state.cache, attr


def state_array_names(state: ServerState) -> list:
    return [name for name, _, _ in _state_fields(state)]


def map_state_tensors(state: ServerState, names, fn) -> ServerState:
    """Replace each tensor field of ``state`` named in ``names`` by
    ``fn(tensor)`` (the sharded server's layout change)."""
    for name, holder, attr in _state_fields(state):
        if name in names:
            setattr(holder, attr, fn(getattr(holder, attr)))
    return state


def state_arrays(state: ServerState, whole: Optional[Callable] = None) -> dict:
    """name -> numpy array of every field of ``state`` a step reads.
    ``whole(name, tensor)``, when given, maps a tensor field to what is
    saved (the sharded server gathers its shards)."""
    out = {}
    for name, holder, attr in _state_fields(state):
        v = getattr(holder, attr)
        if isinstance(v, torch.Tensor):
            if whole is not None:
                v = whole(name, v)
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def load_state_arrays(state: ServerState, arrays: dict,
                      local: Optional[Callable] = None) -> ServerState:
    """Restore ``state_arrays`` output into a live state built by the same
    policy: tensors as fresh tensors on the state's device and dtype, host
    ints as ``int`` (a receive still costs no device sync) and the CA2FL
    valid mask as a host bool array. ``local(name, array)``, when given,
    maps a saved array to this state's part of it (the sharded server's
    shard)."""
    for name, holder, attr in _state_fields(state):
        cur, a = getattr(holder, attr), np.asarray(arrays[name])
        if isinstance(cur, torch.Tensor):
            if local is not None:
                a = local(name, a)
            new = torch.tensor(a, dtype=cur.dtype, device=cur.device)
        elif isinstance(cur, np.ndarray):
            new = a.astype(cur.dtype)
        else:
            new = int(a)
        setattr(holder, attr, new)
    return state


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

POLICY_NAMES = ("fedasync", "fedbuff", "fedpsa", "ca2fl", "fedfa", "fedpac",
                "asyncfeded")
PORTED = POLICY_NAMES


def make_policy(name: str, spec: FlatSpec, *, num_clients: int = 50,
                psa_cfg: Optional[psa_lib.PSAConfig] = None,
                sketch_refresh: Optional[Callable] = None, **kw) -> Policy:
    if name == "fedasync":
        return fedasync_policy(spec, **kw)
    if name == "fedbuff":
        return fedbuff_policy(spec, **kw)
    if name == "fedpsa":
        if psa_cfg is None or sketch_refresh is None:
            raise ValueError("fedpsa needs psa_cfg and sketch_refresh")
        return fedpsa_policy(spec, psa_cfg, sketch_refresh)
    if name == "ca2fl":
        return ca2fl_policy(spec, num_clients=num_clients, **kw)
    if name == "fedfa":
        return fedfa_policy(spec, **kw)
    if name == "fedpac":
        return fedpac_policy(spec, **kw)
    if name == "asyncfeded":
        return asyncfeded_policy(spec, **kw)
    raise ValueError(f"unknown staleness policy {name!r}")
