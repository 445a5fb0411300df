"""Staleness-policy core of the port: every async server is one step.

A ``Policy`` has an ``init`` building a ``ServerState`` (flat contiguous
f32 parameter vector, fixed-size stacked ring buffers) and a
``step(state, arrival) -> (state, updated, log_entry)``. As in the
reference (``repro.federated.policies``), hyperparameters live in
``ServerState.hyper``; here they are host floats, and the "buffer full"
branch the reference takes under ``lax.cond`` is a host ``int``
comparison. The global vector is never written in place: an applied
update produces a fresh tensor (``buffer_agg`` writes a new output), so a
dispatch snapshot taken at an earlier version stays as it was.

Ported: ``fedpsa`` and ``fedbuff``. The other five policies of the
reference raise ``NotImplementedError`` (ROADMAP.md Queue 1 item 3b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.tree import FlatSpec, ring_update
from repro_torch.core import aggregation, psa as psa_lib


class PolicyParams(NamedTuple):
    """Timeline-preserving hyperparameters (host values) of the ported
    policies; the unported ones add theirs (alpha, beta, eps) with them."""
    a: float = 0.5                # staleness polynomial exponent
    server_lr: float = 1.0        # buffered-apply learning rate
    gamma: float = 5.0            # fedpsa temperature slope
    delta: float = 0.5            # fedpsa temperature floor
    use_thermometer: bool = True  # fedpsa w/o-T ablation switch


def make_hyper(**kw) -> PolicyParams:
    """``PolicyParams`` from keyword overrides over the defaults; raises on
    unknown keys."""
    bad = sorted(set(kw) - set(PolicyParams._fields))
    if bad:
        raise ValueError(f"unknown policy hyperparameter(s) {bad}; known: "
                         f"{sorted(PolicyParams._fields)}")
    return PolicyParams(**kw)


@dataclasses.dataclass
class RingState:
    """Fixed-size stacked ring buffer over the flat parameter layout."""
    data: torch.Tensor   # (L, d) f32, written in place (server-private)
    count: int           # fill level since the last flush


@dataclasses.dataclass
class ServerState:
    """One state for every policy; unused sub-states are None."""
    params: torch.Tensor                     # (d,) flat f32 global model
    version: int                             # completed global updates
    ring: Optional[RingState] = None
    psa: Optional[psa_lib.PSAState] = None
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
    name: str
    init: Callable[[Any], ServerState]
    step: Callable[[ServerState, Arrival], tuple]   # -> (state, updated, log)
    spec: FlatSpec
    sketch_k: int = 0
    needs_sketch: bool = False
    client_align: float = 0.0


def base_state(spec: FlatSpec, params, hyper: PolicyParams) -> ServerState:
    # flatten builds a fresh vector: the caller's tree is never aliased
    return ServerState(params=spec.flatten(params), version=0, hyper=hyper)


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

    def init(params) -> ServerState:
        st = base_state(spec, params, hyper)
        st.ring = RingState(data=torch.zeros((L, spec.size), dtype=torch.float32,
                                             device=st.params.device), count=0)
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

    return Policy(name=name, init=init, step=step, spec=spec,
                  client_align=client_align)


def fedbuff_policy(spec: FlatSpec, buffer_size: int = 5,
                   server_lr: float = 1.0, a: float = 0.5) -> Policy:
    """FedBuff: buffer K staleness-scaled deltas, apply their mean."""
    return _buffered_policy(
        "fedbuff", spec, buffer_size, make_hyper(server_lr=server_lr, a=a),
        lambda arr, h: aggregation.staleness_polynomial(arr.tau, 1.0, h.a))


def fedpsa_policy(spec: FlatSpec, cfg: psa_lib.PSAConfig,
                  sketch_refresh: Callable) -> Policy:
    """FedPSA (Algorithm 1): behavioral-staleness softmax over the buffer.
    ``sketch_refresh(flat_params) -> (k,)`` computes the global sketch at
    init and after each aggregation (without it every kappa would be 0 and
    FedPSA would degenerate to uniform weighting)."""
    hyper = make_hyper(gamma=cfg.gamma, delta=cfg.delta,
                       server_lr=cfg.server_lr,
                       use_thermometer=cfg.use_thermometer)

    def init(params) -> ServerState:
        st = base_state(spec, params, hyper)
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
        log = {"weights": info.weights.cpu().numpy(),
               "kappas": info.kappas.cpu().numpy(),
               "temp": float(info.temp) if info.temp_valid else None}
        return state, True, log

    return Policy(name="fedpsa", init=init, step=step, spec=spec,
                  sketch_k=cfg.sketch_k, needs_sketch=True)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

POLICY_NAMES = ("fedasync", "fedbuff", "fedpsa", "ca2fl", "fedfa", "fedpac",
                "asyncfeded")
PORTED = ("fedbuff", "fedpsa")


def make_policy(name: str, spec: FlatSpec, *, num_clients: int = 50,
                psa_cfg: Optional[psa_lib.PSAConfig] = None,
                sketch_refresh: Optional[Callable] = None, **kw) -> Policy:
    if name == "fedbuff":
        return fedbuff_policy(spec, **kw)
    if name == "fedpsa":
        if psa_cfg is None or sketch_refresh is None:
            raise ValueError("fedpsa needs psa_cfg and sketch_refresh")
        return fedpsa_policy(spec, psa_cfg, sketch_refresh)
    if name in POLICY_NAMES:
        raise NotImplementedError(
            f"policy {name!r} is not ported to repro_torch yet (ported: "
            f"{PORTED}); see ROADMAP.md Queue 1 item 3b")
    raise ValueError(f"unknown staleness policy {name!r}")
