"""FedPSA — the paper's contribution, ported from ``repro.core.psa``.

Client side: ``client_sketch`` computes the Eq. 8 sensitivity on the
shared calibration batch and compresses it to a k-vector (Eq. 11) through
the fused ``sens_sketch`` kernel, one launch per model;
``client_sketch_members`` does it for a wave of B members at once (the
reference's ``vmap`` of ``client_sketch``, with the member axis written
out): one gradient pass and ``fisher_microbatches`` passes for the wave,
and one launch. Server
side: ``PSAState`` holds a fixed-size ``(L_s, d)`` update ring;
``server_receive`` / ``server_aggregate`` follow Algorithm 1 and
``server_step`` composes them. The reference fuses the step under
``lax.cond``; here the branch "has the buffer filled" is a host ``int``
comparison, so a receive costs no device sync. The Eq. 20 apply runs
through the ``buffer_agg`` kernel and returns a fresh global vector.

Also here, as in the reference: the distance-metric staleness family of
``asyncfeded`` (``distance_staleness_scale``, ``sketch_distance_scale``)
and ``magnitude_sketch``, the ``sens_sketch`` kernel with g = 1, F = 0.

Every contraction over the flat parameter axis in the server's code goes
through ``common.sharding``, so the same code runs on one shard of the
mesh-sharded server (``federated.servers.ShardedPolicyServer``): sums
through ``param_axis_sum(s)`` (one fixed order, so the single-device bits
on any rank count), and the magnitude sketches through the
``sens_sketch`` kernel on the local shard, hashed from the shard's global
index (``param_axis_offset``), with the partials summed across the shards
(``param_axis_reduce``) before any norm.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import sharding
from repro_torch.common.tree import FlatSpec, ring_update
from repro_torch.core import aggregation, sketch, thermometer
from repro_torch.core.sensitivity import grad_and_fisher
from repro_torch.kernels.ops import sketch_flat
from repro_torch.kernels.sens_sketch import (sens_sketch, sens_sketch_rows,
                                             vector_table)


@dataclass(frozen=True)
class PSAConfig:
    buffer_size: int = 5          # L_s (paper: 5)
    queue_len: int = 50           # L_q (paper: 50)
    gamma: float = 5.0            # temperature slope (paper: 5)
    delta: float = 0.5            # temperature floor (paper: 0.5)
    sketch_k: int = 16            # compressed dimension k (paper: 16)
    sketch_seed: int = 42         # shared projection seed (stands in for R)
    fisher_microbatches: int = 4
    server_lr: float = 1.0
    use_sensitivity: bool = True  # False => raw-parameter sketch (w/o S ablation)
    use_thermometer: bool = True  # False => fixed Temp = delta+gamma (w/o T ablation)


def structural(cfg: PSAConfig) -> tuple:
    """The shape- and program-determining subset of a PSAConfig, which
    sweep lanes share; gamma, delta, server_lr and use_thermometer may vary
    per lane."""
    return (cfg.buffer_size, cfg.queue_len, cfg.sketch_k, cfg.sketch_seed,
            cfg.fisher_microbatches, cfg.use_sensitivity)


def client_sketch(loss_fn: Callable, params, calib_batch, cfg: PSAConfig
                  ) -> torch.Tensor:
    """What a client uploads beside its update: the k-dim sensitivity
    sketch on the shared calibration batch. ``loss_fn(params, batch)``."""
    if not cfg.use_sensitivity:  # w/o S ablation: sketch the raw parameters
        return sketch.sketch_tree(params, cfg.sketch_seed, cfg.sketch_k)
    spec = FlatSpec(params)
    return _sketch_rows(loss_fn, spec, spec.flatten(params), calib_batch,
                        cfg)


def client_sketch_members(member_loss_fn: Callable, spec: FlatSpec,
                          w: torch.Tensor, calib_batch, cfg: PSAConfig
                          ) -> torch.Tensor:
    """(B, k) sketches of a wave's (B, d) flat client models.
    ``member_loss_fn(params, batch) -> (B,)`` takes member-batched
    parameters ((B, *shape) leaves) and the shared calibration batch."""
    if not cfg.use_sensitivity:
        return torch.stack([sketch.sketch_tree(spec.unflatten(row),
                                               cfg.sketch_seed, cfg.sketch_k)
                            for row in w])
    return _sketch_rows(member_loss_fn, spec, w, calib_batch, cfg)


def _sketch_rows(loss_fn, spec: FlatSpec, w: torch.Tensor, calib_batch,
                 cfg: PSAConfig) -> torch.Tensor:
    """Sketch of flat w, (d,) -> (k,) or (B, d) -> (B, k): the gradient and
    Fisher diagonal with respect to w, then one sens_sketch launch."""
    g, f = grad_and_fisher(loss_fn, spec, w, calib_batch,
                           cfg.fisher_microbatches)
    rows = w.reshape(-1, spec.size)
    out = sketch_flat(spec, rows, g.reshape(rows.shape), f.reshape(rows.shape),
                      k=cfg.sketch_k, seed=cfg.sketch_seed)
    return out.reshape(w.shape[:-1] + (cfg.sketch_k,))


@dataclass
class PSAState:
    """Server-side Algorithm-1 state. ``buffer`` is the ``(L_s, d)`` ring
    over the flat f32 layout, written in place (it is server-private);
    ``count`` is the host fill level since the last aggregation."""
    buffer: torch.Tensor          # (L_s, d) stacked update ring
    kappas: torch.Tensor          # (L_s,) behavioral similarity per slot
    count: int                    # fill level since last aggregate
    thermo: thermometer.ThermometerState
    global_sketch: torch.Tensor   # (k,) sketch of the current global model

    @property
    def buffer_size(self) -> int:
        return self.buffer.shape[0]


class PSAInfo(NamedTuple):
    """Per-step diagnostics. ``weights``/``temp`` are None when the step
    did not aggregate; ``temp_valid`` is False in the uniform phase."""
    updated: bool
    weights: Optional[torch.Tensor]
    kappas: torch.Tensor
    temp: Optional[torch.Tensor]
    temp_valid: bool


def init_state(cfg: PSAConfig, d: int, global_sketch=None,
               device="cpu") -> PSAState:
    """Fresh server state for a d-parameter model."""
    if global_sketch is None:
        global_sketch = torch.zeros((cfg.sketch_k,), dtype=torch.float32)
    return PSAState(
        buffer=torch.zeros((cfg.buffer_size, d), dtype=torch.float32, device=device),
        kappas=torch.zeros((cfg.buffer_size,), dtype=torch.float32, device=device),
        count=0,
        thermo=thermometer.init_thermometer(cfg.queue_len, device),
        global_sketch=torch.as_tensor(global_sketch, dtype=torch.float32,
                                      device=device))


def server_receive(state: PSAState, update_vec: torch.Tensor,
                   client_sketch_vec: torch.Tensor) -> PSAState:
    """Algorithm 1 lines 14-16: write (dw, kappa) into the next ring slot
    and push the update magnitude into the thermometer queue. Aggregate
    once ``buffer_full``: a further push overwrites the oldest slot."""
    kappa = sketch.cosine(client_sketch_vec, state.global_sketch)
    u = update_vec.float()
    slot = ring_update(state.buffer, u, state.count)
    state.kappas[slot] = kappa
    thermometer.push(state.thermo,
                     sharding.param_axis_sum(torch.square(u)))  # Eq. 16
    state.count += 1
    return state


def buffer_full(state: PSAState) -> bool:
    return state.count >= state.buffer_size


def _weights_and_temp(state: PSAState, gamma: float, delta: float,
                      thermo_on: bool):
    """Eq. 18-19 with Algorithm 1's phase switch: uniform averaging until
    the thermometer queue first fills, temperature softmax afterwards (or
    always, at the fixed temp gamma + delta, under the w/o-T ablation)."""
    dev = state.kappas.device
    if thermo_on:
        temp = thermometer.temperature(state.thermo, gamma, delta)
        if thermometer.is_full(state.thermo):
            return aggregation.psa_weights(state.kappas, temp), temp, True
        return aggregation.uniform_weights(state.buffer_size, dev), temp, False
    temp = torch.tensor(np.float32(gamma) + np.float32(delta), device=dev)
    return aggregation.psa_weights(state.kappas, temp), temp, True


def server_aggregate(state: PSAState, global_vec: torch.Tensor,
                     cfg: PSAConfig, *, gamma=None, delta=None,
                     server_lr=None, thermo_on=None):
    """Algorithm 1 lines 17-31: weight the buffered updates and apply them
    to the flat global vector. Returns ``(state, new_global_vec, PSAInfo)``;
    call only when ``buffer_full``."""
    weights, temp, temp_valid = _weights_and_temp(
        state, cfg.gamma if gamma is None else gamma,
        cfg.delta if delta is None else delta,
        cfg.use_thermometer if thermo_on is None else thermo_on)
    new_global = aggregation.aggregate_flat(
        global_vec, state.buffer, weights,
        cfg.server_lr if server_lr is None else server_lr)
    info = PSAInfo(updated=True, weights=weights, kappas=state.kappas.clone(),
                   temp=temp, temp_valid=temp_valid)
    state.count = 0
    return state, new_global, info


def server_step(state: PSAState, global_vec: torch.Tensor,
                update_vec: torch.Tensor, client_sketch_vec: torch.Tensor,
                cfg: PSAConfig, refresh_fn: Optional[Callable] = None, *,
                gamma=None, delta=None, server_lr=None, thermo_on=None):
    """One Algorithm-1 server step: receive, and — iff the buffer just
    filled — aggregate and refresh the global sketch with
    ``refresh_fn(new_global_vec) -> (k,)``. Returns
    ``(state, global_vec, PSAInfo)``."""
    state = server_receive(state, update_vec, client_sketch_vec)
    if not buffer_full(state):
        return state, global_vec, PSAInfo(False, None, state.kappas, None, False)
    state, new_global, info = server_aggregate(
        state, global_vec, cfg, gamma=gamma, delta=delta,
        server_lr=server_lr, thermo_on=thermo_on)
    if refresh_fn is not None:
        state.global_sketch = refresh_fn(new_global)
    return state, new_global, info


# ---------------------------------------------------------------------------
# Distance-metric staleness family (generalizing AsyncFedED's Euclidean
# drift; the metric taxonomy of "Revisiting Gradient Staleness")
# ---------------------------------------------------------------------------

DISTANCE_METRICS = ("l2", "cosine", "sketch")

# ``PolicyParams.dist_mode`` codes of the arithmetic variants (the
# reference's traced values); "sketch" is a structural choice of
# ``asyncfeded_policy(metric="sketch")``.
DIST_MODE_L2 = 0.0
DIST_MODE_COSINE = 1.0


def distance_staleness_scale(global_vec: torch.Tensor, wi: torch.Tensor,
                             dw: torch.Tensor, *, alpha: float, eps: float,
                             dist_mode: float) -> torch.Tensor:
    """AsyncFedED-family mixing coefficient s for  w <- w + s * dw, a 0-d
    tensor on the vectors' device (no host round trip):

    l2 (``dist_mode=0``):  s = alpha * min(1, ||dw|| / (||w_i - w|| + eps));
    cosine (``dist_mode=1``):
        s = alpha * 0.5 * (1 + <dw, w_i - w> / (||dw||*||w_i - w|| + eps)).
    ``dist_mode`` is a host value, so the branch costs no sync. On a shard,
    the sums complete across the shards in one ``all_reduce``."""
    drift = wi - global_vec
    terms = [torch.square(drift), torch.square(dw)]
    if dist_mode >= 0.5:
        terms.append(dw * drift)
    sums = sharding.param_axis_sums(*terms)
    dist, norm = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    if dist_mode < 0.5:
        return alpha * torch.clamp(norm / (dist + eps), max=1.0)
    return alpha * (0.5 * (1.0 + sums[2] / (norm * dist + eps)))


@functools.lru_cache(maxsize=8)
def _unit_rows(d: int, device: torch.device):
    """(2, d) ones and zeros: the g = 1, F = 0 rows of a two-row
    ``magnitude_sketch``, made once per (d, device)."""
    return (torch.ones((2, d), dtype=torch.float32, device=device),
            torch.zeros((2, d), dtype=torch.float32, device=device))


def magnitude_sketch(vec: torch.Tensor, *, k: int, seed: int) -> torch.Tensor:
    """(k,) JL magnitude sketch  z = R|vec| / sqrt(k)  with the same
    Rademacher hash as the sensitivity sketch, so ||z|| estimates
    ||vec||_2: ``sens_sketch`` with (g=1, F=0), under which the Eq. 8
    sensitivity |g*theta - 0.5*F*theta^2| is exactly |vec|. The whole
    vector is one leaf hashed with ``seed`` from index 0; a shard is hashed
    from its first element's global index, and the shards' (k,) partials
    are summed."""
    z = sens_sketch(vec, torch.ones_like(vec), torch.zeros_like(vec), k=k,
                    seed=seed,
                    index_offset=sharding.param_axis_offset(vec.shape[0]))
    return sharding.param_axis_reduce(z)


def sketch_distance_scale(global_vec: torch.Tensor, wi: torch.Tensor,
                          dw: torch.Tensor, *, alpha: float, eps: float,
                          k: int, seed: int) -> torch.Tensor:
    """The l2 rule evaluated in k-dim sketch space, a 0-d tensor:

        s = alpha * min(1, ||R|dw||| / (||R|w_i - w||| + eps))

    The reference sketches dw and the drift in two calls; here they are
    the two rows of one ``sens_sketch_rows`` launch over a one-leaf table
    (the same function: each row is ``magnitude_sketch`` of its vector).
    On a shard the launch hashes from the shard's global index and the
    (2, k) partials are summed across the shards before the norms."""
    d, dev = dw.shape[0], dw.device
    ones, zeros = _unit_rows(d, dev)
    table = vector_table(d, seed, sharding.param_axis_offset(d), k, dev)
    z = sharding.param_axis_reduce(sens_sketch_rows(
        torch.stack([dw, wi - global_vec]), ones, zeros, table))
    norm, dist = torch.sqrt(torch.sum(torch.square(z), dim=1)).unbind()
    return alpha * torch.clamp(norm / (dist + eps), max=1.0)
