"""FedPSA — the paper's contribution, ported from ``repro.core.psa``.

Client side: ``client_sketch`` computes the Eq. 8 sensitivity on the
shared calibration batch and compresses it to a k-vector (Eq. 11) through
the fused ``sens_sketch`` kernel, one launch per parameter leaf. Server
side: ``PSAState`` holds a fixed-size ``(L_s, d)`` update ring;
``server_receive`` / ``server_aggregate`` follow Algorithm 1 and
``server_step`` composes them. The reference fuses the step under
``lax.cond``; here the branch "has the buffer filled" is a host ``int``
comparison, so a receive costs no device sync. The Eq. 20 apply runs
through the ``buffer_agg`` kernel and returns a fresh global vector.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.tree import grad, ring_update
from repro_torch.core import aggregation, sketch, thermometer
from repro_torch.core.sensitivity import fisher_diagonal
from repro_torch.kernels.ops import sketch_tree_fused


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


def client_sketch(loss_fn: Callable, params, calib_batch, cfg: PSAConfig
                  ) -> torch.Tensor:
    """What a client uploads beside its update: the k-dim sensitivity
    sketch on the shared calibration batch. ``loss_fn(params, batch)``."""
    if not cfg.use_sensitivity:  # w/o S ablation: sketch the raw parameters
        return sketch.sketch_tree(params, cfg.sketch_seed, cfg.sketch_k)
    g = grad(loss_fn, params, calib_batch)
    f = fisher_diagonal(loss_fn, params, calib_batch, cfg.fisher_microbatches)
    return sketch_tree_fused(params, g, f, k=cfg.sketch_k, seed=cfg.sketch_seed)


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
    thermometer.push(state.thermo, torch.sum(torch.square(u)))  # Eq. 16
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
