"""Faults planted under the timed path, to show that the comparison
catches them: each a context manager that breaks the program while it is
open."""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def state_unchanged():
    """Local SGD hands back the model it was given: every update is 0."""
    from repro_torch.federated import cohort
    orig = cohort.CohortEngine._train

    def train(self, params_stack, *a, **kw):
        orig(self, params_stack, *a, **kw)
        return params_stack
    cohort.CohortEngine._train = train
    try:
        yield
    finally:
        cohort.CohortEngine._train = orig


@contextmanager
def half_batch():
    """Every local batch keeps its first half of rows; the loss is the
    mean over them."""
    from repro_torch.federated import cohort
    orig = cohort.epoch_batch_indices

    def schedule(n, epochs, batch_size, seed):
        s = orig(n, epochs, batch_size, seed)
        return s[:, :max(1, s.shape[1] // 2)]
    cohort.epoch_batch_indices = schedule
    try:
        yield
    finally:
        cohort.epoch_batch_indices = orig


@contextmanager
def answer_altered():
    """The first client model that local SGD produces in each simulation
    (the first wave of each engine) is scaled by 1 + 1e-3 where it is
    produced; all else is untouched."""
    from repro_torch.federated import cohort
    orig = cohort.CohortEngine._update

    def update(self, *a, **kw):
        first = self.steps_run == 0
        deltas, w = orig(self, *a, **kw)
        if first:
            w = w.clone()
            deltas = deltas.clone()
            bump = w[0] * 1e-3
            w[0] += bump
            deltas[0] += bump
        return deltas, w
    cohort.CohortEngine._update = update
    try:
        yield
    finally:
        cohort.CohortEngine._update = orig


@contextmanager
def stale_redispatch():
    """A client dispatched at a completion trains from the global model as
    it was before the wave's receives, not as it is after that
    completion: a client dispatched just after an update misses it."""
    from repro_torch.federated import servers
    orig = servers.PolicyServer.receive_many

    def receive_many(srv, *a, **kw):
        before = srv.flat_params
        updated, taus, snaps = orig(srv, *a, **kw)
        return updated, taus, [before] * len(snaps)
    servers.PolicyServer.receive_many = receive_many
    try:
        yield
    finally:
        servers.PolicyServer.receive_many = orig


@contextmanager
def magnitude_norm():
    """The thermometer queue takes each update's norm where Eq. 16 has its
    square."""
    from repro_torch.core import thermometer
    orig = thermometer.push

    def push(state, m):
        return orig(state, torch.sqrt(m))
    thermometer.push = push
    try:
        yield
    finally:
        thermometer.push = orig


@contextmanager
def drop_slot():
    """Eq. 20's apply leaves out the ring's last update (its weight set to
    0), as an off-by-one over the ring would."""
    from repro_torch.core import aggregation
    orig = aggregation.aggregate_flat

    def aggregate_flat(global_vec, updates, weights, server_lr=1.0):
        weights = weights.clone()
        weights[-1] = 0.0
        return orig(global_vec, updates, weights, server_lr)
    aggregation.aggregate_flat = aggregate_flat
    try:
        yield
    finally:
        aggregation.aggregate_flat = orig


@contextmanager
def stale_refresh():
    """FedPSA's global sketch is not refreshed after an update: kappas are
    taken against the initial model's sketch."""
    from repro_torch.core import psa
    orig = psa.server_step

    def server_step(state, global_vec, update_vec, client_sketch_vec, cfg,
                    refresh_fn=None, **kw):
        return orig(state, global_vec, update_vec, client_sketch_vec, cfg,
                    None, **kw)
    psa.server_step = server_step
    try:
        yield
    finally:
        psa.server_step = orig


@contextmanager
def staleness_off_by_one():
    """FedAsync's mixing weight takes the version gap plus one."""
    from repro_torch.core import aggregation
    orig = aggregation.staleness_polynomial

    def staleness_polynomial(tau, *a, **kw):
        return orig(tau + 1, *a, **kw)
    aggregation.staleness_polynomial = staleness_polynomial
    try:
        yield
    finally:
        aggregation.staleness_polynomial = orig


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "stale_redispatch": stale_redispatch,
          "magnitude_norm": magnitude_norm, "drop_slot": drop_slot,
          "stale_refresh": stale_refresh,
          "staleness_off_by_one": staleness_off_by_one}

# the policies whose path each fault breaks (None: every policy), and the
# numbers that catch it
CATCHES = {
    "state_unchanged": (None, {"update_norm_gap", "update_gap_med"}),
    "half_batch": (None, {"update_norm_gap", "update_gap_med"}),
    "answer_altered": (None, {"update_norm_gap", "update_gap_med"}),
    # caught by the updates where the record keeps the true global model,
    # by the apply where it keeps what the clients were handed
    "stale_redispatch": (None, {"late_update_norm_gap",
                                "late_update_gap_med", "apply_gap"}),
    "stale_refresh": ("fedpsa", {"late_kappa_gap"}),
    "magnitude_norm": ("fedpsa", {"temp_gap", "weight_gap"}),
    "drop_slot": ("fedpsa", {"apply_gap"}),
    "staleness_off_by_one": ("fedasync", {"apply_gap"}),
}


def applies(fault: str, policy: str) -> bool:
    return CATCHES[fault][0] in (None, policy)
