"""Quickstart: FedPSA vs FedBuff, 3 seeds each, in two batched simulations.

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port of the reference's ``examples/quickstart.py``, with its world, its
constants and its printed lines: build data -> partition -> pick the
paper's hyperparameters -> run each algorithm's 3 seeds as one
``run_sweep`` call (the seeds ride a shared event timeline as lanes, so the
whole multi-seed comparison costs about one simulation per algorithm
instead of three) -> compare per-seed and mean±std accuracy. Runs on the
CUDA card by default and raises without one (``--device cpu`` runs the
kernels' plain versions). Each lane's init comes from a ``torch.Generator``
seeded with its model seed (``SweepConfig.model_seeds``), where the
reference draws ``jax.random.PRNGKey(seed)``: the port has no
``jax.random``. ``run_lane`` runs one lane on its own from a given init.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import PSAConfig
from repro_torch.data import (ClientDataset, dirichlet_partition,
                              make_calibration_batch, make_classification,
                              train_test_split)
from repro_torch.federated import (SimConfig, SweepConfig, run_algorithm,
                                   run_sweep)
from repro_torch.models import model as M

SEEDS = [0, 1, 2]
ALGS = ("fedbuff", "fedpsa")
HORIZON = 30_000


def build_world():
    """``(cfg, clients, test, calib)``: the synthetic 10-class Gaussian
    mixture split Dirichlet(0.1) over 30 clients, and a pure-noise
    calibration batch (paper Table 5 shows it matches real data, at zero
    privacy cost)."""
    full = make_classification(8_000, num_classes=10, dim=32, seed=0,
                               class_sep=0.7)
    train, test = train_test_split(full, test_frac=0.1)
    parts = dirichlet_partition(train, num_clients=30, alpha=0.1, seed=0)
    clients = [ClientDataset(train.subset(ix)) for ix in parts]
    calib = make_calibration_batch(train, batch_size=64, source="gaussian")
    return get_config("paper-synthetic-mlp"), clients, test, calib


def simulation(device: str = "cuda") -> SimConfig:
    return SimConfig(num_clients=30, concurrency=0.2, horizon=HORIZON,
                     eval_every=6_000, seed=0, device=device)


# the paper's hyperparameters
PSA = PSAConfig(buffer_size=5, queue_len=50, gamma=5.0, delta=0.5,
                sketch_k=16)
# per-lane model-init and batch-shuffle seeds over a shared event timeline
SWEEP = SweepConfig(model_seeds=SEEDS, data_seeds=SEEDS)


def run(alg: str, world, sim: SimConfig, params):
    """One algorithm's seed sweep: ``run_sweep`` over ``SWEEP``."""
    cfg, clients, test, calib = world
    return run_sweep(alg, cfg, params, clients, test, sim, SWEEP,
                     psa_cfg=PSA, calib_batch=calib)


def run_lane(alg: str, world, sim: SimConfig, params, lane: int):
    """Lane ``lane`` of ``run``'s sweep as a standalone run from ``params``
    (that lane's init): its data seed on the sweep's shared timeline."""
    cfg, clients, test, calib = world
    lane_sim = dataclasses.replace(sim, seed=SEEDS[lane],
                                   timeline_seed=sim.seed)
    return run_algorithm(alg, cfg, params, clients, test, lane_sim,
                         psa_cfg=PSA, calib_batch=calib)


def line(alg: str, res) -> str:
    """The reference's printed line of one sweep."""
    mean, std = res.accuracy_mean_std()
    per_lane = "  ".join(
        f"seed{s}={a:.3f}" for s, a in zip(SEEDS, res.final_accuracy))
    return (f"{alg:8s} {per_lane}  ->  {mean:.3f}±{std:.3f}  "
            f"(AULC {np.mean(res.aulc):.3f}, "
            f"global updates {res.versions})")


def main(argv=None) -> dict:
    """Run both sweeps and print a line each; returns the sweeps by
    algorithm."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    world = build_world()
    params = M.init_params(torch.Generator().manual_seed(0), world[0])
    sim = simulation(args.device)
    out = {}
    for alg in ALGS:
        out[alg] = run(alg, world, sim, params)
        print(line(alg, out[alg]))
    return out


if __name__ == "__main__":
    main()
