"""Paper protocol run: one full cell of Table 2 + the Fig. 6 diagnostic.

    PYTHONPATH=src python -m repro_torch.examples.paper_protocol [--horizon 60000]
    PYTHONPATH=src python -m repro_torch.examples.paper_protocol --device cpu

The port of the reference's ``examples/paper_protocol.py``, with its world,
its arguments and its printed lines: 50 clients, 20% concurrency, 5 local
epochs, batch 64, SGD lr 0.01 with x0.999 decay, latency ~ U(10, 500) —
exactly §6.1 — on the synthetic CIFAR-10 stand-in, comparing all 8
algorithms (``ALGORITHMS``: synchronous FedAvg and the 7 async policies) at
Dirichlet alpha = 0.1, then inspecting FedPSA's aggregation internals
(weights / kappa / Temp). Runs on the CUDA card by default and raises
without one (``--device cpu`` runs the kernels' plain versions). The init
comes from a ``torch.Generator`` seeded with 0, where the reference draws
``jax.random.PRNGKey(0)``: the port has no ``jax.random``; ``run_all``
takes any init.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import PSAConfig
from repro_torch.data import (ClientDataset, dirichlet_partition,
                              make_calibration_batch, make_classification,
                              train_test_split)
from repro_torch.federated import ALGORITHMS, SimConfig, run_algorithm
from repro_torch.models import model as M


def build_world(num_clients: int = 50):
    """``(cfg, clients, test, calib)``: 10,000 synthetic samples split
    Dirichlet(0.1) over ``num_clients``, and a pure-noise calibration
    batch."""
    full = make_classification(10_000, 10, 32, seed=0, class_sep=0.7)
    train, test = train_test_split(full, 0.1)
    parts = dirichlet_partition(train, num_clients, alpha=0.1, seed=0)
    clients = [ClientDataset(train.subset(ix)) for ix in parts]
    calib = make_calibration_batch(train, 64, "gaussian")
    return get_config("paper-synthetic-mlp"), clients, test, calib


def simulation(horizon: float, num_clients: int,
               device: str = "cuda") -> SimConfig:
    return SimConfig(num_clients=num_clients, concurrency=0.2,
                     horizon=horizon, eval_every=10_000, seed=0,
                     device=device)


def run_one(alg: str, world, sim: SimConfig, params):
    """One algorithm's run from ``params``, with the default
    ``PSAConfig``."""
    cfg, clients, test, calib = world
    return run_algorithm(alg, cfg, params, clients, test, sim,
                         psa_cfg=PSAConfig(), calib_batch=calib)


def line(alg: str, res) -> str:
    """The reference's printed line of one run."""
    return (f"{alg:9s} final={res.final_accuracy:.3f} aulc={res.aulc:.3f} "
            f"updates={res.versions}")


def run_all(world, sim: SimConfig, params) -> dict:
    """Every algorithm of ``ALGORITHMS`` from ``params``, printing the
    reference's line per run; returns the results by algorithm."""
    results = {}
    for alg in ALGORITHMS:
        results[alg] = run_one(alg, world, sim, params)
        print(line(alg, results[alg]))
    return results


def report(results: dict) -> None:
    """The ordering line, then FedPSA's thermometer and kappa lines."""
    print("\nTable-2-style ordering at alpha=0.1 "
          "(paper: FedPSA > FedBuff > FedAsync/FedFa):")
    order = sorted(results, key=lambda a: -results[a].final_accuracy)
    print("  " + " > ".join(order))

    psa_log = results["fedpsa"].server_log
    temps = [e["temp"] for e in psa_log if e["temp"] is not None]
    if temps:
        print(f"\nFedPSA thermometer: Temp first={temps[0]:.2f} "
              f"last={temps[-1]:.2f} (cooling => sharper softmax late)")
    kappas = np.concatenate([e["kappas"] for e in psa_log])
    print(f"kappa over run: mean={kappas.mean():.3f} min={kappas.min():.3f} "
          f"max={kappas.max():.3f}")


def main(argv=None) -> dict:
    """Run the cell and print its lines; returns the results by
    algorithm."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=float, default=60_000)
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    world = build_world(args.clients)
    params = M.init_params(torch.Generator().manual_seed(0), world[0])
    results = run_all(world, simulation(args.horizon, args.clients,
                                        args.device), params)
    report(results)
    return results


if __name__ == "__main__":
    main()
