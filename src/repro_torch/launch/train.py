"""Federated training entry point of the port (one run of the paper's tables).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --alg fedpsa --arch paper-cifar10-cnn

Runs one (algorithm x Dirichlet-alpha x latency setting) cell on the
synthetic stand-in datasets, on the CUDA card by default (``--device
cpu`` runs the kernels' plain versions), and writes the learning curve and
summary JSON under ``--out``. Initial weights come from a
``torch.Generator`` seeded with ``--seed``. Ported: ``fedpsa`` and
``fedbuff`` on the cohort engine (the default, as in the reference) and
the sequential engine, on the paper's image models; the rest raises
``NotImplementedError`` naming ROADMAP.md.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.psa import PSAConfig
from repro_torch.data import (ClientDataset, dirichlet_partition,
                              iid_partition, make_calibration_batch,
                              make_classification, train_test_split)
from repro_torch.federated.simulator import ALGORITHMS, SimConfig, run_algorithm
from repro_torch.models import model as model_lib


def build_task(model_name: str, num_samples: int, alpha: float,
               num_clients: int, seed: int, calib_source: str = "gaussian"):
    """The image world of the reference's ``build_task``: synthetic data,
    a 10% test split, Dirichlet(alpha) (or IID for alpha <= 0) clients and
    the shared calibration batch."""
    cfg = get_config(model_name)
    if cfg.family == "cnn":
        full = make_classification(num_samples, cfg.num_classes,
                                   image_hw=cfg.input_hw, seed=seed,
                                   class_sep=0.7)
    else:
        full = make_classification(num_samples, cfg.num_classes,
                                   dim=cfg.input_hw[0], seed=seed,
                                   class_sep=0.7)
    train, test = train_test_split(full, 0.1)
    if alpha <= 0:
        parts = iid_partition(train, num_clients, seed)
    else:
        parts = dirichlet_partition(train, num_clients, alpha, seed)
    clients = [ClientDataset(train.subset(ix)) for ix in parts]
    calib = make_calibration_batch(train, 64, calib_source)
    return cfg, clients, test, calib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", default="fedpsa", choices=ALGORITHMS)
    ap.add_argument("--arch", "--model", dest="model",
                    default="paper-synthetic-mlp")
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet alpha; <=0 for IID")
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--concurrency", type=float, default=0.2)
    ap.add_argument("--horizon", type=float, default=86_400)
    ap.add_argument("--samples", type=int, default=10_000)
    ap.add_argument("--engine", default="cohort",
                    choices=["cohort", "sequential"])
    ap.add_argument("--latency", default="uniform",
                    choices=["uniform", "longtail", "lognormal"])
    ap.add_argument("--lat-lo", type=float, default=10)
    ap.add_argument("--lat-hi", type=float, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib", default="gaussian", choices=["gaussian", "real"])
    ap.add_argument("--buffer", type=int, default=5)
    ap.add_argument("--queue", type=int, default=50)
    ap.add_argument("--gamma", type=float, default=5.0)
    ap.add_argument("--delta", type=float, default=0.5)
    ap.add_argument("--sketch-k", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="artifacts/runs_torch")
    args = ap.parse_args()

    cfg, clients, test, calib = build_task(
        args.model, args.samples, args.alpha, args.clients, args.seed,
        args.calib)
    params = model_lib.init_params(torch.Generator().manual_seed(args.seed), cfg)
    sim = SimConfig(num_clients=args.clients, concurrency=args.concurrency,
                    horizon=args.horizon, latency_kind=args.latency,
                    latency_lo=args.lat_lo, latency_hi=args.lat_hi,
                    seed=args.seed, engine=args.engine, device=args.device)
    psa = PSAConfig(buffer_size=args.buffer, queue_len=args.queue,
                    gamma=args.gamma, delta=args.delta, sketch_k=args.sketch_k)
    t0 = time.time()
    res = run_algorithm(args.alg, cfg, params, clients, test, sim,
                        psa_cfg=psa, calib_batch=calib)
    wall = time.time() - t0
    name = (f"{args.alg}_{args.model}_a{args.alpha}_{args.latency}"
            f"{int(args.lat_hi)}_s{args.seed}")
    rec = {
        "alg": args.alg, "model": args.model, "alpha": args.alpha,
        "latency": [args.latency, args.lat_lo, args.lat_hi],
        "final_accuracy": res.final_accuracy, "aulc": res.aulc,
        "versions": res.versions, "dispatches": res.dispatches,
        "times": res.times, "accuracies": res.accuracies,
        "wall_s": round(wall, 1), "engine": res.engine, "device": args.device,
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, name + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[train] {name}: final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
          f"({wall:.0f}s on {args.device}) -> {path}")


if __name__ == "__main__":
    main()
