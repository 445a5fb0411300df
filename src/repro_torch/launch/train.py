"""Federated training entry point of the port (one run of the paper's tables).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --alg fedpsa --arch paper-cifar10-cnn

Runs one (algorithm x Dirichlet-alpha x latency setting) cell on the
synthetic stand-in datasets, on the CUDA card by default (``--device
cpu`` runs the kernels' plain versions), and writes the learning curve and
summary JSON under ``--out``. Initial weights come from a
``torch.Generator`` seeded with ``--seed``. Every algorithm of the
reference runs (``--alg``: synchronous ``fedavg`` and the seven async
policies) on the cohort engine (the default, as in the reference) and the
sequential engine, on the paper's image models and on the token families:
``--arch fed-lm-smoke``, ``fed-lm-ssm-smoke``, ``fed-lm-moe-smoke`` (or any
dense, moe, ssm or hybrid LM id) trains the federated LM fine-tuning world,
a document-partitioned bigram corpus in ``--seq`` token sequences
(``build_lm_task``). The frontend archs (``internvl2-1b``,
``hubert-xlarge``) have no registered family, as in the reference, and
raise: they train through ``launch.steps.make_train_step``.

``--mesh N`` shards the policy server over N ranks and trains the waves
data-parallel (``SimConfig.mesh``), one process a rank: under ``torchrun``
(``RANK``/``WORLD_SIZE`` set, world size N) each process joins that
group; otherwise the command spawns N local ranks itself (a ``file://``
rendezvous in a temporary directory). The backend follows from
``--device``: ``nccl`` for ``cuda`` (one rank per card), ``gloo`` for
``cpu``; ``--dist-backend gloo`` runs several ranks on one card, which
NCCL refuses. Rank 0 alone prints and writes the run's JSON
(``..._mesh{N}.json``, with ``mesh_devices``).

``--sweep seeds=0,1,2`` (or ``--sweep gamma=0.1,1,5``, any
``PolicyParams`` field) runs the variants as lanes of one batched
simulation over a shared event timeline (``run_sweep``) and prints each
lane's and the mean and std of the final accuracy.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common import sharding
from repro_torch.configs import get_config
from repro_torch.core.psa import PSAConfig
from repro_torch.data import (ClientDataset, dirichlet_partition,
                              document_partition, iid_partition,
                              make_calibration_batch, make_classification,
                              make_lm_corpus, train_test_split)
from repro_torch.data.synthetic import SyntheticClassification
from repro_torch.federated.simulator import (ALGORITHMS, SimConfig,
                                             SweepConfig, run_algorithm,
                                             run_sweep)
from repro_torch.launch.mesh import make_fed_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import registry


def build_lm_task(cfg, num_samples: int, alpha: float, num_clients: int,
                  seed: int, calib_source: str = "gaussian",
                  seq_len: int = 32):
    """The federated LM fine-tuning world (the reference's
    ``build_lm_task``): a synthetic bigram corpus whose head (its first
    ``n_test`` sequences) is the next-token-accuracy test set and whose rest
    is document-partitioned across clients (Dirichlet-skewed shard sizes
    when ``alpha > 0``) into ``(n_i, seq_len)`` token sequences.
    ``num_samples`` counts sequences across train and test."""
    n_test = max(2, num_samples // 10)
    doc_len = 4 * seq_len
    corpus = make_lm_corpus((num_samples - n_test) * seq_len + doc_len
                            + n_test * seq_len,
                            vocab=cfg.vocab_size, seed=seed)
    test_toks = corpus[:n_test * seq_len].reshape(n_test, seq_len)
    test = SyntheticClassification(x=test_toks, y=test_toks,
                                   num_classes=cfg.vocab_size)
    parts = document_partition(corpus[n_test * seq_len:], num_clients,
                               seq_len, doc_len=doc_len, alpha=alpha,
                               seed=seed)
    clients = [ClientDataset(SyntheticClassification(
        x=p, y=p, num_classes=cfg.vocab_size)) for p in parts]
    calib = make_calibration_batch(test, 8, calib_source)
    return cfg, clients, test, calib


def build_task(model_name: str, num_samples: int, alpha: float,
               num_clients: int, seed: int, calib_source: str = "gaussian",
               seq_len: int = 32):
    """The reference's ``build_task``: for a token family the LM world
    (``build_lm_task``); for the image models synthetic data, a 10% test
    split, Dirichlet(alpha) (or IID for alpha <= 0) clients and the shared
    calibration batch."""
    cfg = get_config(model_name)
    if registry.get_family(cfg).data_kind == "tokens":
        return build_lm_task(cfg, num_samples, alpha, num_clients, seed,
                             calib_source, seq_len)
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


def main(argv=None):
    """Run the parsed command; without ``--mesh``, return its result (a
    ``SimResult``, or a ``SweepResult`` with ``--sweep``)."""
    args = _parser().parse_args(argv)
    if not args.mesh:
        return _run(args)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _rank(int(os.environ.get("LOCAL_RANK", 0)), args, "env://")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, args=(args, f"file://{tmp}/rendezvous"),
                               nprocs=args.mesh, start_method="spawn")


def _rank(local_rank: int, args, init_method: str) -> None:
    """One rank of a ``--mesh`` run: its card (cuda), the process group, the
    mesh, the run."""
    backend = args.dist_backend or (
        "nccl" if torch.device(args.device).type == "cuda" else "gloo")
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if init_method == "env://":
        dist.init_process_group(backend, init_method=init_method)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=local_rank, world_size=args.mesh)
    try:
        _run(args, make_fed_mesh(args.mesh, device=args.device))
    finally:
        dist.destroy_process_group()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", default="fedpsa", choices=ALGORITHMS)
    ap.add_argument("--arch", "--model", dest="model",
                    default="paper-synthetic-mlp")
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet alpha; <=0 for IID")
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--concurrency", type=float, default=0.2)
    ap.add_argument("--horizon", type=float, default=86_400)
    ap.add_argument("--samples", type=int, default=10_000,
                    help="total samples (image) or sequences (token tasks)")
    ap.add_argument("--seq", type=int, default=32,
                    help="sequence length for token (LM) tasks")
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
    ap.add_argument("--sweep", default=None, metavar="SPEC",
                    help="run S variants as one batched simulation "
                         "(run_sweep; lanes share the event timeline): "
                         "'seeds=0,1,2' (per-lane model and shuffle seeds) "
                         "or a policy hyperparameter grid such as "
                         "'alpha=0.3,0.6,0.9' (PolicyParams field names)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the policy server (and train waves "
                         "data-parallel) over N ranks, one process a rank")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="the --mesh process group's backend (default: nccl "
                         "for --device cuda, gloo for cpu; gloo for several "
                         "ranks on one card)")
    ap.add_argument("--out", default="artifacts/runs_torch")
    return ap


def _run(args, mesh=None):
    """One run (or sweep) of the parsed arguments; with ``mesh``, this
    rank's part of it (rank 0 prints and writes)."""
    cfg, clients, test, calib = build_task(
        args.model, args.samples, args.alpha, args.clients, args.seed,
        args.calib, seq_len=args.seq)
    params = model_lib.init_params(torch.Generator().manual_seed(args.seed), cfg)
    sim = SimConfig(num_clients=args.clients, concurrency=args.concurrency,
                    horizon=args.horizon, latency_kind=args.latency,
                    latency_lo=args.lat_lo, latency_hi=args.lat_hi,
                    seed=args.seed, engine=args.engine, device=args.device,
                    mesh=mesh)
    psa = PSAConfig(buffer_size=args.buffer, queue_len=args.queue,
                    gamma=args.gamma, delta=args.delta, sketch_k=args.sketch_k)
    name = (f"{args.alg}_{args.model}_a{args.alpha}_{args.latency}"
            f"{int(args.lat_hi)}_s{args.seed}")
    if args.mesh:
        name += f"_mesh{args.mesh}"
    writes = sharding.writes(mesh)
    if writes:
        os.makedirs(args.out, exist_ok=True)
    if args.sweep:
        return _sweep(args, name, cfg, params, clients, test, sim, psa, calib)
    t0 = time.time()
    res = run_algorithm(args.alg, cfg, params, clients, test, sim,
                        psa_cfg=psa, calib_batch=calib)
    wall = time.time() - t0
    if not writes:
        return res
    rec = {
        "alg": args.alg, "model": args.model, "alpha": args.alpha,
        "latency": [args.latency, args.lat_lo, args.lat_hi],
        "final_accuracy": res.final_accuracy, "aulc": res.aulc,
        "versions": res.versions, "dispatches": res.dispatches,
        "times": res.times, "accuracies": res.accuracies,
        "wall_s": round(wall, 1), "mesh_devices": args.mesh or None,
        "engine": res.engine, "device": args.device,
    }
    path = os.path.join(args.out, name + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[train] {name}: final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
          f"({wall:.0f}s on {args.device}) -> {path}")
    return res



def _sweep(args, name, cfg, params, clients, test, sim, psa, calib):
    key, _, vals = args.sweep.partition("=")
    if not vals:
        raise SystemExit("--sweep wants 'seeds=...' or '<hyper>=v1,v2'")
    if key == "seeds":
        seeds = [int(v) for v in vals.split(",")]
        sweep = SweepConfig(model_seeds=seeds, data_seeds=seeds)
        lane_tags = [f"seed{s}" for s in seeds]
    else:
        grid = [float(v) for v in vals.split(",")]
        sweep = SweepConfig(policy_params=[{key: v} for v in grid])
        lane_tags = [f"{key}{v:g}" for v in grid]
    t0 = time.time()
    res = run_sweep(args.alg, cfg, params, clients, test, sim, sweep,
                    psa_cfg=psa, calib_batch=calib)
    wall = time.time() - t0
    mean, std = res.accuracy_mean_std()
    rec = {
        "alg": args.alg, "model": args.model, "alpha": args.alpha,
        "latency": [args.latency, args.lat_lo, args.lat_hi],
        "sweep": args.sweep, "lanes": lane_tags,
        "final_accuracy": res.final_accuracy, "aulc": res.aulc,
        "final_accuracy_mean": mean, "final_accuracy_std": std,
        "versions": res.versions, "dispatches": res.dispatches,
        "times": res.times, "lane_accuracies": res.lane_accuracies,
        "wall_s": round(wall, 1), "engine": res.engine, "device": args.device,
    }
    name += f"_sweep-{key}{len(lane_tags)}"
    path = os.path.join(args.out, name + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    for tag, acc in zip(lane_tags, res.final_accuracy):
        print(f"[train]   lane {tag}: final={acc:.4f}")
    print(f"[train] {name}: mean={mean:.4f}+-{std:.4f} ({wall:.0f}s on "
          f"{args.device}, one batched simulation) -> {path}")
    return res


if __name__ == "__main__":
    main()
