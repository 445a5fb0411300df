"""Event-driven virtual-time AFL simulator (FLGO-style: 86,400 units/day).

The port of the reference's ``repro.federated.simulator`` sequential
engine: ``concurrency`` clients train at all times; on each completion the
server ingests the update, a new client is dispatched with the current
global model, and the learning curve is sampled on a fixed virtual-time
grid. The event timeline, latency and dispatch streams are the reference's
(their numpy copies in this package), so a run makes the same dispatches
in the same order as the reference's ``engine="sequential"`` oracle.

Runs on ``SimConfig.device`` — the CUDA card by default, where the FedPSA
kernels (``sens_sketch``, ``buffer_agg``) launch; ``device="cpu"`` runs
their plain versions. Paths that are not ported yet (the cohort engine,
sharded meshes, streaming shards, checkpoints, the grouped member kernel,
sweeps, synchronous FedAvg) raise ``NotImplementedError`` naming
ROADMAP.md; none of them falls back to another path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.core import psa as psa_lib
from repro_torch.data.loader import ClientDataset
from repro_torch.federated import client as client_lib
from repro_torch.federated import servers as servers_lib
from repro_torch.federated.scheduler import (Dispatcher, make_scheduler,
                                             make_streams)
from repro_torch.federated.timeline import Timeline
from repro_torch.models import model as model_lib
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig

ENGINES = ("cohort", "sequential")
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclass
class SimConfig:
    num_clients: int = 50
    concurrency: float = 0.2          # fraction of clients training at once
    local_epochs: int = 5
    batch_size: int = 64
    lr: float = 0.01
    lr_decay: float = 0.999
    horizon: float = 86_400.0         # virtual time units (1 day default)
    eval_every: float = 2_000.0
    latency_kind: str = "uniform"
    latency_lo: float = 10.0
    latency_hi: float = 500.0
    availability_kind: str = "always"  # see latency.per_client_availability
    dropout_rate: float = 0.0          # per-dispatch failure rate when enabled
    scheduler: str = "uniform"         # see federated.scheduler
    scheduler_params: Optional[dict] = None
    seed: int = 0
    timeline_seed: Optional[int] = None
    eval_batches: int = 8
    eval_batch_size: int = 512
    # The reference's default engine. Only "sequential" is ported; "cohort"
    # raises (ROADMAP.md Queue 1 item 4).
    engine: str = "cohort"
    member_kernel: str = "vmap"        # "grouped" is not ported
    shard_size: int = 0                # > 0 (streaming slabs) is not ported
    checkpoint_dir: Optional[str] = None  # checkpoints are not ported
    mesh: Optional[object] = None      # the sharded server is not ported
    record_trajectory: bool = False
    # Where the run executes. "cuda" needs a card and raises without one;
    # "cpu" runs the kernels' plain versions (the CPU tests).
    device: str = "cuda"


@dataclass
class SimResult:
    times: List[float] = field(default_factory=list)
    accuracies: List[float] = field(default_factory=list)
    final_accuracy: float = 0.0
    versions: int = 0
    dispatches: int = 0
    launched: int = 0                 # total dispatch calls (incl. in flight)
    dropped: int = 0                  # dispatches lost to client unavailability
    engine: str = ""
    server_log: List[dict] = field(default_factory=list)
    receive_log: List[dict] = field(default_factory=list)
    digests: List[List[float]] = field(default_factory=list)

    @property
    def aulc(self) -> float:
        """Area under the learning curve normalised by the run's time span;
        NaN when the curve has fewer than two points or spans no time."""
        if len(self.times) < 2:
            return float("nan")
        t = np.asarray(self.times)
        a = np.asarray(self.accuracies)
        span = float(t[-1] - t[0])
        if span <= 0.0:
            return float("nan")
        return float(_trapezoid(a, t) / span)


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md {item}")


def _check_ported(sim: SimConfig) -> None:
    if sim.engine not in ENGINES:
        raise ValueError(f"unknown engine {sim.engine!r}; known: {ENGINES}")
    if sim.engine == "cohort":
        raise _unported("engine='cohort'", "Queue 1 item 4 (pass "
                        "engine='sequential')")
    if sim.mesh is not None:
        raise _unported("SimConfig.mesh (the sharded server)", "Queue 1 item 9")
    if sim.shard_size > 0:
        raise _unported("SimConfig.shard_size > 0 (streaming slabs)",
                        "Queue 1 item 8")
    if sim.checkpoint_dir:
        raise _unported("SimConfig.checkpoint_dir (checkpoint/resume)",
                        "Queue 1 item 6")
    if sim.member_kernel != "vmap":
        raise _unported(f"member_kernel={sim.member_kernel!r}",
                        "Queue 1 item 5")


def setup_device(name: str) -> torch.device:
    """Resolve ``SimConfig.device``. A CUDA request without a card raises:
    the port never moves a run to the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} was requested but torch sees no CUDA "
                f"device; pass device='cpu' to run the plain CPU path")
        # cuDNN runs float32 convolutions in TF32 by default (about three
        # decimal digits), which pushes the CNN convs outside the golden
        # tolerance; parity runs in full float32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def _build_eval(cfg: ModelConfig, test_ds, sim: SimConfig, device):
    """Accuracy over ``eval_batches`` fixed test batches (the reference's
    ``RandomState(1234)`` draw), held on ``device``."""
    fam = registry.get_family(cfg)
    rng = np.random.RandomState(1234)
    n = len(test_ds)
    bs = min(sim.eval_batch_size, n)
    idxs = [rng.choice(n, size=bs, replace=False) for _ in range(sim.eval_batches)]
    batches = [fam.batch_fn(test_ds.x[ix], test_ds.y[ix], device) for ix in idxs]

    def evaluate(params) -> float:
        with torch.no_grad():
            accs = torch.stack([fam.eval_accuracy(params, b, cfg)
                                for b in batches])
        return float(np.mean(accs.cpu().numpy().astype(np.float64)))

    return evaluate


def make_sketch_fn(cfg: ModelConfig, calib_batch: dict,
                   psa_cfg: psa_lib.PSAConfig, device="cpu") -> Callable:
    """params tree -> (k,) FedPSA client sketch on the calibration batch."""
    calib = registry.get_family(cfg).batch_fn(calib_batch["x"],
                                              calib_batch["y"], device)

    def loss(params, batch):
        return model_lib.loss_fn(params, batch, cfg)

    def fn(params):
        return psa_lib.client_sketch(loss, params, calib, psa_cfg)

    return fn


# Trajectory digest: one (||w||_2, probe·w) pair per applied receive — a
# 2-float fingerprint of the global vector, compared against the
# reference's checked-in golden streams within float tolerance.
_DIGEST_SEED = 0xD16E57


def make_digest_fn(d: int) -> Callable:
    """(B, d) -> (B, 2) numpy digest with the reference's fixed probe."""
    probe = np.random.RandomState(_DIGEST_SEED).randn(d).astype(np.float32)

    def fn(rows):
        rows = np.asarray(rows, np.float32)
        return np.stack([np.sqrt(np.sum(rows * rows, axis=-1)),
                         rows @ probe], axis=-1)

    return fn


def run_async(server_name: str, cfg: ModelConfig, init_params,
              client_datasets: List[ClientDataset], test_ds,
              sim: SimConfig, *, psa_cfg: Optional[psa_lib.PSAConfig] = None,
              calib_batch: Optional[dict] = None,
              server_kwargs: Optional[dict] = None,
              receive_hook: Optional[Callable] = None) -> SimResult:
    """Run one asynchronous algorithm to the virtual-time horizon."""
    _check_ported(sim)
    device = setup_device(sim.device)
    params = tree_map(lambda x: torch.as_tensor(x, dtype=torch.float32,
                                                device=device), init_params)
    streams = make_streams(sim)
    scheduler = make_scheduler(sim)
    sketch_fn = None
    if server_name == "fedpsa":
        psa_cfg = psa_cfg or psa_lib.PSAConfig()
        if calib_batch is None:
            raise ValueError("fedpsa needs calib_batch")
        sketch_fn = make_sketch_fn(cfg, calib_batch, psa_cfg, device)
    server = servers_lib.make_server(
        server_name, params, num_clients=sim.num_clients, psa_cfg=psa_cfg,
        sketch_fn=sketch_fn, **(server_kwargs or {}))
    digest_fn = (make_digest_fn(server.policy.spec.size)
                 if sim.record_trajectory else None)
    evaluate = _build_eval(cfg, test_ds, sim, device)
    result = SimResult(engine="sequential")
    concurrency = max(1, int(round(sim.concurrency * sim.num_clients)))
    timeline = Timeline()
    data_sizes = np.array([len(d) for d in client_datasets], np.float64)
    dispatcher = Dispatcher(sim, streams, scheduler, timeline, server,
                            result, batched=False, data_sizes=data_sizes)
    dispatcher.dispatch_many(np.zeros(concurrency))
    t = _drain_sequential(server, cfg, client_datasets, sim,
                          dispatcher.dispatch, timeline, evaluate, result,
                          data_sizes, server.client_align, sketch_fn,
                          receive_hook, digest_fn)
    result.final_accuracy = evaluate(server.params)
    result.times.append(min(t, sim.horizon))
    result.accuracies.append(result.final_accuracy)
    result.versions = server.version
    result.server_log = server.log
    return result


def _drain_sequential(server, cfg, client_datasets, sim: SimConfig, dispatch,
                      timeline, evaluate, result: SimResult, data_sizes,
                      align, sketch_fn, receive_hook, digest_fn=None) -> float:
    """The reference loop: one local_update per completion."""
    next_eval = 0.0
    t = 0.0
    while timeline and t < sim.horizon:
        ev = timeline.pop()
        t = ev.t_done
        if t > sim.horizon:
            break
        while next_eval <= t:
            acc = evaluate(server.params)
            result.times.append(next_eval)
            result.accuracies.append(acc)
            next_eval += sim.eval_every
        if not ev.ok:
            result.dropped += 1
            dispatch(t)
            continue
        lr = sim.lr * (sim.lr_decay ** result.dispatches)
        delta, w_client = client_lib.local_update(
            ev.snapshot, cfg, client_datasets[ev.cid],
            epochs=sim.local_epochs, batch_size=sim.batch_size, lr=lr,
            seed=sim.seed * 100003 + result.dispatches, align=align)
        meta = {
            "tau": server.version - ev.version,
            "client_id": ev.cid,
            "data_size": float(data_sizes[ev.cid]),
        }
        if server.needs_sketch:
            meta["sketch"] = sketch_fn(w_client)
        if receive_hook is not None:
            receive_hook(server, w_client, delta, meta, t)
        server.receive(delta, w_client, meta)
        if digest_fn is not None:
            row = server.flat_params.cpu().numpy()[None, :]
            result.digests.append(digest_fn(row)[0].tolist())
        result.dispatches += 1
        result.receive_log.append({"t": t, "tau": meta["tau"], "client": ev.cid})
        dispatch(t)
    return t


ALGORITHMS = ("fedavg", "fedasync", "fedbuff", "fedpsa", "ca2fl", "fedfa",
              "fedpac", "asyncfeded")


def run_fedavg(*args, **kw) -> SimResult:
    raise _unported("synchronous FedAvg (run_fedavg)", "Queue 1 item 6")


def run_sweep(*args, **kw):
    raise _unported("sweep lanes (run_sweep)", "Queue 1 item 7")


def run_algorithm(name: str, cfg: ModelConfig, init_params, client_datasets,
                  test_ds, sim: SimConfig, **kw) -> SimResult:
    if name == "fedavg":
        return run_fedavg(cfg, init_params, client_datasets, test_ds, sim, **kw)
    return run_async(name, cfg, init_params, client_datasets, test_ds, sim, **kw)
