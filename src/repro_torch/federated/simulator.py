"""Event-driven virtual-time AFL simulator (FLGO-style: 86,400 units/day).

The port of the reference's ``repro.federated.simulator``:
``concurrency`` clients train at all times; on each completion the server
ingests the update, a new client is dispatched with the current global
model, and the learning curve is sampled on a fixed virtual-time grid. The
event timeline, latency and dispatch streams are the reference's (their
numpy copies in this package), so a run makes the same dispatches in the
same order as the reference.

Two engines, as in the reference: ``engine="sequential"`` (the oracle: one
``client.local_update`` per completion) and ``engine="cohort"`` (the
default: each wave of completions trains as one batch of members in
``federated.cohort.CohortEngine``, and its receives are ingested with
``PolicyServer.receive_many``), which reproduces the oracle's receive
order, versions and eval times.

Every async policy of the reference runs on both engines (fedasync,
fedbuff, fedpsa, ca2fl, fedfa, fedpac, asyncfeded; ``server_kwargs`` reach
the policy, e.g. asyncfeded's ``metric=``). Runs on ``SimConfig.device`` —
the CUDA card by default, where the kernels launch: ``buffer_agg`` for
each buffered apply (every receive under fedfa), ``sens_sketch`` for
FedPSA's sketches and asyncfeded's ``metric="sketch"``, and
``grouped_matmul`` under ``member_kernel="grouped"``; ``device="cpu"``
runs their plain versions. Paths that are not ported yet (sharded meshes,
streaming shards, checkpoints, sweeps, synchronous FedAvg) raise
``NotImplementedError`` naming ROADMAP.md; none of them falls back to
another path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.common.device import setup_device
from repro_torch.common.tree import FlatSpec, tree_leaves, tree_map
from repro_torch.core import psa as psa_lib
from repro_torch.data.loader import ClientDataset, StackedClients
from repro_torch.federated import client as client_lib
from repro_torch.federated import servers as servers_lib
from repro_torch.federated.cohort import CohortEngine
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
    engine: str = "cohort"             # "cohort" (batched) | "sequential"
    max_cohort: int = 256              # cap on one wave's device batch
    # Member-math routing inside the cohort engine (models.member_math):
    # "vmap" runs the member-batched dense products as plain matmuls;
    # "grouped" runs them through the grouped_matmul kernel, forward and
    # backward.
    member_kernel: str = "vmap"        # "vmap" | "grouped"
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
    cohorts: int = 0                  # device batches the cohort engine ran
    engine: str = ""
    server_log: List[dict] = field(default_factory=list)  # host values
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
    if sim.mesh is not None:
        raise _unported("SimConfig.mesh (the sharded server)", "Queue 1 item 9")
    if sim.shard_size > 0:
        raise _unported("SimConfig.shard_size > 0 (streaming slabs)",
                        "Queue 1 item 8")
    if sim.checkpoint_dir:
        raise _unported("SimConfig.checkpoint_dir (checkpoint/resume)",
                        "Queue 1 item 6")


def _resolve_engine(sim: SimConfig, cfg: ModelConfig) -> str:
    """Validate ``sim.engine`` for ``cfg``. A family the registry does not
    hold raises; the port never falls back to another engine."""
    if sim.engine not in ENGINES:
        raise ValueError(f"unknown engine {sim.engine!r}; known: {ENGINES}")
    if sim.engine == "cohort" and not registry.is_registered(cfg.family):
        raise _unported(f"engine='cohort' for model family {cfg.family!r}",
                        "Queue 1 item 10")
    return sim.engine


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
    """params tree -> (k,) FedPSA client sketch on the calibration batch
    (one ``sens_sketch`` launch per tree)."""
    calib = registry.get_family(cfg).batch_fn(calib_batch["x"],
                                              calib_batch["y"], device)

    def loss(params, batch):
        return model_lib.loss_fn(params, batch, cfg)

    def fn(params):
        return psa_lib.client_sketch(loss, params, calib, psa_cfg)

    return fn


def make_sketch_fn_flat(cfg: ModelConfig, calib_batch: dict,
                        psa_cfg: psa_lib.PSAConfig, spec: FlatSpec,
                        device="cpu") -> Callable:
    """(B, d) flat client models -> (B, k) sketches of a whole wave: the
    member-batched loss (``client_loss(..., members=True)``) on the shared
    calibration batch, one gradient pass plus ``fisher_microbatches``
    passes for the wave and one ``sens_sketch`` launch — the reference's
    jitted ``vmap`` of ``client_sketch``, with the member axis written
    out."""
    fam = registry.get_family(cfg)
    calib = fam.batch_fn(calib_batch["x"], calib_batch["y"], device)

    def member_loss(params, batch):
        B, (n, *shape) = tree_leaves(params)[0].shape[0], batch["x"].shape
        x = batch["x"].expand(B, n, *shape)
        vm = torch.ones((B, n), dtype=torch.float32, device=x.device)
        cnt = torch.full((B,), float(n), dtype=torch.float32, device=x.device)
        return fam.client_loss(params, fam.masked_batch(
            x, batch["y"].expand(B, n), vm, cnt), cfg, members=True)

    def fn(w_stack):
        return psa_lib.client_sketch_members(member_loss, spec, w_stack, calib,
                                             psa_cfg)

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
    engine = _resolve_engine(sim, cfg)
    batched = engine == "cohort"
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
    result = SimResult(engine=engine)
    concurrency = max(1, int(round(sim.concurrency * sim.num_clients)))
    timeline = Timeline()
    data_sizes = np.array([len(d) for d in client_datasets], np.float64)
    dispatcher = Dispatcher(sim, streams, scheduler, timeline, server,
                            result, batched=batched, data_sizes=data_sizes)
    dispatcher.dispatch_many(np.zeros(concurrency))
    if batched:
        sketch_rows = (make_sketch_fn_flat(cfg, calib_batch, psa_cfg,
                                           server.policy.spec, device)
                       if server.needs_sketch else None)
        t = _drain_cohort(server, cfg, client_datasets, sim,
                          dispatcher.dispatch_many, timeline, evaluate, result,
                          data_sizes, server.client_align, sketch_rows,
                          receive_hook, digest_fn, device)
    else:
        t = _drain_sequential(server, cfg, client_datasets, sim,
                              dispatcher.dispatch, timeline, evaluate, result,
                              data_sizes, server.client_align, sketch_fn,
                              receive_hook, digest_fn)
    result.final_accuracy = evaluate(server.params)
    result.times.append(min(t, sim.horizon))
    result.accuracies.append(result.final_accuracy)
    result.versions = server.version
    result.server_log = server.host_log()
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


def _make_cohort_engine(cfg, client_datasets, spec, sim: SimConfig, device,
                        *, prox: float = 0.0, align: float = 0.0):
    """The wave-training engine over the monolithic data slab, placed on
    the run's device once."""
    stacked = StackedClients.from_datasets(client_datasets)
    return CohortEngine(cfg, stacked, spec, local_epochs=sim.local_epochs,
                        batch_size=sim.batch_size, prox=prox, align=align,
                        member_kernel=sim.member_kernel, device=device)


def _gather_snapshots(snaps) -> torch.Tensor:
    """Stack dispatch snapshots into (B, d). Entries are (d,) global
    vectors or ``(rows, i)`` references into a previous flush's
    ``receive_many`` snapshot list."""
    return torch.stack([s[0][s[1]] if isinstance(s, tuple) else s
                        for s in snaps])


def _drain_cohort(server, cfg, client_datasets, sim: SimConfig,
                  dispatch_many, timeline, evaluate, result: SimResult,
                  data_sizes, align, sketch_rows, receive_hook, digest_fn,
                  device) -> float:
    """Batched drain: train completion waves as single device batches;
    ``sketch_rows`` (fedpsa) sketches a wave's (B, d) client models in one
    call.

    A wave is the maximal timeline prefix with ``t_done < t_first +
    latency_lo`` (capped at ``sim.max_cohort``). Any dispatch issued while
    the wave is being received completes no earlier than ``t_first +
    latency_lo`` — and at an equal timestamp sorts after the wave by
    ``seq`` — so training the wave up front observes exactly the
    snapshots, learning rates and seeds the sequential engine would have
    used.
    """
    spec = server.policy.spec
    engine = _make_cohort_engine(cfg, client_datasets, spec, sim, device,
                                 align=align)

    next_eval = 0.0
    t = 0.0
    while timeline and t < sim.horizon:
        first = timeline.pop()
        if first.t_done > sim.horizon:
            t = first.t_done       # mirror the sequential pop-then-break
            break
        bound = first.t_done + sim.latency_lo
        wave = [first]
        t_over = None
        while (timeline and timeline.head_t() < bound
               and len(wave) < sim.max_cohort):
            ev = timeline.pop()
            if ev.t_done > sim.horizon:
                t_over = ev.t_done  # discarded, like the sequential break
                break
            wave.append(ev)

        ok_events = [ev for ev in wave if ev.ok]
        deltas = w_stack = sketches = None
        if ok_events:
            d0 = result.dispatches
            snapshots = _gather_snapshots([ev.snapshot for ev in ok_events])
            cids = [ev.cid for ev in ok_events]
            lrs = [sim.lr * (sim.lr_decay ** (d0 + r))
                   for r in range(len(ok_events))]
            seeds = [sim.seed * 100003 + (d0 + r)
                     for r in range(len(ok_events))]
            deltas, w_stack = engine.cohort_update(snapshots, cids, lrs, seeds)
            if sketch_rows is not None:
                sketches = sketch_rows(w_stack)
            result.cohorts += 1

        # Receives are deferred into ``pending`` and flushed as one batched
        # ingest (``receive_many``) — early only when an eval boundary needs
        # the intermediate global model, or per event when a receive_hook
        # must observe pre-receive server state. Replacement dispatches
        # happen inside the flush, each snapshotting the global vector as
        # of *its* event, so RNG order and snapshots match the sequential
        # engine exactly.
        pending = []
        next_row = 0

        def flush():
            nonlocal next_row
            if not pending:
                return
            ok = [ev for ev in pending if ev.ok]
            r0, r1 = next_row, next_row + len(ok)
            cur = server.flat_params   # pre-flush vector, for leading dropouts
            snaps = None
            upd = np.zeros((0,), bool)
            if ok:
                if receive_hook is not None:
                    ev = ok[0]
                    meta = {"tau": server.version - ev.version,
                            "client_id": ev.cid,
                            "data_size": float(data_sizes[ev.cid])}
                    if sketches is not None:
                        meta["sketch"] = sketches[r0]
                    receive_hook(server, spec.unflatten(w_stack[r0]),
                                 spec.unflatten(deltas[r0]), meta, ev.t_done)
                upd, taus, snaps = server.receive_many(
                    deltas[r0:r1], w_stack[r0:r1], [ev.cid for ev in ok],
                    [float(data_sizes[ev.cid]) for ev in ok],
                    [ev.version for ev in ok],
                    None if sketches is None else sketches[r0:r1])
                if digest_fn is not None:
                    rows = torch.stack(snaps).cpu().numpy()
                    result.digests.extend(digest_fn(rows).tolist())
                for ev, tau in zip(ok, taus):
                    result.receive_log.append(
                        {"t": ev.t_done, "tau": tau, "client": ev.cid})
                result.dispatches += len(ok)
                next_row = r1
            vcur = server.version - int(np.sum(upd))  # version pre-flush
            oi = 0
            # replacement dispatches as one timeline run; each snapshots
            # the global vector as of *its* event (snaps rows)
            ts_, snaps_, vers_ = [], [], []
            for ev in pending:
                if ev.ok:
                    cur = (snaps, oi)
                    vcur += int(upd[oi])
                    oi += 1
                else:
                    result.dropped += 1
                ts_.append(ev.t_done)
                snaps_.append(cur)
                vers_.append(vcur)
            dispatch_many(ts_, snaps_, vers_)
            pending.clear()

        for ev in wave:
            t = ev.t_done
            if next_eval <= t:
                flush()
                while next_eval <= t:
                    acc = evaluate(server.params)
                    result.times.append(next_eval)
                    result.accuracies.append(acc)
                    next_eval += sim.eval_every
            pending.append(ev)
            if receive_hook is not None:
                flush()
        flush()
        if t_over is not None:
            t = t_over
            break
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
