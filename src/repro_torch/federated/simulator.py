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
the policy, e.g. asyncfeded's ``metric=``), with checkpoint/resume
(``SimConfig.checkpoint_dir``/``checkpoint_every``/``resume``). Beside
``run_async``: ``run_fedavg`` (synchronous FedAvg, both engines, with
``prox``) and ``run_sweep`` (S lanes of one async policy over one shared
event timeline, on the cohort engine). Runs on ``SimConfig.device`` —
the CUDA card by default, where the kernels launch: ``buffer_agg`` for
each buffered apply (every receive under fedfa; once per lane in a
sweep), ``sens_sketch`` for FedPSA's sketches and asyncfeded's
``metric="sketch"``, and ``grouped_matmul`` under
``member_kernel="grouped"``; ``device="cpu"`` runs their plain versions.

Client sources: a list of ``ClientDataset``s, or a lazy population
(``data.synthetic.SyntheticPopulation``: ``sizes``, ``member_rows`` and
``__getitem__``, never stacked). A population, or ``SimConfig.shard_size >
0``, runs the cohort engine over streamed client shards
(``data.loader.ClientSlabStore`` behind ``cohort.StreamingCohortEngine``,
with ``shard_cache``, ``shard_promote`` and ``prefetch``); the sequential
engine takes a population's clients through ``__getitem__``.

With ``SimConfig.mesh`` (a one-axis ``DeviceMesh``,
``launch.mesh.make_fed_mesh``; one process a rank, every rank running the
same run) the policy server shards its state over the mesh
(``servers.ShardedPolicyServer``) and the cohort engine trains waves
data-parallel, in ``run_async`` and ``run_fedavg``; ``SimConfig.rules``
maps the ``param_shard`` and ``cohort`` logical axes onto the mesh. Every
rank evaluates and logs the same values; rank 0 alone writes checkpoints.
Streaming client shards and ``run_sweep`` stay single-device, as in the
reference, and raise ``ValueError`` with a mesh. No path falls back to
another.

Token families (``data_kind == "tokens"``: federated LM fine-tuning,
``configs.fed_lm``) run on the runners the image models run on. The dense
LM is held to the reference on every one of them: ``run_async`` on both
engines, over the monolithic slab or streamed client shards,
``run_sweep``'s lanes and the mesh, with ``flash_attention`` and its
backward kernel in every local step, evaluation and FedPSA sketch; the
moe, ssm and hybrid families on ``run_async``'s two engines
(``fed-lm-moe-smoke``, ``fed-lm-ssm-smoke``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common import sharding, trace
from repro_torch.common.device import setup_device
from repro_torch.common.tree import FlatSpec, tree_leaves, tree_map
from repro_torch.core import psa as psa_lib
from repro_torch.data.loader import (ClientDataset, ClientSlabStore,
                                     StackedClients)
from repro_torch.federated import client as client_lib
from repro_torch.federated import policies as pol
from repro_torch.federated import servers as servers_lib
from repro_torch.federated.cohort import CohortEngine, StreamingCohortEngine
from repro_torch.federated.latency import STREAM_SYNC_CHOICE, _subseed
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
    # Streaming client slabs (population scale): ``shard_size > 0`` switches
    # the cohort engine from the monolithic device slab to
    # ``data.loader.ClientSlabStore`` — fixed-size client shards uploaded
    # per wave behind a bounded LRU, so resident client data is
    # O(shard_cache * shard_size * n_max), independent of C. A lazy
    # population (not a list) streams too (auto shard size when 0).
    shard_size: int = 0                # clients per shard; 0 = monolithic
    shard_cache: int = 32              # max resident shards (LRU)
    shard_promote: int = 8             # cache a shard once a wave wants
    #                                    this many of its clients
    # Prefetch (streaming engine only): right after a wave's replacement
    # dispatches are inserted, the next wave's members are read off the
    # timeline (``Timeline.peek_wave_cids``) and their shards and rows are
    # materialized and copied to the card on the store's worker thread and
    # side stream (copies only), overlapping the device's work. Rows are a
    # pure function of the client id, so results are bit-identical with
    # prefetch on or off.
    prefetch: bool = False
    # Periodic snapshots (checkpoint.store layout): every
    # ``checkpoint_every`` virtual-time units the run persists the server
    # state, the host RNG streams, the in-flight events with their dispatch
    # snapshots, and the metric/digest streams under ``checkpoint_dir``;
    # ``resume=True`` restores the latest snapshot and reproduces the rest
    # of the run exactly. Single runs only (sweeps are not checkpointed).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: float = 0.0
    resume: bool = False
    # Layout: with a mesh (torch DeviceMesh, launch.mesh.make_fed_mesh),
    # the policy server shards ServerState over the mesh's flat-parameter
    # axis (servers.ShardedPolicyServer) and the cohort engine trains waves
    # data-parallel over the client axis; rules (common.sharding.
    # LogicalRules, default FEDERATED_RULES) map the param_shard and cohort
    # logical axes onto mesh axes. None = single-device layout.
    mesh: Optional[object] = None
    rules: Optional[sharding.LogicalRules] = None
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
    local_steps: int = 0              # local SGD steps this process ran (a
    #                                   cohort wave's step counts once)
    member_steps_run: int = 0         # the cohort engine's member-steps,
    member_steps_live: int = 0        # and those of real members on real
    #                                   batches (CohortEngine's counters)
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


def _resolve_engine(sim: SimConfig, cfg: ModelConfig) -> str:
    """Validate ``sim.engine`` for ``cfg``. A family the registry does not
    hold raises; the port never falls back to another engine."""
    if sim.engine not in ENGINES:
        raise ValueError(f"unknown engine {sim.engine!r}; known: {ENGINES}")
    registry.get_family(cfg)
    return sim.engine


def _calib_on(fam, calib_batch: dict, device) -> dict:
    """The calibration batch on ``device`` in the family's batch keys."""
    return fam.batch_fn(*(calib_batch[k] for k in fam.keys), device)


def _eval_batches(cfg: ModelConfig, test_ds, sim: SimConfig, device):
    """The ``eval_batches`` fixed test batches (the reference's
    ``RandomState(1234)`` draw), held on ``device``."""
    fam = registry.get_family(cfg)
    rng = np.random.RandomState(1234)
    n = len(test_ds)
    bs = min(sim.eval_batch_size, n)
    idxs = [rng.choice(n, size=bs, replace=False) for _ in range(sim.eval_batches)]
    return fam, [fam.batch_fn(test_ds.x[ix], test_ds.y[ix], device)
                 for ix in idxs]


def _build_eval(cfg: ModelConfig, test_ds, sim: SimConfig, device):
    """params tree -> accuracy over the fixed test batches."""
    fam, batches = _eval_batches(cfg, test_ds, sim, device)

    def evaluate(params) -> float:
        with trace.span("eval"), torch.no_grad():
            accs = torch.stack([fam.eval_accuracy(params, b, cfg)
                                for b in batches])
            return float(np.mean(accs.cpu().numpy().astype(np.float64)))

    return evaluate


def _build_eval_lanes(cfg: ModelConfig, test_ds, sim: SimConfig,
                      spec: FlatSpec, device):
    """(S, d) flat lane models -> (S,) accuracies on ``_build_eval``'s
    batches, each lane's as the standalone run's."""
    fam, batches = _eval_batches(cfg, test_ds, sim, device)

    def evaluate(flat_stack) -> np.ndarray:
        with trace.span("eval"), torch.no_grad():
            accs = torch.stack([torch.stack([
                fam.eval_accuracy(spec.unflatten(row), b, cfg)
                for b in batches]) for row in flat_stack])
            return np.mean(accs.cpu().numpy().astype(np.float64), axis=1)

    return evaluate


def make_sketch_fn(cfg: ModelConfig, calib_batch: dict,
                   psa_cfg: psa_lib.PSAConfig, device="cpu") -> Callable:
    """params tree -> (k,) FedPSA client sketch on the calibration batch
    (one ``sens_sketch`` launch per tree)."""
    calib = _calib_on(registry.get_family(cfg), calib_batch, device)

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
    calib = _calib_on(fam, calib_batch, device)
    xk, yk = fam.keys

    def member_loss(params, batch):
        B, x, y = tree_leaves(params)[0].shape[0], batch[xk], batch[yk]
        n = x.shape[0]
        vm = torch.ones((B, n), dtype=torch.float32, device=x.device)
        cnt = torch.full((B,), float(n), dtype=torch.float32, device=x.device)
        return fam.client_loss(params, fam.masked_batch(
            x.expand(B, *x.shape), y.expand(B, *y.shape), vm, cnt), cfg,
            members=True)

    def fn(w_stack):
        return psa_lib.client_sketch_members(member_loss, spec, w_stack, calib,
                                             psa_cfg)

    return fn


def make_sketch_fn_lanes(cfg: ModelConfig, calib_batch: dict,
                         psa_cfg: psa_lib.PSAConfig, spec: FlatSpec,
                         device="cpu") -> Callable:
    """(S, B, d) lane stacks of flat client models -> (S, B, k) sketches:
    ``make_sketch_fn_flat`` over the S*B rows, one ``sens_sketch`` launch a
    wave for every lane (the reference's nested ``vmap`` of
    ``client_sketch``)."""
    flat = make_sketch_fn_flat(cfg, calib_batch, psa_cfg, spec, device)

    def fn(w_lanes):
        S, B = int(w_lanes.shape[0]), int(w_lanes.shape[1])
        return flat(w_lanes.reshape(S * B, -1)).view(S, B, -1)

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


# ---------------------------------------------------------------------------
# Checkpoints (SimConfig.checkpoint_dir / checkpoint_every / resume)
# ---------------------------------------------------------------------------
# A snapshot is taken at a wave boundary (all receives applied): the server
# state (``policies.state_arrays``), the three host RNG streams (dispatch,
# latency jitter, availability), the in-flight events with their dispatch
# snapshots as one (n, d) stack, and the metric, digest and receive-log
# streams: enough to restore mid-run and reproduce the rest of the run
# exactly. Every draw of a run comes from these numpy streams (client batch
# shuffles are seeded per dispatch), so no torch RNG state is saved. The
# policy's per-update log is not persisted: a resumed run's covers only
# the part after the resume.

def _rng_pack(rng: np.random.RandomState) -> dict:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    assert kind == "MT19937"
    return {"keys": np.asarray(keys, np.uint32),
            "pos": np.int64(pos), "has_gauss": np.int64(has_gauss),
            "cached": np.float64(cached)}


def _rng_unpack(rng: np.random.RandomState, packed: dict) -> None:
    rng.set_state(("MT19937", np.asarray(packed["keys"], np.uint32),
                   int(packed["pos"]), int(packed["has_gauss"]),
                   float(packed["cached"])))


def _event_snapshot_vec(ev, spec: FlatSpec) -> torch.Tensor:
    """One in-flight event's dispatch snapshot as a flat (d,) tensor: a
    ``(rows, i)`` reference of the cohort engine resolved, a params tree
    of the sequential engine flattened."""
    s = ev.snapshot
    if isinstance(s, tuple):
        return s[0][s[1]]
    if isinstance(s, torch.Tensor):
        return s
    return spec.flatten(s)


_RNG_KEYS = ("keys", "pos", "has_gauss", "cached")
_EVENT_KEYS = ("t_done", "seq", "cid", "version", "ok", "snapshots")


def _ckpt_save(sim: SimConfig, server, streams, timeline, scheduler,
               result: SimResult, t: float, next_eval: float,
               seq: int) -> str:
    spec = server.policy.spec
    events = timeline.events()
    tree = {
        "server": server.state_arrays(),
        "events": {
            "t_done": np.asarray([e.t_done for e in events], np.float64),
            "seq": np.asarray([e.seq for e in events], np.int64),
            "cid": np.asarray([e.cid for e in events], np.int64),
            "version": np.asarray([e.version for e in events], np.int64),
            "ok": np.asarray([e.ok for e in events], bool),
            "snapshots": torch.stack([_event_snapshot_vec(e, spec)
                                      for e in events]),
        },
        "rng": _rng_pack(streams.rng),
        "lat_rng": _rng_pack(streams.latency.rng),
        "avail_rng": _rng_pack(streams.avail_rng),
        "counters": np.asarray(
            [t, next_eval, seq, result.dispatches, result.launched,
             result.dropped, result.cohorts, server.version], np.float64),
        "times": np.asarray(result.times, np.float64),
        "accuracies": np.asarray(result.accuracies, np.float64),
        "digests": np.asarray(result.digests, np.float64).reshape(-1, 2),
        "receive_log": {
            "t": np.asarray([r["t"] for r in result.receive_log], np.float64),
            "tau": np.asarray([r["tau"] for r in result.receive_log],
                              np.int64),
            "client": np.asarray([r["client"] for r in result.receive_log],
                                 np.int64),
        },
    }
    if sched := scheduler.state_arrays():
        tree["scheduler"] = sched
    if sharding.writes(sim.mesh):
        store.save_pytree(tree, sim.checkpoint_dir, step=result.dispatches)


def _ckpt_like(server, scheduler) -> dict:
    """The structure ``store.load_pytree`` restores into (names only)."""
    z = np.zeros((0,))
    tree = {
        "server": {k: z for k in pol.state_array_names(server.state)},
        "events": {k: z for k in _EVENT_KEYS},
        "rng": {k: z for k in _RNG_KEYS},
        "lat_rng": {k: z for k in _RNG_KEYS},
        "avail_rng": {k: z for k in _RNG_KEYS},
        "counters": z, "times": z, "accuracies": z, "digests": z,
        "receive_log": {k: z for k in ("t", "tau", "client")},
    }
    if sched := scheduler.state_arrays():
        tree["scheduler"] = {k: z for k in sched}
    return tree


def _ckpt_restore(sim: SimConfig, server, streams, timeline, scheduler,
                  result: SimResult, batched: bool, device):
    """Restore the latest snapshot under ``sim.checkpoint_dir`` into the
    live run and return ``(t, next_eval, seq)``, or None when there is no
    snapshot (the run then starts fresh). The events' snapshots become
    ``(rows, i)`` references into one (n, d) device tensor on the cohort
    engine and params trees (views of its rows) on the sequential one.
    Under a mesh every rank reads the unpadded state rank 0 wrote (after
    every rank has reached this point, so after rank 0's last write) and
    takes its shard of it."""
    if server.axis is not None:
        sharding.host_barrier(server.axis, device)
    step = store.latest_step(sim.checkpoint_dir)
    if step is None:
        return None
    tree = store.load_pytree(sim.checkpoint_dir, _ckpt_like(server, scheduler),
                             step)
    if "scheduler" in tree:
        scheduler.load_state_arrays(tree["scheduler"])
    server.load_state_arrays(tree["server"])
    _rng_unpack(streams.rng, tree["rng"])
    _rng_unpack(streams.latency.rng, tree["lat_rng"])
    _rng_unpack(streams.avail_rng, tree["avail_rng"])
    (t, next_eval, seq, dispatches, launched, dropped, cohorts,
     version) = (float(v) for v in tree["counters"])
    if int(version) != server.version:
        raise ValueError(f"checkpoint step {step} under "
                         f"{sim.checkpoint_dir!r}: counters at version "
                         f"{int(version)}, server state at {server.version}")
    ev = tree["events"]
    snaps = torch.tensor(ev["snapshots"], dtype=torch.float32, device=device)
    spec = server.policy.spec
    timeline.clear()
    refs = [(snaps, i) if batched else spec.unflatten(snaps[i])
            for i in range(len(ev["seq"]))]
    timeline.extend_arrays(ev["t_done"], ev["seq"], ev["cid"],
                           ev["version"], ev["ok"], refs)
    result.dispatches = int(dispatches)
    result.launched = int(launched)
    result.dropped = int(dropped)
    result.cohorts = int(cohorts)
    result.times = [float(x) for x in tree["times"]]
    result.accuracies = [float(x) for x in tree["accuracies"]]
    result.digests = [[float(x) for x in row] for row in tree["digests"]]
    rl = tree["receive_log"]
    result.receive_log = [
        {"t": float(rl["t"][i]), "tau": int(rl["tau"][i]),
         "client": int(rl["client"][i])} for i in range(len(rl["t"]))]
    return t, next_eval, int(seq)


def _fedpsa_sketch(server_name: str, cfg: ModelConfig, calib_batch,
                   psa_cfg, device):
    """``(psa_cfg, the one-tree sketch function)`` of a FedPSA run, and
    ``(psa_cfg, None)`` for the other policies."""
    if server_name != "fedpsa":
        return psa_cfg, None
    if calib_batch is None:
        raise ValueError("fedpsa needs calib_batch")
    psa_cfg = psa_cfg or psa_lib.PSAConfig()
    return psa_cfg, make_sketch_fn(cfg, calib_batch, psa_cfg, device)


def _concurrency(sim: SimConfig) -> int:
    """Clients in flight at once (the clients of a FedAvg round)."""
    return max(1, int(round(sim.concurrency * sim.num_clients)))


def _dispatcher(sim: SimConfig, streams, scheduler, server, result,
                client_datasets, batched: bool):
    """``(timeline, data_sizes, Dispatcher)`` of an async run or a sweep
    (whose batched dispatcher snapshots the (S, d) lane stack; the RNG
    streams are a standalone run's, so is its timeline)."""
    timeline = Timeline()
    data_sizes = _data_sizes(client_datasets)
    return timeline, data_sizes, Dispatcher(
        sim, streams, scheduler, timeline, server, result, batched=batched,
        data_sizes=data_sizes)


def run_async(server_name: str, cfg: ModelConfig, init_params,
              client_datasets: List[ClientDataset], test_ds,
              sim: SimConfig, *, psa_cfg: Optional[psa_lib.PSAConfig] = None,
              calib_batch: Optional[dict] = None,
              server_kwargs: Optional[dict] = None,
              receive_hook: Optional[Callable] = None) -> SimResult:
    """Run one asynchronous algorithm to the virtual-time horizon."""
    with trace.span("setup"):
        engine = _resolve_engine(sim, cfg)
        batched = engine == "cohort"
        streams = make_streams(sim)
        scheduler = make_scheduler(sim)
        if sim.checkpoint_dir and not scheduler.checkpointable:
            raise ValueError(
                f"scheduler {scheduler.name!r} keeps host-side state beyond "
                f"its RNG and does not implement the state_arrays checkpoint "
                f"round-trip; drop checkpoint_dir or use a checkpointable "
                f"scheduler")
        device = setup_device(sim.device)
        params = tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float32, device=device), init_params)
        psa_cfg, sketch_fn = _fedpsa_sketch(server_name, cfg, calib_batch,
                                            psa_cfg, device)
        server = servers_lib.make_server(
            server_name, params, num_clients=sim.num_clients,
            psa_cfg=psa_cfg, sketch_fn=sketch_fn, mesh=sim.mesh,
            rules=sim.rules, **(server_kwargs or {}))
        digest_fn = (make_digest_fn(server.policy.spec.size)
                     if sim.record_trajectory else None)
        evaluate = _build_eval(cfg, test_ds, sim, device)
        result = SimResult(engine=engine)
        timeline, data_sizes, dispatcher = _dispatcher(
            sim, streams, scheduler, server, result, client_datasets,
            batched)
        t0 = next_eval0 = 0.0
        resumed = None
        if sim.checkpoint_dir and sim.resume:
            resumed = _ckpt_restore(sim, server, streams, timeline,
                                    scheduler, result, batched, device)
        if resumed is None:
            dispatcher.dispatch_many(np.zeros(_concurrency(sim)))
        else:
            t0, next_eval0, dispatcher.seq = resumed

        ckpt = None
        if sim.checkpoint_dir and sim.checkpoint_every > 0:
            nxt = [(np.floor(t0 / sim.checkpoint_every) + 1)
                   * sim.checkpoint_every]

            def ckpt(timeline_, t_, next_eval_):
                if t_ < nxt[0]:
                    return
                _ckpt_save(sim, server, streams, timeline_, scheduler,
                           result, t_, next_eval_, dispatcher.seq)
                while nxt[0] <= t_:
                    nxt[0] += sim.checkpoint_every

        start = dict(t0=t0, next_eval0=next_eval0, ckpt=ckpt)
        sketch_rows = (make_sketch_fn_flat(cfg, calib_batch, psa_cfg,
                                           server.policy.spec, device)
                       if batched and server.needs_sketch else None)
    with trace.span("loop"):
        if batched:
            t = _drain_cohort(server, cfg, client_datasets, sim,
                              dispatcher.dispatch_many, timeline, evaluate,
                              result, data_sizes, sketch_rows, digest_fn,
                              device, receive_hook=receive_hook, **start)
        else:
            t = _drain_sequential(server, cfg, client_datasets, sim,
                                  dispatcher.dispatch, timeline, evaluate,
                                  result, data_sizes, server.client_align,
                                  sketch_fn, receive_hook, digest_fn, **start)
    result.final_accuracy = evaluate(server.params)
    result.times.append(min(t, sim.horizon))
    result.accuracies.append(result.final_accuracy)
    result.versions = server.version
    result.server_log = server.host_log()
    return result


def _drain_sequential(server, cfg, client_datasets, sim: SimConfig, dispatch,
                      timeline, evaluate, result: SimResult, data_sizes,
                      align, sketch_fn, receive_hook, digest_fn=None, *,
                      t0: float = 0.0, next_eval0: float = 0.0,
                      ckpt=None) -> float:
    """The reference loop: one local_update per completion."""
    next_eval = next_eval0
    t = t0
    while timeline and t < sim.horizon:
        if ckpt is not None:
            ckpt(timeline, t, next_eval)
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
            with trace.span("redispatch"):
                dispatch(t)
            continue
        lr = sim.lr * (sim.lr_decay ** result.dispatches)
        with trace.span("train"):
            delta, w_client = client_lib.local_update(
                ev.snapshot, cfg, client_datasets[ev.cid],
                epochs=sim.local_epochs, batch_size=sim.batch_size, lr=lr,
                seed=sim.seed * 100003 + result.dispatches, align=align)
        n = int(data_sizes[ev.cid])
        result.local_steps += sim.local_epochs * (n // min(sim.batch_size, n))
        meta = {
            "tau": server.version - ev.version,
            "client_id": ev.cid,
            "data_size": float(data_sizes[ev.cid]),
        }
        if server.needs_sketch:
            with trace.span("sketch"):
                meta["sketch"] = sketch_fn(w_client)
        if receive_hook is not None:
            receive_hook(server, w_client, delta, meta, t)
        with trace.span("receive"):
            server.receive(delta, w_client, meta)
        if digest_fn is not None:
            row = server.flat_params.cpu().numpy()[None, :]
            result.digests.append(digest_fn(row)[0].tolist())
        result.dispatches += 1
        result.receive_log.append({"t": t, "tau": meta["tau"], "client": ev.cid})
        with trace.span("redispatch"):
            dispatch(t)
    return t


def _data_sizes(client_datasets) -> np.ndarray:
    """(C,) per-client sample counts — reading ``.sizes`` when the client
    source is a lazy population (no per-client dataset objects to len())."""
    sizes = getattr(client_datasets, "sizes", None)
    if sizes is not None:
        return np.asarray(sizes, np.float64)
    return np.array([len(d) for d in client_datasets], np.float64)


def _wants_streaming(sim: SimConfig, client_datasets) -> bool:
    """The streaming slab path: explicitly via ``sim.shard_size > 0``, or
    implicitly when the client source is a lazy population object rather
    than a list of materialized ``ClientDataset``s."""
    return sim.shard_size > 0 or not isinstance(client_datasets, (list, tuple))


def _make_cohort_engine(cfg, client_datasets, spec, sim: SimConfig, device,
                        *, prox: float = 0.0, align: float = 0.0):
    """The wave-training engine, placed on the run's device: over the
    monolithic data slab by default, over streamed client shards when
    configured (see ``SimConfig.shard_size``)."""
    kw = dict(local_epochs=sim.local_epochs, batch_size=sim.batch_size,
              prox=prox, align=align, member_kernel=sim.member_kernel,
              device=device)
    if _wants_streaming(sim, client_datasets):
        if sim.mesh is not None:
            raise ValueError("streaming client slabs are single-device; "
                             "drop SimConfig.mesh or shard_size")
        store = ClientSlabStore.build(
            client_datasets, shard_size=sim.shard_size,
            cache_shards=sim.shard_cache, promote=sim.shard_promote,
            device=device)
        return StreamingCohortEngine(cfg, store, spec, **kw)
    stacked = StackedClients.from_datasets(client_datasets)
    return CohortEngine(cfg, stacked, spec, mesh=sim.mesh, rules=sim.rules,
                        **kw)


def _gather_snapshots(snaps) -> torch.Tensor:
    """Stack dispatch snapshots into (B, d). Entries are (d,) global
    vectors or ``(rows, i)`` references into a previous flush's
    ``receive_many`` snapshot list (or a restored (n, d) tensor)."""
    return torch.stack([s[0][s[1]] if isinstance(s, tuple) else s
                        for s in snaps])


def _gather_snapshots_lanes(snaps) -> torch.Tensor:
    """Lane-stacked ``_gather_snapshots``: entries are ``(S, d)`` stacks or
    ``(rows (S, n, d), i)`` references into a previous flush's snapshots.
    Returns ``(S, B, d)``."""
    return torch.stack([s[0][:, s[1]] if isinstance(s, tuple) else s
                        for s in snaps], dim=1)


def _pop_wave(timeline, sim: SimConfig):
    """Pop the next wave: the maximal timeline prefix with ``t_done <
    t_first + latency_lo``, capped at ``sim.max_cohort``. Returns ``(wave,
    t_over)``: ``t_over`` is the ``t_done`` of an event past the horizon
    that ends the run (popped and discarded, like the sequential engine's
    pop-then-break); the wave is empty when the first event is past it."""
    first = timeline.pop()
    if first.t_done > sim.horizon:
        return [], first.t_done
    bound = first.t_done + sim.latency_lo
    wave = [first]
    while (timeline and timeline.head_t() < bound
           and len(wave) < sim.max_cohort):
        ev = timeline.pop()
        if ev.t_done > sim.horizon:
            return wave, ev.t_done
        wave.append(ev)
    return wave, None


def _redispatch(pending, cur, snaps, upd, version: int, result,
                dispatch_many) -> None:
    """The replacement dispatches of a flush as one timeline run: each
    snapshots the global model as of *its* event (``(snaps, row)`` after
    the event's receive, ``cur`` before the first), at its version."""
    vcur = version - int(np.sum(upd))  # version before the flush
    oi = 0
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
    with trace.span("redispatch"):
        dispatch_many(ts_, snaps_, vers_)
    pending.clear()


def _drain_cohort(server, cfg, client_datasets, sim: SimConfig,
                  dispatch_many, timeline, evaluate, result, data_sizes,
                  sketch_rows, digest_fn, device, *, data_seeds=None,
                  receive_hook=None, t0: float = 0.0, next_eval0: float = 0.0,
                  ckpt=None) -> float:
    """Batched drain: train completion waves (``_pop_wave``) as single
    device batches; ``sketch_rows`` (fedpsa) sketches a wave's client
    models in one call.

    Any dispatch issued while a wave is being received completes no
    earlier than ``t_first + latency_lo`` — and at an equal timestamp sorts
    after the wave by ``seq`` — so training the wave up front observes
    exactly the snapshots, learning rates and seeds the sequential engine
    would have used.

    A sweep (``data_seeds``, one per lane; ``server`` a
    ``LanePolicyServer``, ``result`` a ``SweepResult``) runs the same waves
    and flushes — the timeline is lane-invariant — with a lane axis on
    every tensor: the (S, B, d) snapshot stack trains as one wave
    (``CohortEngine.sweep_update``), each lane's seeds from its data seed,
    ``evaluate`` takes the (S, d) lane stack and ``sketch_rows`` the (S,
    B, d) client models (``make_sketch_fn_lanes``). A single run's
    ``evaluate`` takes the params tree, its ``sketch_rows`` (B, d) rows
    (``make_sketch_fn_flat``).
    """
    spec = server.policy.spec
    with trace.span("setup"):
        engine = _make_cohort_engine(cfg, client_datasets, spec, sim, device,
                                     align=server.client_align)
    # prefetch has a target on the streaming engine only (the monolithic
    # slab is device-resident already)
    store = getattr(engine, "store", None)
    prefetch_store = store if sim.prefetch else None
    lanes = data_seeds is not None
    if lanes:
        seed_base = np.asarray([int(s) * 100003 for s in data_seeds],
                               np.int64)[:, None]
        gather, train = _gather_snapshots_lanes, engine.sweep_update
        lane_accs, lane_digests = result.lane_accuracies, result.digests
    else:
        seed_base = np.int64(sim.seed * 100003)
        gather, train = _gather_snapshots, engine.cohort_update
        lane_accs, lane_digests = [result.accuracies], [result.digests]

    try:
        next_eval = next_eval0
        t = t0
        while timeline and t < sim.horizon:
            if ckpt is not None:
                ckpt(timeline, t, next_eval)
            wave, t_over = _pop_wave(timeline, sim)
            if not wave:
                t = t_over
                break

            ok_events = [ev for ev in wave if ev.ok]
            deltas = w_stack = sketches = None
            if ok_events:
                d0, B = result.dispatches, len(ok_events)
                lrs = [sim.lr * (sim.lr_decay ** (d0 + r)) for r in range(B)]
                seeds = seed_base + (d0 + np.arange(B, dtype=np.int64))
                with trace.span("train"):
                    deltas, w_stack = train(
                        gather([ev.snapshot for ev in ok_events]),
                        [ev.cid for ev in ok_events], lrs, seeds)
                if sketch_rows is not None:
                    with trace.span("sketch"):
                        sketches = engine.map_members(sketch_rows, w_stack)
                result.cohorts += 1

            # Receives are deferred into ``pending`` and flushed as one
            # batched ingest (``receive_many``) — early only when an eval
            # boundary needs the intermediate global model, or per event
            # when a receive_hook must observe pre-receive server state.
            # Replacement dispatches happen inside the flush, each
            # snapshotting the global vector as of *its* event, so RNG
            # order and snapshots match the sequential engine exactly.
            pending = []
            next_row = 0

            def flush():
                nonlocal next_row
                if not pending:
                    return
                ok = [ev for ev in pending if ev.ok]
                r0, r1 = next_row, next_row + len(ok)
                # the pre-flush vector, for leading dropouts
                cur = server.flat_params
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
                                     spec.unflatten(deltas[r0]), meta,
                                     ev.t_done)
                    with trace.span("receive"):
                        upd, taus, snaps = server.receive_many(
                            deltas[..., r0:r1, :], w_stack[..., r0:r1, :],
                            [ev.cid for ev in ok],
                            [float(data_sizes[ev.cid]) for ev in ok],
                            [ev.version for ev in ok],
                            None if sketches is None
                            else sketches[..., r0:r1, :])
                    if digest_fn is not None:
                        rows = (snaps if lanes else torch.stack(snaps)).cpu()
                        for out, r in zip(lane_digests,
                                          rows.reshape(-1, *rows.shape[-2:])):
                            out.extend(digest_fn(r.numpy()).tolist())
                    for ev, tau in zip(ok, taus):
                        result.receive_log.append(
                            {"t": ev.t_done, "tau": tau, "client": ev.cid})
                    result.dispatches += len(ok)
                    next_row = r1
                _redispatch(pending, cur, snaps, upd, server.version, result,
                            dispatch_many)

            for ev in wave:
                t = ev.t_done
                if next_eval <= t:
                    flush()
                    while next_eval <= t:
                        accs = (evaluate(server.flat_params) if lanes
                                else [evaluate(server.params)])
                        result.times.append(next_eval)
                        for out, acc in zip(lane_accs, accs):
                            out.append(float(acc))
                        next_eval += sim.eval_every
                pending.append(ev)
                if receive_hook is not None:
                    flush()
            flush()
            # the wave's replacements are inserted: the next wave's member
            # set is determined, so overlap its materialization and upload
            # with the device work still queued
            if prefetch_store is not None and t_over is None \
                    and t < sim.horizon:
                nxt = timeline.peek_wave_cids(sim.latency_lo,
                                              sim.max_cohort, sim.horizon)
                if nxt.size:
                    prefetch_store.prefetch(nxt)
            if t_over is not None:
                t = t_over
                break
        result.local_steps += engine.steps_run
        result.member_steps_run += engine.member_steps_run
        result.member_steps_live += engine.member_steps_live
        return t
    finally:
        if store is not None:
            store.close()


# ---------------------------------------------------------------------------
# Sweep lanes: S variants of one async policy over one shared timeline
# ---------------------------------------------------------------------------

@dataclass
class SweepConfig:
    """S experiment variants ("lanes") of one batched simulation.

    All lanes share one event timeline (``SimConfig.timeline_seed``,
    falling back to ``SimConfig.seed``): latency draws, client sampling,
    dropout, wave boundaries and version bookkeeping are the same in every
    lane. What may vary per lane:

    * ``model_seeds`` — per-lane model-init seeds (``init_params`` is used
      for every lane when None); a lane's weights are
      ``init_params(torch.Generator().manual_seed(seed), cfg)``,
    * ``data_seeds`` — per-lane client batch-shuffle seeds (``SimConfig
      .seed`` for every lane when None),
    * ``policy_params`` — per-lane dicts of timeline-preserving policy
      hyperparameters (``federated.policies.PolicyParams`` field names:
      alpha, a, server_lr, beta, gamma, delta, eps, use_thermometer,
      dist_mode — the asyncfeded l2/cosine metric, "l2"/"cosine" accepted).

    Shape-determining parameters (buffer_size, queue_len, sketch_k,
    num_clients) and the client sketch program (use_sensitivity) are
    structural: lanes share them (pass them via psa_cfg/server_kwargs).
    """
    num_lanes: Optional[int] = None
    model_seeds: Optional[List[int]] = None
    data_seeds: Optional[List[int]] = None
    policy_params: Optional[List[Optional[dict]]] = None

    def resolve(self, base_seed: int):
        given = [x for x in (self.model_seeds, self.data_seeds,
                             self.policy_params) if x is not None]
        lens = {len(x) for x in given}
        if self.num_lanes is not None:
            lens.add(int(self.num_lanes))
        if len(lens) > 1:
            raise ValueError(
                f"inconsistent lane counts in SweepConfig: {sorted(lens)}")
        S = lens.pop() if lens else 1
        if S < 1:
            raise ValueError("a sweep needs at least one lane")
        data_seeds = (list(self.data_seeds) if self.data_seeds is not None
                      else [base_seed] * S)
        hypers = (list(self.policy_params)
                  if self.policy_params is not None else [None] * S)
        model_seeds = (list(self.model_seeds)
                       if self.model_seeds is not None else None)
        return S, model_seeds, data_seeds, hypers


@dataclass
class SweepResult:
    """A batched ``SimResult``: shared timeline counters and per-lane
    streams. ``lane_accuracies[s]`` is lane s's learning curve over the
    shared ``times`` grid, ``digests[s]`` its per-receive digest stream
    (with ``record_trajectory``); ``lane(s)`` views one lane as a
    ``SimResult``."""
    num_lanes: int = 1
    times: List[float] = field(default_factory=list)
    lane_accuracies: List[List[float]] = field(default_factory=list)
    final_accuracy: List[float] = field(default_factory=list)
    versions: int = 0
    dispatches: int = 0
    launched: int = 0
    dropped: int = 0
    cohorts: int = 0
    local_steps: int = 0              # local SGD steps of the lanes' waves
    #                                   (a wave's step counts once)
    member_steps_run: int = 0         # as SimResult's
    member_steps_live: int = 0
    engine: str = "cohort"
    receive_log: List[dict] = field(default_factory=list)
    digests: List[List[List[float]]] = field(default_factory=list)

    def lane(self, s: int) -> SimResult:
        return SimResult(
            times=list(self.times), accuracies=list(self.lane_accuracies[s]),
            final_accuracy=self.final_accuracy[s], versions=self.versions,
            dispatches=self.dispatches, launched=self.launched,
            dropped=self.dropped, cohorts=self.cohorts,
            local_steps=self.local_steps,
            member_steps_run=self.member_steps_run,
            member_steps_live=self.member_steps_live, engine=self.engine,
            receive_log=list(self.receive_log),
            digests=[list(d) for d in self.digests[s]])

    @property
    def aulc(self) -> List[float]:
        return [self.lane(s).aulc for s in range(self.num_lanes)]

    def accuracy_mean_std(self):
        a = np.asarray(self.final_accuracy, np.float64)
        return float(a.mean()), float(a.std())


def run_sweep(server_name: str, cfg: ModelConfig, init_params,
              client_datasets: List[ClientDataset], test_ds,
              sim: SimConfig, sweep: SweepConfig, *,
              psa_cfg: Optional[psa_lib.PSAConfig] = None,
              calib_batch: Optional[dict] = None,
              server_kwargs: Optional[dict] = None) -> SweepResult:
    """Run S variants of one async algorithm as one batched simulation.

    One host event timeline drives every lane (see ``SweepConfig``); per
    wave the cohort engine trains the ``(S, B, d)`` snapshot stack as one
    wave of S*B members (``CohortEngine.sweep_update``), FedPSA sketches
    the S*B client models in one ``sens_sketch`` launch, and the lane
    server (``servers.LanePolicyServer``) ingests each lane's rows. Lane s
    reproduces the standalone run with ``SimConfig(seed=data_seeds[s],
    timeline_seed=<shared>)``, that lane's init and its hyper overrides,
    within the lane tolerance (rtol 1e-5, atol 1e-4 on the digests;
    ``tests/test_torch_sweep.py``, and ``chip_smoke.py`` at full width on
    the card). Bit for bit only where no op's rounding depends on the
    wave's width: FedPSA's sketch pass over S*B members runs through
    cuBLAS, which rounds differently at another width.
    """
    if server_name == "fedavg":
        raise ValueError("run_sweep batches the async policies; run the "
                         "synchronous fedavg per seed instead")
    if sim.mesh is not None:
        raise ValueError("run_sweep is single-device; drop SimConfig.mesh")
    if sim.checkpoint_dir:
        raise ValueError("checkpointing supports single runs, not sweeps")
    if _resolve_engine(sim, cfg) != "cohort":
        raise ValueError(
            "run_sweep requires the batched cohort engine (engine='cohort' "
            "and a registered model family)")
    S, model_seeds, data_seeds, lane_hypers = sweep.resolve(sim.seed)
    with trace.span("setup"):
        device = setup_device(sim.device)
        if model_seeds is not None:
            inits = [model_lib.init_params(
                torch.Generator().manual_seed(int(s)), cfg)
                for s in model_seeds]
        else:
            inits = [init_params] * S
        params_lanes = [tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float32, device=device), p) for p in inits]

        streams = make_streams(sim)
        scheduler = make_scheduler(sim)
        psa_cfg, sketch_fn = _fedpsa_sketch(server_name, cfg, calib_batch,
                                            psa_cfg, device)
        server = servers_lib.make_lane_server(
            server_name, params_lanes, lane_hypers,
            num_clients=sim.num_clients, psa_cfg=psa_cfg, sketch_fn=sketch_fn,
            **(server_kwargs or {}))
        spec = server.policy.spec
        digest_fn = (make_digest_fn(spec.size) if sim.record_trajectory
                     else None)
        evaluate = _build_eval_lanes(cfg, test_ds, sim, spec, device)
        result = SweepResult(num_lanes=S,
                             lane_accuracies=[[] for _ in range(S)],
                             digests=[[] for _ in range(S)])
        timeline, data_sizes, dispatcher = _dispatcher(
            sim, streams, scheduler, server, result, client_datasets, True)
        dispatcher.dispatch_many(np.zeros(_concurrency(sim)))
        sketch_lanes = (make_sketch_fn_lanes(cfg, calib_batch, psa_cfg, spec,
                                             device)
                        if server.needs_sketch else None)
    with trace.span("loop"):
        t = _drain_cohort(server, cfg, client_datasets, sim,
                          dispatcher.dispatch_many, timeline, evaluate,
                          result, data_sizes, sketch_lanes, digest_fn, device,
                          data_seeds=data_seeds)
    result.final_accuracy = [float(a) for a in evaluate(server.flat_params)]
    result.times.append(min(t, sim.horizon))
    for s in range(S):
        result.lane_accuracies[s].append(result.final_accuracy[s])
    result.versions = server.version
    return result


# ---------------------------------------------------------------------------
# Synchronous FedAvg
# ---------------------------------------------------------------------------

def run_fedavg(cfg: ModelConfig, init_params,
               client_datasets: List[ClientDataset], test_ds,
               sim: SimConfig, *, prox: float = 0.0) -> SimResult:
    """Synchronous FedAvg: per round sample ``concurrency`` of the clients
    (from their own ``STREAM_SYNC_CHOICE`` stream), wait for the slowest,
    and add the deltas weighted by client data size (FedProx with ``prox >
    0``). On the cohort engine a round trains as one wave from the flat
    global vector, and the apply is ``flat + w @ deltas``; with a mesh the
    wave trains data-parallel and every rank applies the gathered deltas."""
    engine = _resolve_engine(sim, cfg)
    batched = engine == "cohort"
    device = setup_device(sim.device)
    params = tree_map(lambda x: torch.as_tensor(x, dtype=torch.float32,
                                                device=device), init_params)
    streams = make_streams(sim)
    # round sampling has its own stream: the bare dispatch stream belongs
    # to the async schedulers
    choice_rng = np.random.RandomState(
        _subseed(streams.tseed, STREAM_SYNC_CHOICE))
    evaluate = _build_eval(cfg, test_ds, sim, device)
    result = SimResult(engine=engine)
    m = _concurrency(sim)
    data_sizes = _data_sizes(client_datasets)
    spec = FlatSpec(params)
    if batched:
        cohort = _make_cohort_engine(cfg, client_datasets, spec, sim, device,
                                     prox=prox)
        flat = spec.flatten(params)
    t = 0.0
    next_eval = 0.0
    rnd = 0
    while t < sim.horizon:
        while next_eval <= t:
            acc = evaluate(spec.unflatten(flat) if batched else params)
            result.times.append(next_eval)
            result.accuracies.append(acc)
            next_eval += sim.eval_every
        chosen = choice_rng.choice(sim.num_clients, size=m, replace=False)
        result.launched += len(chosen)
        round_time = float(streams.latency.sample_for(chosen).max())
        if streams.use_trace or streams.use_avail:
            ok = (streams.trace.on_at(chosen, np.full(m, t))
                  if streams.use_trace
                  else streams.avail_rng.rand(m) < streams.avail[chosen])
            result.dropped += int(np.sum(~ok))
            active = [int(c) for c, o in zip(chosen, ok) if o]
        else:
            active = [int(c) for c in chosen]
        lr = sim.lr * (sim.lr_decay ** rnd)
        if active:
            sizes = np.asarray([data_sizes[c] for c in active], np.float32)
            w = torch.from_numpy(sizes / np.sum(sizes)).to(device)
            seeds = [sim.seed * 100003 + rnd * 51 + c for c in active]
            if batched:
                deltas, _ = cohort.cohort_update(
                    flat.expand(len(active), -1), active,
                    [lr] * len(active), seeds)
                flat = flat + w @ deltas
                result.cohorts += 1
            else:
                deltas = [client_lib.local_update(
                    params, cfg, client_datasets[c], epochs=sim.local_epochs,
                    batch_size=sim.batch_size, lr=lr, seed=s, prox=prox)[0]
                    for c, s in zip(active, seeds)]
                params = tree_map(
                    lambda p, *ds: p + torch.sum(torch.stack(ds) * w.view(
                        (-1,) + (1,) * p.dim()), 0), params, *deltas)
        t += round_time
        rnd += 1
        result.dispatches += len(active)
    result.final_accuracy = evaluate(spec.unflatten(flat) if batched
                                     else params)
    result.times.append(min(t, sim.horizon))
    result.accuracies.append(result.final_accuracy)
    result.versions = rnd
    return result


ALGORITHMS = ("fedavg", "fedasync", "fedbuff", "fedpsa", "ca2fl", "fedfa",
              "fedpac", "asyncfeded")


def run_algorithm(name: str, cfg: ModelConfig, init_params, client_datasets,
                  test_ds, sim: SimConfig, **kw) -> SimResult:
    if name == "fedavg":
        kw.pop("psa_cfg", None)
        kw.pop("calib_batch", None)
        return run_fedavg(cfg, init_params, client_datasets, test_ds, sim, **kw)
    return run_async(name, cfg, init_params, client_datasets, test_ds, sim, **kw)
