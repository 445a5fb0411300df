"""Multi-rank runs of the port for its CPU tests: N gloo ranks, one process
each, over a ``file://`` rendezvous.

    results = run_ranks(2, "server_program", {}, tmp_dir)

(or ``Ranks(...)`` to start several jobs side by side, then each one's
``.results()``) starts ``python tests/torch_dist.py`` N times (one torch thread each),
joins the ranks into one gloo process group and a one-axis mesh
(``repro_torch.launch.mesh.make_fed_mesh``), calls the named program of
this module on every rank as ``program(mesh, **kwargs)`` and returns the
ranks' return values in rank order. A rank's exception is raised in the
caller with the rank's traceback; ranks that outlive ``timeout`` are
killed and the call fails. Each process group has a 60 s timeout, so a
collective that only some ranks reach fails instead of hanging.

A rank imports neither JAX nor a test module: the programs below use the
port alone, and the tests hold what they return against the reference.
The input builders (``server_params``, ``server_stream``) are shared, so
that both sides see the same numpy inputs.
"""
import datetime
import os
import pickle
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GROUP_TIMEOUT_S = 60


class Ranks:
    """``n`` ranks running ``program(mesh, **kwargs)``, started at once;
    ``results()`` waits for them. Several jobs may run side by side."""

    def __init__(self, n: int, program: str, kwargs: dict, tmp_dir):
        self.n, self.program, self.tmp = n, program, str(tmp_dir)
        with open(os.path.join(self.tmp, "job.pkl"), "wb") as fh:
            pickle.dump((program, kwargs), fh)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(n),
             self.tmp], env=env, start_new_session=True) for r in range(n)]

    def results(self, timeout: float = 240.0) -> list:
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{self.program} on {self.n} ranks: not done "
                               f"after {timeout:.0f}s") from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        for r, p in enumerate(self.procs):
            err = os.path.join(self.tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    raise RuntimeError(f"{self.program} rank {r} of {self.n} "
                                       f"failed:\n{fh.read()}")
            if p.returncode != 0:
                raise RuntimeError(f"{self.program} rank {r} of {self.n} "
                                   f"exited with {p.returncode}")
        out = []
        for r in range(self.n):
            with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def run_ranks(n: int, program: str, kwargs: dict, tmp_dir,
              timeout: float = 240.0) -> list:
    return Ranks(n, program, kwargs, tmp_dir).results(timeout)


def run_command(argv: list, env: dict, timeout: float):
    """``subprocess.run`` of ``argv`` in a session of its own, whose every
    process (a command that spawns ranks) is killed at ``timeout``."""
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{argv}: not done after {timeout:.0f}s") from None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def _rank_main(rank: int, n: int, tmp_dir: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fed_mesh
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp_dir, "job.pkl"), "rb") as fh:
            program, kwargs = pickle.load(fh)
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_dir}/rendezvous", rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = globals()[program](make_fed_mesh(n, device="cpu"),
                                        **kwargs)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        with open(os.path.join(tmp_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# Inputs both sides build: tests/test_sharded.py's parameter trees and
# arrival streams, in numpy
# ---------------------------------------------------------------------------

SKETCH_K = 8
NUM_CLIENTS = 5
PSA_CASE = dict(buffer_size=3, queue_len=5, sketch_k=SKETCH_K)
# id -> (policy, make_server keyword arguments); fedpsa adds PSA_CASE and
# a raw-parameter sketch (tests/test_sharded.py's), the same function on
# both sides
SERVER_CASES = {
    "fedasync": ("fedasync", {}),
    "asyncfeded": ("asyncfeded", {}),
    "asyncfeded-cosine": ("asyncfeded", {"metric": "cosine"}),
    "asyncfeded-sketch": ("asyncfeded", {"metric": "sketch"}),
    "fedbuff": ("fedbuff", {"buffer_size": 3}),
    "fedpac": ("fedpac", {"buffer_size": 3}),
    "ca2fl": ("ca2fl", {"buffer_size": 3, "num_clients": NUM_CLIENTS}),
    "fedfa": ("fedfa", {"queue_len": 4}),
    "fedpsa": ("fedpsa", {}),
}
RECEIVES = 13
MANY_B = 11      # receive_many's batch: 8 + 2 + 1 in the reference's chunks


def server_params(extra_bias: int = 0, seed: int = 0) -> dict:
    """d = 40 (+ extra_bias): with extra_bias = 1, d = 41 divides by no
    rank count, so the last shard holds padding."""
    rng = np.random.RandomState(seed)
    p = {"w1": (rng.randn(6, 4) * 0.3).astype(np.float32),
         "b1": (rng.randn(4) * 0.1).astype(np.float32),
         "w2": (rng.randn(4, 3) * 0.3).astype(np.float32)}
    if extra_bias:
        p["b2"] = (rng.randn(extra_bias) * 0.1).astype(np.float32)
    return p


def server_stream(params: dict, n: int, seed: int = 1, k=None) -> list:
    """(delta, client params, meta) triples, drawn as tests/test_sharded.py
    draws them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        delta = {key: (rng.randn(*v.shape) * 0.05).astype(np.float32)
                 for key, v in sorted(params.items())}
        client = {key: params[key] + delta[key] for key in params}
        meta = {"tau": int(rng.randint(0, 4)),
                "client_id": int(rng.randint(NUM_CLIENTS)),
                "data_size": float(rng.randint(5, 50))}
        if k is not None:
            meta["sketch"] = rng.randn(k).astype(np.float32)
        out.append((delta, client, meta))
    return out


def many_inputs(d: int) -> tuple:
    """receive_many's batch: (deltas (B, d), client ids, data sizes,
    dispatch versions, sketches (B, k)), drawn as tests/test_sharded.py
    draws them; the client rows are the flat init plus the deltas."""
    rng = np.random.RandomState(7)
    deltas = (rng.randn(MANY_B, d) * 0.05).astype(np.float32)
    cids = rng.randint(0, NUM_CLIENTS, size=MANY_B)
    sizes = rng.randint(5, 50, size=MANY_B).astype(float)
    vdisp = np.zeros(MANY_B, np.int64)
    sketches = rng.randn(MANY_B, SKETCH_K).astype(np.float32)
    return deltas, cids, sizes, vdisp, sketches


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------

def _port_server(case: str, params: dict, mesh, rules=None):
    import torch
    from repro_torch.core import sketch as tsk
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import servers
    name, kw = SERVER_CASES[case]
    kw = dict(kw)
    if name == "fedpsa":
        kw.update(psa_cfg=PSAConfig(**PSA_CASE), sketch_fn=lambda p:
                  tsk.sketch_tree(p, 42, SKETCH_K))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    return servers.make_server(name, tparams, mesh=mesh, rules=rules, **kw)


def server_program(mesh) -> dict:
    """The sharded server on every case: the flat global vector after each
    of ``RECEIVES`` receives at d = 40 and 41; ``receive_many`` of
    ``MANY_B`` rows at d = 41; the state's layout; a rules table that maps
    ``param_shard`` nowhere."""
    import torch
    from repro_torch.common import sharding
    from repro_torch.common.tree import FlatSpec
    from repro_torch.federated import policies as pol
    from repro_torch.federated.servers import ShardedPolicyServer

    def tree(t):
        return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}

    out = {"receive": {}, "receive_many": {}, "layout": {}}
    for case, (name, _) in SERVER_CASES.items():
        for bias in (0, 1):
            params = server_params(bias)
            srv = _port_server(case, params, mesh)
            if not isinstance(srv, ShardedPolicyServer):
                raise TypeError(type(srv).__name__)
            k = SKETCH_K if name == "fedpsa" else None
            flags, rows = [], []
            for delta, client, meta in server_stream(params, RECEIVES, k=k):
                if "sketch" in meta:
                    meta = {**meta, "sketch": torch.from_numpy(meta["sketch"])}
                flags.append(bool(srv.receive(tree(delta), tree(client),
                                              meta)))
                rows.append(srv.flat_params.numpy().copy())
            out["receive"][case, bias] = (flags, np.stack(rows), srv.version)

        params = server_params(1)
        srv = _port_server(case, params, mesh)
        spec = FlatSpec(tree(params))
        deltas, cids, sizes, vdisp, sketches = many_inputs(spec.size)
        w0 = spec.flatten(tree(params)).numpy()
        upd, taus, snaps = srv.receive_many(
            torch.from_numpy(deltas), torch.from_numpy(w0[None] + deltas),
            cids, sizes, vdisp,
            torch.from_numpy(sketches) if name == "fedpsa" else None)
        out["receive_many"][case] = (
            [bool(u) for u in upd], list(taus),
            torch.stack(snaps).numpy().copy(), srv.version)

        state = srv.state
        fields = {}
        for fname in pol.state_array_names(state):
            holder = state
            for part in fname.split("/")[:-1]:
                holder = getattr(holder, part)
            v = getattr(holder, fname.split("/")[-1])
            if isinstance(v, torch.Tensor):
                fields[fname] = (tuple(v.shape), v._base is not None,
                                 v.is_contiguous())
        out["layout"][case] = {"fields": fields, "specs": dict(srv._specs),
                               "d": srv._d, "d_pad": srv._d_pad}

    bad = sharding.LogicalRules({"param_shard": None, "cohort": None})
    try:
        _port_server("fedasync", server_params(), mesh, rules=bad)
        out["bad_rules"] = None
    except ValueError as e:
        out["bad_rules"] = str(e)
    return out


# d of the sums' cases: shards shorter than a chunk, chunks cut by one and
# by several shard boundaries, boundaries on chunk edges, d padded
SUM_SIZES = (1, 40, 41, 1_000, 2_048, 4_096, 4_522, 5_000, 3 * 1_024 + 7)


def sum_terms(d: int) -> np.ndarray:
    """Three (d,) float32 rows of mixed sign and scale."""
    rng = np.random.RandomState(d)
    return (rng.randn(3, d) * np.exp(rng.randn(3, d))).astype(np.float32)


def sums_program(mesh) -> dict:
    """``param_axis_sums`` of ``sum_terms(d)`` for d in ``SUM_SIZES``: on
    this rank's zero-padded shard inside ``param_axis`` and on the whole
    rows outside it, as float32 bits."""
    import torch
    from repro_torch.common import sharding
    axis = sharding.mesh_axis(mesh, None, "param_shard")
    n, out = axis.size, {}
    for d in SUM_SIZES:
        x = torch.from_numpy(sum_terms(d))
        d_local = -(-d // n)
        lo = axis.rank * d_local
        shard = torch.nn.functional.pad(x[:, lo:lo + d_local],
                                        (0, d_local - x[:, lo:lo + d_local]
                                         .shape[-1]))
        with sharding.param_axis(axis, d):
            sharded = sharding.param_axis_sums(*shard)
        whole = sharding.param_axis_sums(*x)
        out[d] = (torch.stack(sharded).numpy().tobytes(),
                  torch.stack(whole).numpy().tobytes())
    return out


# tests/test_golden.py's world (the constants the digests were made with)
GOLDEN_WORLD = dict(samples=1_500, classes=10, dim=32, clients=8, alpha=0.3,
                    seed=0)
GOLDEN_SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
GOLDEN_PSA = dict(queue_len=10)
GOLDEN_INIT = os.path.join(HERE, "torch_fixtures",
                           "paper_synthetic_mlp_init_seed0.npz")


def _golden_world():
    from repro_torch import data as tdata
    from repro_torch.configs import get_config
    from repro_torch.convert import load_npz_params
    W = GOLDEN_WORLD
    full = tdata.make_classification(W["samples"], W["classes"], W["dim"],
                                     seed=W["seed"], class_sep=0.7)
    train, test = tdata.train_test_split(full, 0.1)
    parts = tdata.dirichlet_partition(train, W["clients"], alpha=W["alpha"],
                                      seed=W["seed"])
    clients = [tdata.ClientDataset(train.subset(ix)) for ix in parts]
    calib = tdata.make_calibration_batch(train, 64, "gaussian")
    return (get_config("paper-synthetic-mlp"), clients, test, calib,
            load_npz_params(GOLDEN_INIT))


def _summary(res) -> dict:
    return {k: getattr(res, k) for k in (
        "digests", "times", "accuracies", "final_accuracy", "versions",
        "dispatches", "launched", "dropped", "cohorts", "receive_log",
        "engine")} | {"aulc": res.aulc,
                      "weights": [e.get("weight") for e in res.server_log]}


def _prune_to_mid_run(ckdir: str, total: int) -> int:
    """Keep the snapshots up to the last one taken mid-run; returns its
    step."""
    import shutil
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
    mid = [s for s in steps if 0 < s < total]
    if not mid:
        raise AssertionError(f"no mid-run snapshot among {steps}")
    for s in steps:
        if s > mid[-1]:
            shutil.rmtree(os.path.join(ckdir, f"step_{s:08d}"))
    return mid[-1]


def _split_case(cfg, clients, params, mesh, B: int) -> dict:
    """One wave of B members (the golden world's clients in turn) through
    the cohort engine with the mesh and without it, and a member-wise
    function through ``map_members``: whether the wave split, and the
    largest differences from the single-device results."""
    import torch
    from repro_torch.common.tree import FlatSpec
    from repro_torch.data.loader import StackedClients
    from repro_torch.federated.cohort import CohortEngine
    spec = FlatSpec(params)
    stacked = StackedClients.from_datasets(clients)
    cids = np.arange(B) % len(clients)
    seeds = 1000 + np.arange(B)
    w0 = spec.flatten(params)[None].repeat(B, 1)
    engines = [CohortEngine(cfg, stacked, spec, member_kernel="grouped",
                            mesh=m) for m in (mesh, None)]
    (d_mesh, w_mesh), (d_one, w_one) = (
        e.cohort_update(w0, cids, [0.05] * B, seeds) for e in engines)
    rows = torch.arange(B * 3, dtype=torch.float32).view(B, 3)
    mapped = engines[0].map_members(lambda r: r * 2.0 + 1.0, rows)
    return {"split": engines[0]._share(B) is not None,
            "split_waves": engines[0].split_waves,
            "deltas": float((d_mesh - d_one).abs().max()),
            "params": float((w_mesh - w_one).abs().max()),
            "mapped": float((mapped - (rows * 2.0 + 1.0)).abs().max())}


def sim_program(mesh, cases: list, ckdir: str = "") -> dict:
    """Runs on the golden world with ``SimConfig(mesh=mesh)``, one per
    case: ``("golden", policy, engine, member_kernel)``, ``("fedavg",)``
    (with the digest of every model it evaluates), ``("split", B)``
    (``_split_case``) or ``("resume", policy, engine, member_kernel)``:
    the run checkpointed every 1,500 units, pruned to its last mid-run
    snapshot by rank 0 and resumed; the pruned snapshots stay under
    ``ckdir``."""
    import torch.distributed as dist
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator as tsim
    cfg, clients, test, calib, params = _golden_world()

    def run(name, **sim):
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        return tsim.run_algorithm(name, cfg, params, clients, test,
                                  tsim.SimConfig(device="cpu", mesh=mesh,
                                                 record_trajectory=True,
                                                 **{**GOLDEN_SIM, **sim}),
                                  **kw)

    out = {}
    for case in cases:
        if case[0] == "golden":
            _, name, engine, mk = case
            out[case] = _summary(run(name, engine=engine, member_kernel=mk))
        elif case[0] == "fedavg":
            seen, build = [], tsim._build_eval

            def recorded_eval(*a, **kw):
                evaluate = build(*a, **kw)

                def ev(p):
                    from repro_torch.common.tree import FlatSpec
                    w = FlatSpec(p).flatten(p).numpy()
                    seen.append(tsim.make_digest_fn(w.size)(w[None])[0]
                                .tolist())
                    return evaluate(p)
                return ev

            tsim._build_eval = recorded_eval
            try:
                res = run("fedavg", engine="cohort")
            finally:
                tsim._build_eval = build
            out[case] = {**_summary(res), "eval_digests": seen}
        elif case[0] == "split":
            out[case] = _split_case(cfg, clients, params, mesh, case[1])
        elif case[0] == "resume":
            _, name, engine, mk = case
            ck = dict(checkpoint_dir=ckdir, checkpoint_every=1_500.0,
                      engine=engine, member_kernel=mk)
            snap = _summary(run(name, **ck))
            if dist.get_rank() == 0:
                _prune_to_mid_run(ckdir, snap["dispatches"])
            res = _summary(run(name, resume=True, **ck))
            out[case] = {"checkpointed": snap, "resumed": res}
        else:
            raise ValueError(f"unknown case {case!r}")
    return out


# tests/test_golden.py's fed-lm world (the constants fed-lm-smoke.json was
# made with), from the committed legacy-threefry init
FEDLM_WORLD = dict(samples=240, clients=6, alpha=0.3, seed=0, seq=16)
FEDLM_SIM = dict(num_clients=6, horizon=6_000.0, eval_every=3_000.0, seed=0,
                 local_epochs=2, batch_size=8)
FEDLM_PSA = dict(queue_len=10)
FEDLM_INIT = os.path.join(HERE, "torch_fixtures",
                          "fed_lm_smoke_init_seed0.npz")


def _fedlm_world(window: int = 0):
    """``(cfg, clients, test, calib, init)`` of the fed-lm world; a
    ``window`` > 0 sets ``cfg.sliding_window``."""
    import dataclasses
    from repro_torch.convert import load_npz_params
    from repro_torch.launch.train import build_task
    W = FEDLM_WORLD
    cfg, clients, test, calib = build_task(
        "fed-lm-smoke", W["samples"], W["alpha"], W["clients"], W["seed"],
        seq_len=W["seq"])
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return cfg, clients, test, calib, load_npz_params(FEDLM_INIT)


def fedlm_program(mesh, cases: list) -> dict:
    """Runs on the fed-lm world with ``SimConfig(mesh=mesh)``, one per case:
    ``("golden", policy, engine, member_kernel, window)`` or ``("split",
    B)`` (``_split_case`` over the fed-lm clients)."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator as tsim
    out = {}
    for case in cases:
        if case[0] == "golden":
            _, name, engine, mk, window = case
            cfg, clients, test, calib, params = _fedlm_world(window)
            kw = (dict(psa_cfg=PSAConfig(**FEDLM_PSA), calib_batch=calib)
                  if name == "fedpsa" else {})
            out[case] = _summary(tsim.run_algorithm(
                name, cfg, params, clients, test,
                tsim.SimConfig(device="cpu", mesh=mesh, engine=engine,
                               member_kernel=mk, record_trajectory=True,
                               **FEDLM_SIM), **kw))
        elif case[0] == "split":
            cfg, clients, _, _, params = _fedlm_world()
            out[case] = _split_case(cfg, clients, params, mesh, case[1])
        else:
            raise ValueError(f"unknown case {case!r}")
    return out


# tests/torch_fedlm_families.py's ssm and moe scenarios (the constants its
# fixtures were made with), from the committed legacy-threefry inits
FAMILY_MODELS = {"ssm": "fed-lm-ssm-smoke", "moe": "fed-lm-moe-smoke"}
FAMILY_SIM = dict(num_clients=6, horizon=2_000.0, eval_every=1_000.0, seed=0,
                  local_epochs=2, batch_size=8)


def family_run(family: str, name: str, member_kernel: str, mesh=None) -> dict:
    """``_summary`` of one fed-lm ``family`` run (cohort engine) on the
    fed-lm world, with ``SimConfig(mesh=mesh)``."""
    from repro_torch.convert import load_npz_params
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator as tsim
    from repro_torch.launch.train import build_task
    W = FEDLM_WORLD
    cfg, clients, test, calib = build_task(
        FAMILY_MODELS[family], W["samples"], W["alpha"], W["clients"],
        W["seed"], seq_len=W["seq"])
    init = load_npz_params(os.path.join(
        HERE, "torch_fixtures", f"fed_lm_{family}_smoke_init_seed0.npz"))
    kw = (dict(psa_cfg=PSAConfig(**FEDLM_PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    return _summary(tsim.run_algorithm(
        name, cfg, init, clients, test,
        tsim.SimConfig(device="cpu", mesh=mesh, engine="cohort",
                       member_kernel=member_kernel, record_trajectory=True,
                       **FAMILY_SIM), **kw))


def families_program(mesh, cases: list) -> dict:
    """``family_run`` on the mesh for each ``(family, policy,
    member_kernel)`` case."""
    return {case: family_run(*case, mesh=mesh) for case in cases}


def sharded_lm_program(mesh, arch: str, over: dict) -> dict:
    """``arch`` (with the config fields ``over``) on a (2, 2) ``data x
    model`` DTensor mesh over the 4 ranks, under ``rules_for``'s rules at
    batch 4, against the same model on one device: the loss and every
    gradient of a remat "full" step, a prefill's logits and one decode
    step's, as max |difference| / max |one device's|."""
    import dataclasses
    from types import SimpleNamespace

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common import sharding
    from repro_torch.common.tree import tree_leaves, value_and_grad
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    desc = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(2, 2)))
    cfg = dataclasses.replace(get_config(arch), remat="full", **over)
    B, S = 4, 8
    rules = rules_for(cfg, desc, B)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(1))
    spec = sharding.shard_pytree_spec(rules, M.param_axes(cfg, params))
    tspec = rules.mesh_axes(("batch", "seq"))

    def rel(a, b):
        return float((a - b.full_tensor()).abs().max() / a.abs().max())
    out = {"rules": {k: v for k, v in rules.rules.items() if v}}
    loss_fn = lambda p, b: M.loss_fn(p, b, cfg)  # noqa: E731
    l0, g0 = value_and_grad(loss_fn, params, {"tokens": tok, "labels": tok})
    pd = sharding.distribute(params, spec, mesh2, True)
    bd = sharding.distribute({"tokens": tok, "labels": tok},
                             {"tokens": tspec, "labels": tspec}, mesh2)
    with implicit_replication(), sharding.logical_rules(rules):
        l1, g1 = value_and_grad(loss_fn, pd, bd)
    out["loss"] = rel(l0, l1)
    out["grads"] = max(rel(a, b) for a, b in zip(tree_leaves(g0),
                                                  tree_leaves(g1)))
    pd = sharding.distribute(params, spec, mesh2)
    with torch.no_grad():
        c0, p0 = M.prefill(params, {"tokens": tok}, cfg, max_len=S + 2)
        _, d0 = M.decode_step(params, c0, tok[:, :1], S, cfg)
        with implicit_replication(), sharding.logical_rules(rules):
            c1, p1 = M.prefill(pd, {"tokens": bd["tokens"]}, cfg,
                               max_len=S + 2)
            _, d1 = M.decode_step(pd, c1, bd["tokens"][:, :1], S, cfg)
    out["prefill"], out["decode"] = rel(p0, p1), rel(d0, d1)
    return out


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
