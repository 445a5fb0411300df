"""Checkpoint/resume and synchronous FedAvg of the port against the
reference.

* ``checkpoint.store`` round-trips trees and names their leaves as the
  reference's store does;
* a run checkpointed mid-flight and resumed from a pruned snapshot
  reproduces the unbroken run: fedbuff's digests, ``receive_log``, times
  and counters exactly on both engines, FedPSA's (whole server state) at
  rtol 1e-6 / atol 1e-5; checkpointing does not change the run it
  snapshots; every policy's server state round-trips field by field, its
  host counters as host ints;
* the staleness scheduler's lag table round-trips (fast and exact
  samplers), and a stateful scheduler without the round trip is refused
  (the reference's ``tests/test_scheduler.py`` cases);
* ``run_fedavg`` equals a live reference ``run_fedavg`` on both engines
  and with ``prox > 0`` (times, dispatches, rounds exact; accuracies within
  1e-6; the digest of the model at each of about one evaluation a round at
  the golden tolerance), and its cohort engine equals its sequential one.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.checkpoint import store as rstore
from repro.configs import get_config as rget
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.federated import scheduler as rsched
from repro.federated import timeline as rtl
from repro_torch import data as tdata
from repro_torch.checkpoint import store
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params, params_to_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import policies as pol
from repro_torch.federated import scheduler as tsched
from repro_torch.federated import simulator as tsim
from repro_torch.federated import timeline as ttl
from repro_torch.federated.servers import make_server
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.models import model as tmodel
from torch_eval_digests import eval_digests
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                       "paper_synthetic_mlp_init_seed0.npz")
GOLDEN = dict(samples=1_500, classes=10, dim=32, clients=8, alpha=0.3, seed=0)
SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
QUICK = dict(num_clients=6, horizon=3_500.0, eval_every=1_750.0)
# tests/test_golden.py's digest tolerance
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-3
POLICIES = ["fedpsa", "fedbuff", "fedasync", "ca2fl", "fedfa", "fedpac",
            "asyncfeded"]


def _world(lib, samples=1_500, clients=8):
    full = lib.make_classification(samples, 10, 32, seed=0, class_sep=0.7)
    train, test = lib.train_test_split(full, 0.1)
    parts = lib.dirichlet_partition(train, clients, alpha=0.3, seed=0)
    return ([lib.ClientDataset(train.subset(ix)) for ix in parts], test,
            lib.make_calibration_batch(train, 64, "gaussian"))


@pytest.fixture(scope="module")
def quick_world():
    """The reference's tests/test_sweep.py world, with a port init."""
    clients, test, calib = _world(tdata, 800, QUICK["num_clients"])
    cfg = tget("paper-synthetic-mlp")
    return (cfg, clients, test, calib,
            tmodel.init_params(torch.Generator().manual_seed(0), cfg))


# ---------------------------------------------------------------------------
# checkpoint.store
# ---------------------------------------------------------------------------

TREE = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "nested": {"b": np.ones(4, np.int32)},
        "list": [np.zeros(2), np.full((1, 2), 7.0)],
        "t": torch.arange(3, dtype=torch.float32)}


def test_store_roundtrip(tmp_path):
    d = str(tmp_path)
    store.save_pytree(TREE, d, step=3)
    store.save_pytree(TREE, d, step=10)
    assert store.latest_step(d) == 10
    assert store.latest_step(str(tmp_path / "missing")) is None
    back = store.load_pytree(d, TREE, step=10)
    for k in ("a", "t"):
        np.testing.assert_array_equal(np.asarray(TREE[k]), back[k])
    np.testing.assert_array_equal(TREE["nested"]["b"], back["nested"]["b"])
    assert back["nested"]["b"].dtype == np.int32
    for a, b in zip(TREE["list"], back["list"]):
        np.testing.assert_array_equal(a, b)


def test_store_layout_matches_reference(tmp_path):
    """Leaf names, shapes and dtypes in the manifest, and the array file's
    entries, are the reference store's for the same tree."""
    ref = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in TREE.items()}
    got = store.save_pytree(TREE, str(tmp_path / "port"), step=7)
    want = rstore.save_pytree(ref, str(tmp_path / "ref"), step=7)
    assert os.path.basename(got) == os.path.basename(want) == "step_00000007"
    mg, mw = (json.load(open(os.path.join(p, "manifest.json")))
              for p in (got, want))
    for key in ("names", "shapes", "dtypes"):
        assert mg[key] == mw[key], key
    with np.load(os.path.join(got, "arrays.npz")) as a, \
            np.load(os.path.join(want, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])


def test_train_state_roundtrip(tmp_path):
    params = {"w": torch.ones(3)}
    opt = {"mu": [np.zeros(3), np.full(3, 2.0)], "count": np.int64(4)}
    store.save_train_state(params, opt, 42, str(tmp_path))
    p2, o2, step = store.load_train_state(str(tmp_path), params, opt)
    assert step == 42
    np.testing.assert_array_equal(p2["w"], np.ones(3))
    np.testing.assert_array_equal(o2["mu"][1], np.full(3, 2.0))


# ---------------------------------------------------------------------------
# host layers: timeline events, scheduler state
# ---------------------------------------------------------------------------

def test_timeline_events_and_clear_match_reference():
    rng = np.random.RandomState(3)
    rt, tt = rtl.Timeline(), ttl.Timeline()
    seq = 0
    for _ in range(12):
        n = int(rng.randint(1, 5))
        args = (np.round(rng.uniform(0, 100, size=n), 1),
                np.arange(seq, seq + n), rng.randint(0, 9, size=n),
                rng.randint(0, 4, size=n), rng.rand(n) < 0.8)
        seq += n
        rt.extend_arrays(*args, list(range(n)))
        tt.extend_arrays(*args, list(range(n)))
        if rng.rand() < 0.5:
            assert tuple(rt.pop()) == tuple(tt.pop())
    assert [tuple(e) for e in rt.events()] == [tuple(e) for e in tt.events()]
    assert len(tt.events()) == len(tt)
    tt.clear()
    assert not tt and tt.events() == []


def test_scheduler_state_arrays_match_reference():
    sim = SimConfig(num_clients=30, seed=2, scheduler="staleness",
                    scheduler_params={"staleness_weight": 1.5})
    scheds = []
    for mod in (rsched, tsched):
        st = mod.make_streams(sim)
        s = mod.make_scheduler(sim)
        s.bind(num_clients=30, rng=st.rng, latency_means=st.lat_means,
               avail_probs=st.avail, data_sizes=np.arange(1.0, 31.0))
        for v in range(20):
            s.select(np.zeros(3), np.full(3, v))
        scheds.append(s)
    a, b = (s.state_arrays() for s in scheds)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (rsched.UniformRefillScheduler.stateless,
            rsched.StalenessAwareScheduler.stateless,
            rsched.StalenessAwareScheduler.checkpoint_state) == \
        (True, False, True)
    # the port's one flag is the reference's two: stateless or
    # checkpoint_state
    for cls in ("Scheduler", "UniformRefillScheduler",
                "StalenessAwareScheduler"):
        r = getattr(rsched, cls)
        assert getattr(tsched, cls).checkpointable == (
            r.stateless or r.checkpoint_state), cls
    with pytest.raises(NotImplementedError):
        tsched.UniformRefillScheduler().load_state_arrays({"x": 1})


# ---------------------------------------------------------------------------
# Server state round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", POLICIES)
def test_server_state_roundtrip(quick_world, name):
    """Every field a step reads survives ``state_arrays`` into a fresh
    server; host counters come back as host ints, CA2FL's valid mask as a
    host bool array; the restored server then steps as the original."""
    cfg, clients, test, calib, params = quick_world
    kw = {}
    if name == "fedpsa":
        sk = tsim.make_sketch_fn(cfg, calib, PSAConfig(queue_len=3, buffer_size=2))
        kw = dict(psa_cfg=PSAConfig(queue_len=3, buffer_size=2),
                  sketch_fn=sk)
    servers = [make_server(name, params, num_clients=6, **kw)
               for _ in range(2)]
    spec = servers[0].policy.spec
    rng = np.random.RandomState(0)

    def receive(server, i):
        d = torch.from_numpy(0.01 * rng.randn(spec.size).astype(np.float32))
        meta = {"tau": i % 3, "client_id": i % 6, "data_size": 10.0 + i}
        if name == "fedpsa":
            meta["sketch"] = torch.from_numpy(rng.randn(16).astype(np.float32))
        return server.receive(d, server.flat_params + d, meta)

    for i in range(7):
        receive(servers[0], i)
    arrays = pol.state_arrays(servers[0].state)
    assert sorted(arrays) == sorted(pol.state_array_names(servers[0].state))
    servers[1].load_state_arrays(arrays)
    for k, v in pol.state_arrays(servers[1].state).items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    for field, holder, attr in pol._state_fields(servers[1].state):
        if field.endswith("count") or field == "version":
            assert type(getattr(holder, attr)) is int, field
    if name == "ca2fl":
        assert servers[1].state.cache.valid.dtype == bool
    state = rng.get_state()
    for s in servers:
        rng.set_state(state)
        for i in range(7, 12):
            receive(s, i)
    np.testing.assert_array_equal(servers[0].flat_params.numpy(),
                                  servers[1].flat_params.numpy())
    assert servers[0].version == servers[1].version


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------

def _prune_to_mid_run(ckdir, total_dispatches):
    """Drop the snapshots after a mid-run one so ``resume=True`` (which
    picks the latest) restarts from a mid-run state."""
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
    mid = [s for s in steps if 0 < s < total_dispatches]
    assert mid, steps
    for s in steps:
        if s > mid[-1]:
            shutil.rmtree(os.path.join(ckdir, f"step_{s:08d}"))
    return mid


@pytest.mark.parametrize("engine", ("cohort", "sequential"))
def test_checkpoint_resume_reproduces_digest_stream(quick_world, engine,
                                                    tmp_path):
    cfg, clients, test, calib, params = quick_world
    kw = dict(QUICK, record_trajectory=True, seed=0, engine=engine,
              device="cpu")
    base = run_algorithm("fedbuff", cfg, params, clients, test,
                         SimConfig(**kw))
    ckdir = str(tmp_path / engine)
    # checkpointing must not perturb the run it snapshots
    ck = run_algorithm("fedbuff", cfg, params, clients, test,
                       SimConfig(checkpoint_dir=ckdir,
                                 checkpoint_every=1_000.0, **kw))
    np.testing.assert_array_equal(np.asarray(ck.digests),
                                  np.asarray(base.digests))
    steps = _prune_to_mid_run(ckdir, base.dispatches)
    assert len(steps) >= 2, steps
    assert 0 < store.latest_step(ckdir) < base.dispatches
    res = run_algorithm("fedbuff", cfg, params, clients, test,
                        SimConfig(checkpoint_dir=ckdir,
                                  checkpoint_every=1_000.0, resume=True,
                                  **kw))
    np.testing.assert_array_equal(np.asarray(res.digests),
                                  np.asarray(base.digests))
    for key in ("dispatches", "launched", "dropped", "versions", "cohorts"):
        assert getattr(res, key) == getattr(base, key), key
    assert res.times == base.times
    assert res.receive_log == base.receive_log   # incl. pre-resume entries
    assert res.accuracies == base.accuracies
    assert res.final_accuracy == base.final_accuracy


def test_checkpoint_resume_fedpsa_state(quick_world, tmp_path):
    """FedPSA's whole sub-state (ring, kappas, thermometer queue, global
    sketch) survives the round trip, with dropouts in the timeline."""
    cfg, clients, test, calib, params = quick_world
    psa = PSAConfig(queue_len=8)
    kw = dict(QUICK, record_trajectory=True, seed=0, device="cpu",
              availability_kind="hetero", dropout_rate=0.2)
    base = run_algorithm("fedpsa", cfg, params, clients, test,
                         SimConfig(**kw), psa_cfg=psa, calib_batch=calib)
    assert base.dropped > 0
    ckdir = str(tmp_path / "psa")
    run_algorithm("fedpsa", cfg, params, clients, test,
                  SimConfig(checkpoint_dir=ckdir, checkpoint_every=1_200.0,
                            **kw), psa_cfg=psa, calib_batch=calib)
    _prune_to_mid_run(ckdir, base.dispatches)
    res = run_algorithm("fedpsa", cfg, params, clients, test,
                        SimConfig(checkpoint_dir=ckdir,
                                  checkpoint_every=1_200.0, resume=True,
                                  **kw), psa_cfg=psa, calib_batch=calib)
    np.testing.assert_allclose(np.asarray(res.digests),
                               np.asarray(base.digests), rtol=1e-6,
                               atol=1e-5)
    assert res.dispatches == base.dispatches
    assert res.dropped == base.dropped


def test_resume_without_snapshot_starts_fresh(quick_world, tmp_path):
    cfg, clients, test, calib, params = quick_world
    kw = dict(QUICK, record_trajectory=True, seed=0, device="cpu")
    base = run_algorithm("fedasync", cfg, params, clients, test,
                         SimConfig(**kw))
    res = run_algorithm("fedasync", cfg, params, clients, test,
                        SimConfig(checkpoint_dir=str(tmp_path / "none"),
                                  resume=True, **kw))
    np.testing.assert_array_equal(np.asarray(res.digests),
                                  np.asarray(base.digests))


def _sched_world():
    cfg = tget("paper-synthetic-mlp")
    full = tdata.make_classification(200, 10, 32, seed=0)
    train, test = tdata.train_test_split(full, 0.2)
    clients = [tdata.ClientDataset(train.subset(ix))
               for ix in tdata.iid_partition(train, 4, 0)]
    return cfg, clients, test, tmodel.init_params(
        torch.Generator().manual_seed(0), cfg)


def test_checkpoint_rejects_stateful_scheduler_without_roundtrip(
        tmp_path, monkeypatch):
    """A stateful scheduler without the state_arrays round trip is refused
    up front rather than resumed with a reset lag table."""
    class Opaque(tsched.StalenessAwareScheduler):
        name = "opaque"
        checkpointable = False

    cfg, clients, test, params = _sched_world()
    orig = tsim.make_scheduler
    monkeypatch.setattr(
        tsim, "make_scheduler",
        lambda sim: Opaque() if sim.scheduler == "opaque" else orig(sim))
    sim = SimConfig(num_clients=4, horizon=100.0, scheduler="opaque",
                    checkpoint_dir=str(tmp_path), engine="sequential",
                    device="cpu")
    with pytest.raises(ValueError, match="state_arrays"):
        run_algorithm("fedasync", cfg, params, clients, test, sim)


@pytest.mark.parametrize("exact", [False, True])
def test_staleness_checkpoint_resume_roundtrip(tmp_path, exact):
    """The staleness scheduler's lag table and envelope floor round-trip:
    a run resumed from a pruned snapshot reproduces the unbroken digest
    stream exactly, under the fast sampler and the exact oracle."""
    cfg, clients, test, params = _sched_world()
    kw = dict(num_clients=4, horizon=2_000.0, eval_every=1_000.0, seed=0,
              scheduler="staleness",
              scheduler_params={"staleness_weight": 2.0, "exact": exact},
              record_trajectory=True, engine="sequential", device="cpu")
    base = run_algorithm("fedasync", cfg, params, clients, test,
                         SimConfig(**kw))
    ckdir = str(tmp_path / "ck")
    ck = run_algorithm("fedasync", cfg, params, clients, test,
                       SimConfig(checkpoint_dir=ckdir, checkpoint_every=500.0,
                                 **kw))
    np.testing.assert_array_equal(np.asarray(ck.digests),
                                  np.asarray(base.digests))
    _prune_to_mid_run(ckdir, base.dispatches)
    res = run_algorithm("fedasync", cfg, params, clients, test,
                        SimConfig(checkpoint_dir=ckdir,
                                  checkpoint_every=500.0, resume=True, **kw))
    np.testing.assert_array_equal(np.asarray(res.digests),
                                  np.asarray(base.digests))
    assert res.dispatches == base.dispatches


# ---------------------------------------------------------------------------
# Synchronous FedAvg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [("cohort", 0.0), ("sequential", 0.0),
                                  ("cohort", 0.1), ("sequential", 0.1)])
def test_fedavg_matches_reference(case):
    """The port's run_fedavg against the reference's live run on the
    golden world from the committed init, with client dropouts."""
    engine, prox = case
    clients, test, _ = _world(tdata)
    rclients, rtest, _ = _world(rdata)
    # an evaluation about every round, each recording the evaluated model's
    # digest: the accuracies alone move in steps of one test sample
    kw = dict(engine=engine, availability_kind="hetero", dropout_rate=0.2,
              **{**SIM, "eval_every": 250.0})
    with eval_digests() as seen:
        want = r_run("fedavg", rget("paper-synthetic-mlp"),
                     params_to_numpy(load_npz_params(FIXTURE)), rclients,
                     rtest, RSim(**kw), prox=prox)
        got = run_algorithm("fedavg", tget("paper-synthetic-mlp"),
                            load_npz_params(FIXTURE), clients, test,
                            SimConfig(device="cpu", **kw), prox=prox)
    assert want.dropped > 0
    assert len(seen["port"]) == len(seen["ref"]) == len(want.times) > 20
    err = np.abs(np.asarray(seen["port"]) - np.asarray(seen["ref"]))
    print(f"fedavg {engine} prox={prox}: worst digest error "
          f"{float(err.max()):.3e} over {len(err)} evaluations")
    np.testing.assert_allclose(seen["port"], seen["ref"], rtol=GOLDEN_RTOL,
                               atol=GOLDEN_ATOL)
    for key in ("versions", "dispatches", "launched", "dropped", "cohorts",
                "engine"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.times == want.times
    np.testing.assert_allclose(got.accuracies, want.accuracies, atol=1e-6)
    np.testing.assert_allclose(got.final_accuracy, want.final_accuracy,
                               atol=1e-6)


def test_fedavg_cohort_matches_sequential(quick_world):
    cfg, clients, test, calib, params = quick_world
    seq, coh = (run_algorithm("fedavg", cfg, params, clients, test,
                              SimConfig(engine=e, device="cpu", seed=0,
                                        **QUICK),
                              psa_cfg=PSAConfig(), calib_batch=calib)
                for e in ("sequential", "cohort"))
    assert seq.versions == coh.versions and seq.dispatches == coh.dispatches
    assert coh.cohorts == coh.versions and seq.cohorts == 0
    np.testing.assert_allclose(coh.accuracies, seq.accuracies, atol=1e-4)


def test_cli_fedavg_runs(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--alg", "fedavg", "--device", "cpu", "--samples", "300",
                "--clients", "4", "--horizon", "1500", "--out",
                str(tmp_path)])
    (path,) = tmp_path.glob("fedavg*.json")
    rec = json.load(open(path))
    assert rec["engine"] == "cohort" and rec["versions"] >= 1
    assert "final=" in capsys.readouterr().out
