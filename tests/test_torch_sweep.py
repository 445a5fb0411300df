"""Sweep lanes of the port (``run_sweep``) against the reference and
against the port's standalone runs.

* On the golden world (``tests/test_golden.py``'s constants, the committed
  fixture init): lane 0 of a 3-lane sweep (data seeds ``[0, 0, 1234]``,
  hyperparameters ``[None, SWEEP_HYPER[name], None]``) reproduces the
  committed golden of every async policy at the golden suite's ``RTOL=1e-4,
  ATOL=1e-3`` with the counters exact, and every lane equals the
  reference's ``run_sweep`` lane run live on the same init at that
  tolerance.
* The lane contract, mirroring the reference's ``tests/test_sweep.py``: lane
  k equals the port's standalone run with that lane's data seed, init and
  hyperparameters at ``LANE_TOL`` (rtol 1e-5, atol 1e-4); permuting the
  lanes permutes the results; the configuration is validated.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.configs import get_config as rget
from repro.core import PSAConfig as RPSA
from repro.federated import (SimConfig as RSim, SweepConfig as RSweep,
                             run_sweep as r_sweep)
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params, params_to_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated.cohort import CohortEngine
from repro_torch.data.loader import StackedClients
from repro_torch.federated.simulator import (SimConfig, SweepConfig,
                                             run_algorithm, run_sweep)
from repro_torch.models import model as tmodel
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                       "paper_synthetic_mlp_init_seed0.npz")
# tests/test_golden.py's world and sweep lanes
GOLDEN = dict(samples=1_500, classes=10, dim=32, clients=8, alpha=0.3, seed=0)
SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
PSA = dict(queue_len=10)
RTOL, ATOL = 1e-4, 1e-3
SWEEP_HYPER = {
    "fedasync": {"alpha": 0.3}, "fedbuff": {"server_lr": 0.7},
    "fedpsa": {"server_lr": 0.5}, "ca2fl": {"server_lr": 0.6},
    "fedfa": {"beta": 0.8}, "fedpac": {"server_lr": 0.8},
    "asyncfeded": {"alpha": 0.4},
}
POLICIES = list(SWEEP_HYPER)
GOLDEN_LANES = dict(data_seeds=[0, 0, 1234])
# the reference's lane contract (tests/test_sweep.py: rtol 1e-5, atol 1e-4)
LANE_TOL = 1e-5
QUICK = dict(num_clients=6, horizon=3_500.0, eval_every=1_750.0)


def _golden_world(lib):
    W = GOLDEN
    full = lib.make_classification(W["samples"], W["classes"], W["dim"],
                                   seed=W["seed"], class_sep=0.7)
    train, test = lib.train_test_split(full, 0.1)
    parts = lib.dirichlet_partition(train, W["clients"], alpha=W["alpha"],
                                    seed=W["seed"])
    clients = [lib.ClientDataset(train.subset(ix)) for ix in parts]
    return clients, test, lib.make_calibration_batch(train, 64, "gaussian")


@pytest.fixture(scope="module")
def golden_world():
    clients, test, calib = _golden_world(tdata)
    return tget("paper-synthetic-mlp"), clients, test, calib


@pytest.fixture(scope="module")
def quick_world():
    """The reference's tests/test_sweep.py world, with a port init."""
    cfg = tget("paper-synthetic-mlp")
    full = tdata.make_classification(800, 10, 32, seed=0, class_sep=0.7)
    train, test = tdata.train_test_split(full, 0.1)
    parts = tdata.dirichlet_partition(train, QUICK["num_clients"], alpha=0.3,
                                      seed=0)
    clients = [tdata.ClientDataset(train.subset(ix)) for ix in parts]
    calib = tdata.make_calibration_batch(train, 64, "gaussian")
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, clients, test, calib, params


def _golden_sweep(world, name, member_kernel="vmap"):
    cfg, clients, test, calib = world
    kw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    sweep = SweepConfig(policy_params=[None, SWEEP_HYPER[name], None],
                        **GOLDEN_LANES)
    sim = SimConfig(record_trajectory=True, device="cpu",
                    member_kernel=member_kernel, **SIM)
    return run_sweep(name, cfg, load_npz_params(FIXTURE), clients, test, sim,
                     sweep, **kw)


def _share(got, want) -> float:
    """Worst digest error as a share of the golden tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


@pytest.mark.parametrize("name", POLICIES)
def test_sweep_lane0_matches_golden(golden_world, name):
    res = _golden_sweep(golden_world, name)
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    want = np.asarray(golden["digests"])
    got = np.asarray(res.digests[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(res, key) == golden["final"][key], key
    np.testing.assert_allclose(res.final_accuracy[0],
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc[0], golden["final"]["aulc"],
                               atol=2e-3)
    print(f"{name}: lane 0 at {_share(got, want):.4f} of the golden tolerance")
    for s in (1, 2):   # the varied lanes take other trajectories
        assert not np.allclose(np.asarray(res.digests[s]), want,
                               rtol=RTOL, atol=ATOL), s


def test_grouped_sweep_matches_vmap_sweep(golden_world):
    """``member_kernel="grouped"`` widens the grouped product's G to the
    S*B members of a wave; it gives the vmap sweep's lanes."""
    a = _golden_sweep(golden_world, "fedpsa", "grouped")
    b = _golden_sweep(golden_world, "fedpsa", "vmap")
    for s in range(3):
        np.testing.assert_allclose(a.digests[s], b.digests[s], rtol=LANE_TOL,
                                   atol=10 * LANE_TOL)


@pytest.mark.parametrize("name", ["fedpsa", "fedfa", "ca2fl"])
def test_lanes_match_reference_sweep(golden_world, name):
    """Every lane against the reference's ``run_sweep`` lane, run live on
    the same init, world and lanes."""
    cfg, clients, test, calib = golden_world
    rclients, rtest, rcalib = _golden_world(rdata)
    kw, rkw = {}, {}
    if name == "fedpsa":
        kw = dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
        rkw = dict(psa_cfg=RPSA(**PSA), calib_batch=rcalib)
    lanes = dict(policy_params=[None, SWEEP_HYPER[name], None],
                 **GOLDEN_LANES)
    want = r_sweep(name, rget("paper-synthetic-mlp"),
                   params_to_numpy(load_npz_params(FIXTURE)), rclients, rtest,
                   RSim(record_trajectory=True, **SIM), RSweep(**lanes), **rkw)
    got = run_sweep(name, cfg, load_npz_params(FIXTURE), clients, test,
                    SimConfig(record_trajectory=True, device="cpu", **SIM),
                    SweepConfig(**lanes), **kw)
    for key in ("versions", "dispatches", "dropped", "launched", "cohorts"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.times == want.times
    shares = []
    for s in range(3):
        np.testing.assert_allclose(got.digests[s], want.digests[s],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.final_accuracy[s],
                                   want.final_accuracy[s], atol=2e-3)
        shares.append(_share(got.digests[s], want.digests[s]))
    print(f"{name}: lanes at {['%.4f' % x for x in shares]} of the golden "
          f"tolerance against the reference's lanes")


def _digest_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=LANE_TOL, atol=10 * LANE_TOL)


def _run_solo(world, alg, sim_kw, seed, params=None, **kw):
    cfg, clients, test, calib, init = world
    sim = SimConfig(record_trajectory=True, seed=seed, device="cpu", **sim_kw)
    if alg == "fedpsa":
        kw.setdefault("psa_cfg", PSAConfig(queue_len=8))
        kw.setdefault("calib_batch", calib)
    return run_algorithm(alg, cfg, init if params is None else params,
                         clients, test, sim, **kw)


@pytest.mark.parametrize("alg,hyper", [
    ("fedbuff", {"server_lr": 0.7}),
    ("fedfa", {"beta": 0.8}),
    ("fedasync", {"alpha": 0.35}),
])
def test_lane_matches_standalone(quick_world, alg, hyper):
    """Each lane of a 3-lane sweep (default / hyper-varied / reshuffled)
    reproduces the standalone run with the same timeline seed and that
    lane's data seed and hyper overrides."""
    cfg, clients, test, calib, params = quick_world
    lanes = [dict(data_seed=0, hyper=None), dict(data_seed=0, hyper=hyper),
             dict(data_seed=11, hyper=None)]
    res = run_sweep(alg, cfg, params, clients, test,
                    SimConfig(record_trajectory=True, seed=0, device="cpu",
                              **QUICK),
                    SweepConfig(data_seeds=[l["data_seed"] for l in lanes],
                                policy_params=[l["hyper"] for l in lanes]))
    assert res.num_lanes == 3 and res.dispatches > 0
    for s, lane in enumerate(lanes):
        solo = _run_solo(quick_world, alg, dict(QUICK, timeline_seed=0),
                         seed=lane["data_seed"],
                         **({"server_kwargs": dict(lane["hyper"])}
                            if lane["hyper"] else {}))
        assert solo.dispatches == res.dispatches      # shared timeline
        assert solo.receive_log == res.receive_log
        _digest_close(res.digests[s], solo.digests)
        np.testing.assert_allclose(res.final_accuracy[s],
                                   solo.final_accuracy, atol=1e-5)
    assert not np.allclose(res.digests[0], res.digests[1])
    assert not np.allclose(res.digests[0], res.digests[2])


def test_fedpsa_lane_parity_including_ablation_lane(quick_world):
    """FedPSA lanes: per-lane gamma/delta and a w/o-T ablation lane each
    match their standalone equivalents."""
    cfg, clients, test, calib, params = quick_world
    psa = PSAConfig(queue_len=8)
    res = run_sweep("fedpsa", cfg, params, clients, test,
                    SimConfig(record_trajectory=True, seed=0, device="cpu",
                              **QUICK),
                    SweepConfig(policy_params=[
                        None, {"gamma": 0.5, "delta": 0.1},
                        {"use_thermometer": False}]),
                    psa_cfg=psa, calib_batch=calib)
    for s, cfg_s in enumerate((
            psa, PSAConfig(queue_len=8, gamma=0.5, delta=0.1),
            PSAConfig(queue_len=8, use_thermometer=False))):
        solo = _run_solo(quick_world, "fedpsa", QUICK, seed=0, psa_cfg=cfg_s)
        _digest_close(res.digests[s], solo.digests)


def test_model_seed_lanes(quick_world):
    """``model_seeds`` inits each lane from its own torch generator; the
    lane matches the standalone run from that init."""
    cfg, clients, test, calib, params = quick_world
    res = run_sweep("fedasync", cfg, params, clients, test,
                    SimConfig(record_trajectory=True, seed=0, device="cpu",
                              **QUICK), SweepConfig(model_seeds=[0, 3]))
    for s, init_seed in enumerate((0, 3)):
        init = tmodel.init_params(torch.Generator().manual_seed(init_seed),
                                  cfg)
        solo = _run_solo(quick_world, "fedasync", QUICK, seed=0, params=init)
        _digest_close(res.digests[s], solo.digests)
    assert not np.allclose(res.digests[0], res.digests[1])


def test_permuting_lanes_permutes_results(quick_world):
    cfg, clients, test, calib, params = quick_world
    seeds = [0, 5, 9]
    hypers = [None, {"alpha": 0.3}, {"alpha": 0.9}]
    perm = [2, 0, 1]
    sim = SimConfig(record_trajectory=True, seed=0, device="cpu", **QUICK)
    base = run_sweep("fedasync", cfg, params, clients, test, sim,
                     SweepConfig(data_seeds=seeds, policy_params=hypers))
    shuf = run_sweep("fedasync", cfg, params, clients, test, sim,
                     SweepConfig(data_seeds=[seeds[p] for p in perm],
                                 policy_params=[hypers[p] for p in perm]))
    assert base.times == shuf.times
    for s, p in enumerate(perm):
        _digest_close(shuf.digests[s], base.digests[p])
        np.testing.assert_allclose(shuf.final_accuracy[s],
                                   base.final_accuracy[p], atol=1e-6)
        np.testing.assert_allclose(shuf.lane_accuracies[s],
                                   base.lane_accuracies[p], atol=1e-6)


def test_sweep_config_validation(quick_world):
    cfg, clients, test, calib, params = quick_world
    sim = SimConfig(seed=0, device="cpu", **QUICK)
    with pytest.raises(ValueError, match="lane counts"):
        SweepConfig(data_seeds=[0, 1], policy_params=[None]).resolve(0)
    with pytest.raises(ValueError, match="fedavg"):
        run_sweep("fedavg", cfg, params, clients, test, sim, SweepConfig())
    with pytest.raises(ValueError, match="buffer_size"):
        run_sweep("fedbuff", cfg, params, clients, test, sim,
                  SweepConfig(policy_params=[{"buffer_size": 9}]))
    with pytest.raises(ValueError, match="cohort"):
        run_sweep("fedasync", cfg, params, clients, test,
                  SimConfig(seed=0, engine="sequential", device="cpu",
                            **QUICK), SweepConfig())
    with pytest.raises(ValueError, match="single-device"):
        run_sweep("fedasync", cfg, params, clients, test,
                  SimConfig(seed=0, mesh=object(), device="cpu", **QUICK),
                  SweepConfig())
    with pytest.raises(ValueError, match="single runs"):
        run_sweep("fedasync", cfg, params, clients, test,
                  SimConfig(seed=0, checkpoint_dir="ckpt", device="cpu",
                            **QUICK), SweepConfig())


def test_lane_view_is_a_sim_result(quick_world):
    cfg, clients, test, calib, params = quick_world
    res = run_sweep("fedbuff", cfg, params, clients, test,
                    SimConfig(record_trajectory=True, seed=0, device="cpu",
                              **QUICK), SweepConfig(data_seeds=[0, 4]))
    lane = res.lane(1)
    assert lane.final_accuracy == res.final_accuracy[1]
    assert lane.times == res.times
    assert lane.dispatches == res.dispatches
    assert 0.0 <= lane.aulc <= 1.0
    mean, std = res.accuracy_mean_std()
    np.testing.assert_allclose(mean, np.mean(res.final_accuracy))


def test_sweep_update_is_cohort_update_per_lane(quick_world):
    """``CohortEngine.sweep_update`` on an (S, B, d) stack equals
    ``cohort_update`` on each lane's (B, d) rows and seeds."""
    cfg, clients, test, calib, params = quick_world
    spec = FlatSpec(params)
    engine = CohortEngine(cfg, StackedClients.from_datasets(clients), spec,
                          local_epochs=2, batch_size=16)
    rng = np.random.RandomState(0)
    S, B = 3, 5
    snaps = torch.from_numpy(0.1 * rng.randn(S, B, spec.size).astype(
        np.float32))
    cids, lrs = [0, 3, 1, 5, 3], [0.01, 0.02, 0.01, 0.03, 0.02]
    seeds = rng.randint(0, 10_000, size=(S, B))
    deltas, w = engine.sweep_update(snaps, cids, lrs, seeds)
    assert deltas.shape == w.shape == (S, B, spec.size)
    for s in range(S):
        d1, w1 = engine.cohort_update(snaps[s], cids, lrs, seeds[s])
        np.testing.assert_allclose(w[s].numpy(), w1.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(deltas[s].numpy(), d1.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_cli_sweep_runs(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--alg", "fedbuff", "--device", "cpu", "--samples", "300",
                "--clients", "4", "--horizon", "1500", "--sweep",
                "server_lr=0.5,1", "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*sweep*.json")
    rec = json.load(open(path))
    assert rec["lanes"] == ["server_lr0.5", "server_lr1"]
    assert len(rec["final_accuracy"]) == 2 and rec["engine"] == "cohort"
    assert "mean=" in capsys.readouterr().out
