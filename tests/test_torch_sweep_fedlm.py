"""Sweep lanes (``run_sweep``) over the dense token family, port against
the JAX reference, on the CPU.

The fed-lm world of ``tests/test_torch_fedlm.py`` (``tests/test_golden.py``'s
constants: 240 sequences of 16 tokens, 6 clients, horizon 6,000), from the
committed legacy-threefry init ``fed_lm_smoke_init_seed0.npz``; three lanes
as ``tests/test_torch_sweep.py`` runs them on the golden world (data seeds
``[0, 0, 1234]``, hyperparameters ``[None, SWEEP_HYPER[name], None]``):

* lane 0 reproduces ``tests/golden/fed-lm-smoke.json`` for fedasync and
  fedpsa at the golden suite's ``RTOL=1e-4, ATOL=1e-3``, with the counters
  exact;
* every lane equals the reference's ``run_sweep`` lane at that tolerance.
  The reference's sweeps take about a minute on this CPU, so their lanes
  are the committed fixture ``tests/torch_fixtures/fed_lm_sweep_digests.json``,
  and one lane of it (fedasync's varied lane) is run live against the
  fixture;
* lane k equals the port's standalone run with that lane's data seed and
  hyperparameters at the lane tolerance (rtol 1e-5, atol 1e-4);
* ``member_kernel="grouped"`` gives the ``"vmap"`` lanes;
* ``launch.train --arch fed-lm-smoke --sweep seeds=0,1,2``: lane 0 is the
  standalone ``run_algorithm`` run.

``tests/test_torch_sweep_fedlm_window.py`` runs the same lanes with
``sliding_window=8``. Rewrite the fixture (both files' reference lanes)
with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sweep_fedlm.py``.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget
from repro.core.psa import PSAConfig as RPSA
from repro.federated import SimConfig as RSim, SweepConfig as RSweep
from repro.federated import run_sweep as r_sweep
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch.convert import load_npz_params
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import (SimConfig, SweepConfig, run_algorithm,
                                   run_sweep)
from repro_torch.launch.train import build_task as t_build_task
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
INIT = os.path.join(HERE, "torch_fixtures", "fed_lm_smoke_init_seed0.npz")
FIXTURE = os.path.join(HERE, "torch_fixtures", "fed_lm_sweep_digests.json")
GOLDEN = os.path.join(HERE, "golden", "fed-lm-smoke.json")
FED = "fed-lm-smoke"
WORLD = dict(samples=240, clients=6, alpha=0.3, seed=0, seq=16)
SIM = dict(num_clients=6, horizon=6_000.0, eval_every=3_000.0, seed=0,
           local_epochs=2, batch_size=8)
PSA = dict(queue_len=10)
POLICIES = ("fedasync", "fedpsa")
WINDOWS = (0, 8)
# tests/test_torch_sweep.py's lanes
SWEEP_HYPER = {"fedasync": {"alpha": 0.3}, "fedpsa": {"server_lr": 0.5}}
DATA_SEEDS = [0, 0, 1234]
RTOL, ATOL = 1e-4, 1e-3
LANE_TOL = 1e-5
COUNTERS = ("versions", "dispatches", "dropped", "launched")


def _lanes(name):
    return dict(data_seeds=DATA_SEEDS,
                policy_params=[None, SWEEP_HYPER[name], None])


def _world(build, window):
    W = WORLD
    cfg, clients, test, calib = build(FED, W["samples"], W["alpha"],
                                      W["clients"], W["seed"],
                                      seq_len=W["seq"])
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return cfg, clients, test, calib


def reference_sweep(name, window, lanes=None):
    """The reference's ``run_sweep`` from its legacy-threefry init: each
    lane's digests and accuracies, the shared times and counters."""
    cfg, clients, test, calib = _world(r_build_task, window)
    kw = (dict(psa_cfg=RPSA(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    with jax.threefry_partitionable(False):
        params = RM.init_params(jax.random.PRNGKey(WORLD["seed"]), rget(FED))
        res = r_sweep(name, cfg, params, clients, test,
                      RSim(record_trajectory=True, **SIM),
                      RSweep(**(lanes or _lanes(name))), **kw)
    return {"digests": [np.asarray(d, np.float64).tolist()
                        for d in res.digests],
            "lane_accuracies": [[float(a) for a in acc]
                                for acc in res.lane_accuracies],
            "times": [float(t) for t in res.times],
            "final": {**{k: int(getattr(res, k))
                         for k in COUNTERS + ("cohorts",)},
                      "final_accuracy": [float(a)
                                         for a in res.final_accuracy]}}


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as fh:
        fix = json.load(fh)
    assert fix["sim"] == SIM and fix["world"] == {"model": FED, **WORLD}
    return fix


@pytest.fixture(scope="module")
def port():
    """The port's sweeps and standalone runs, each run once for the
    module: ``port(kind, name, window=0, **kw)``."""
    worlds, done = {}, {}

    def get(kind, name, window=0, **kw):
        key = (kind, name, window) + tuple(sorted(kw.items()))
        if key not in done:
            if window not in worlds:
                worlds[window] = _world(t_build_task, window)
            cfg, clients, test, calib = worlds[window]
            pkw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
                   if name == "fedpsa" else {})
            if kind == "sweep":
                sim = SimConfig(device="cpu", record_trajectory=True,
                                member_kernel=kw.get("mk", "vmap"), **SIM)
                done[key] = run_sweep(name, cfg, load_npz_params(INIT),
                                      clients, test, sim,
                                      SweepConfig(**_lanes(name)), **pkw)
            else:
                # the lane's overrides: fedpsa's through its PSAConfig, the
                # other policies' as server keywords
                lane = kw["lane"]
                hyper = _lanes(name)["policy_params"][lane] or {}
                if name == "fedpsa":
                    pkw["psa_cfg"] = PSAConfig(**PSA, **hyper)
                else:
                    pkw["server_kwargs"] = dict(hyper)
                sim = SimConfig(device="cpu", record_trajectory=True,
                                **{**SIM, "seed": DATA_SEEDS[lane],
                                   "timeline_seed": SIM["seed"]})
                done[key] = run_algorithm(name, cfg, load_npz_params(INIT),
                                          clients, test, sim, **pkw)
        return done[key]

    return get


def _check(got_digests, want, counters_of=None, want_counters=None):
    got, exp = np.asarray(got_digests), np.asarray(want)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    if counters_of is not None:
        for key, val in want_counters.items():
            assert getattr(counters_of, key) == val, key


@pytest.mark.parametrize("name", POLICIES)
def test_sweep_lane0_matches_golden(port, name):
    res = port("sweep", name)
    with open(GOLDEN) as fh:
        golden = json.load(fh)["policies"][name]
    _check(res.digests[0], golden["digests"], res,
           {k: golden["final"][k] for k in COUNTERS})
    np.testing.assert_allclose(res.final_accuracy[0],
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc[0], golden["final"]["aulc"],
                               atol=2e-3)
    for s in (1, 2):   # the varied lanes take other trajectories (fedpsa's
        # reshuffled lane stays within the golden tolerance on this world)
        assert res.digests[s] != res.digests[0], s


@pytest.mark.parametrize("name", POLICIES)
def test_lanes_match_reference_sweep(port, fixture, name, window=0):
    """Every lane against the reference's ``run_sweep`` lane (the
    fixture): digests at the golden tolerance, accuracies within 2e-3,
    times and counters exact. ``window`` > 0: the windowed lanes
    (``tests/test_torch_sweep_fedlm_window.py``)."""
    res = port("sweep", name, window)
    want = fixture["sweeps"][f"{name}/w{window}"]
    assert res.times == want["times"]
    for key, val in want["final"].items():
        if key != "final_accuracy":
            assert getattr(res, key) == val, key
    for s in range(3):
        _check(res.digests[s], want["digests"][s])
        np.testing.assert_allclose(res.lane_accuracies[s],
                                   want["lane_accuracies"][s], atol=2e-3)


def test_fixture_is_the_reference_sweep(fixture):
    """fedasync's varied lane, run live as a one-lane reference sweep (its
    wave pads to the three-lane wave's 4 members), is the fixture's lane
    1."""
    live = reference_sweep("fedasync", 0, dict(
        data_seeds=[DATA_SEEDS[1]],
        policy_params=[SWEEP_HYPER["fedasync"]]))
    want = fixture["sweeps"]["fedasync/w0"]
    assert live["times"] == want["times"]
    np.testing.assert_allclose(live["digests"][0], want["digests"][1],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(live["lane_accuracies"][0],
                               want["lane_accuracies"][1], atol=1e-6)


@pytest.mark.parametrize("lane", (1, 2))
@pytest.mark.parametrize("name", POLICIES)
def test_lane_matches_standalone(port, name, lane):
    res = port("sweep", name)
    solo = port("solo", name, lane=lane)
    assert solo.receive_log == res.receive_log
    assert solo.local_steps == res.local_steps > 0   # one wave, all lanes
    got, want = np.asarray(res.digests[lane]), np.asarray(solo.digests)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LANE_TOL, atol=10 * LANE_TOL)
    np.testing.assert_allclose(res.final_accuracy[lane], solo.final_accuracy,
                               atol=1e-5)


def test_grouped_sweep_matches_vmap_sweep(port):
    """``member_kernel="grouped"``: the grouped product's G is the wave's
    padded S*B members; the lanes are the vmap sweep's."""
    a = port("sweep", "fedasync", mk="grouped")
    b = port("sweep", "fedasync")
    for s in range(3):
        np.testing.assert_allclose(a.digests[s], b.digests[s], rtol=LANE_TOL,
                                   atol=10 * LANE_TOL)


def test_cli_sweep_seeds_lane0_is_the_standalone_run(tmp_path):
    """``--arch fed-lm-smoke --sweep seeds=0,1,2``: lane 0 (model and data
    seed 0) is ``run_algorithm`` from the CLI's seed-0 init."""
    from repro_torch.launch import train
    argv = ["--arch", FED, "--seq", "16", "--device", "cpu", "--alg",
            "fedasync", "--samples", "240", "--clients", "6", "--alpha",
            "0.3", "--horizon", "2000", "--out", str(tmp_path)]
    res = train.main(argv + ["--sweep", "seeds=0,1,2"])
    (path,) = tmp_path.glob("*sweep*.json")
    rec = json.loads(path.read_text())
    assert rec["lanes"] == ["seed0", "seed1", "seed2"]
    solo = train.main(argv)
    assert res.num_lanes == 3 and res.dispatches == solo.dispatches > 0
    np.testing.assert_allclose(res.lane_accuracies[0], solo.accuracies,
                               atol=1e-6)
    assert res.final_accuracy[0] == pytest.approx(solo.final_accuracy,
                                                  abs=1e-6)


if __name__ == "__main__":
    fix = {"world": {"model": FED, **WORLD}, "sim": SIM, "psa": PSA,
           "data_seeds": DATA_SEEDS, "sweep_hyper": SWEEP_HYPER,
           "sweeps": {}}
    for policy in POLICIES:
        for window in WINDOWS:
            fix["sweeps"][f"{policy}/w{window}"] = reference_sweep(policy,
                                                                   window)
    with open(FIXTURE, "w") as fh:
        json.dump(fix, fh, indent=1)
        fh.write("\n")
    print(f"wrote {FIXTURE}")
