"""Sweep lanes (``run_sweep``) over the recurrent and MoE token families,
port against the JAX reference, on the CPU.

``fed-lm-ssm-smoke`` and ``fed-lm-moe-smoke`` in the shared world of
``tests/torch_fedlm_families.py`` (240 sequences of 16 tokens, 6 clients,
horizon 2,000), from the committed legacy-threefry inits; three lanes over
data seeds 0, 1 and 2 for fedasync and fedpsa, under ``member_kernel``
"vmap" and "grouped":

* every lane equals the reference's ``run_sweep`` lane at the lane
  tolerance ``run_sweep`` states (rtol 1e-5, atol 1e-4 on the digests),
  with the times and counters exact and the lane accuracies within 1e-5;
* lane 0 equals the reference's sequential run (the committed
  ``tests/torch_fixtures/fed_lm_<family>_digests.json``) at that tolerance.

A wave of the sweep is S x B members: the MoE's capacity, its stable top-k
sort and its slots stay per member, and mamba's time loop runs under the
member axis, so no lane's tokens move another lane. The reference's sweeps
take about 45 s each on a CPU (the mamba scan's compile), so their
lanes are the committed fixture ``tests/torch_fixtures/
fed_lm_families_sweep_digests.json``; lane 1 of each family's fedasync
sweep is held live to the reference's standalone run (its data seed on the
shared timeline: the reference's own lane contract), so a stale fixture
shows in both families. Rewrite the fixture
with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sweep_families.py``.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.federated import SweepConfig as RSweep
from repro.federated import run_sweep as r_sweep
from repro_torch.convert import load_npz_params
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import SimConfig, SweepConfig, run_sweep
from repro_torch.launch.train import build_task as t_build_task
from torch_fedlm_families import (COUNTERS, FAMILIES, PSA, POLICIES, RPSA,
                                  RM, RSim, SIM, WORLD, build_world,
                                  digests_path, init_path, r_build_task,
                                  reference_run, rget)
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_fixtures",
                       "fed_lm_families_sweep_digests.json")
DATA_SEEDS = [0, 1, 2]
LANE_RTOL, LANE_ATOL = 1e-5, 1e-4
MEMBER_KERNELS = ("vmap", "grouped")


def reference_sweep(family: str, name: str) -> dict:
    """The reference's ``run_sweep`` from its legacy-threefry init: each
    lane's digests and accuracies, the shared times and counters."""
    cfg, clients, test, calib = build_world(r_build_task, family)
    kw = (dict(psa_cfg=RPSA(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    with jax.threefry_partitionable(False):
        params = RM.init_params(jax.random.PRNGKey(WORLD["seed"]),
                                rget(FAMILIES[family]))
        res = r_sweep(name, cfg, params, clients, test,
                      RSim(record_trajectory=True, **SIM),
                      RSweep(data_seeds=DATA_SEEDS), **kw)
    return {"digests": [np.asarray(d, np.float64).tolist()
                        for d in res.digests],
            "lane_accuracies": [[float(a) for a in acc]
                                for acc in res.lane_accuracies],
            "times": [float(t) for t in res.times],
            "final": {k: int(getattr(res, k))
                      for k in COUNTERS + ("cohorts",)}}


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as fh:
        fix = json.load(fh)
    assert fix["world"] == WORLD and fix["sim"] == SIM and fix["psa"] == PSA
    assert fix["data_seeds"] == DATA_SEEDS
    assert fix["models"] == FAMILIES
    return fix


@pytest.fixture(scope="module")
def worlds():
    return {f: build_world(t_build_task, f) for f in FAMILIES}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=LANE_RTOL, atol=LANE_ATOL)


@pytest.mark.parametrize("mk", MEMBER_KERNELS)
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lanes_match_reference_sweep(fixture, worlds, family, name, mk):
    cfg, clients, test, calib = worlds[family]
    kw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    res = run_sweep(name, cfg, load_npz_params(init_path(family)), clients,
                    test, SimConfig(device="cpu", record_trajectory=True,
                                    member_kernel=mk, **SIM),
                    SweepConfig(data_seeds=DATA_SEEDS), **kw)
    want = fixture["sweeps"][f"{family}/{name}"]
    assert res.times == want["times"]
    for key, val in want["final"].items():
        assert getattr(res, key) == val, key
    for s in range(len(DATA_SEEDS)):
        _close(res.digests[s], want["digests"][s])
        np.testing.assert_allclose(res.lane_accuracies[s],
                                   want["lane_accuracies"][s], atol=1e-5)
    # lane 0 (data seed 0) is the reference's sequential run
    with open(digests_path(family)) as fh:
        seq = json.load(fh)["policies"][name]
    _close(res.digests[0], seq["digests"])
    for key in COUNTERS:
        assert getattr(res, key) == seq["final"][key], key
    # the reshuffled lanes take other trajectories
    assert res.digests[1] != res.digests[0] != res.digests[2]


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_fixture_lane_is_the_reference_standalone_run(fixture, family):
    """Lane 1 of the reference's fedasync sweep (the fixture) is the
    reference's standalone run with data seed 1 on the shared timeline
    (each such run takes 10-14 s on a CPU)."""
    live = reference_run(family, "fedasync", seed=DATA_SEEDS[1],
                         timeline_seed=SIM["seed"])
    want = fixture["sweeps"][f"{family}/fedasync"]
    _close(live["digests"], want["digests"][1])
    np.testing.assert_allclose(live["accuracies"], want["lane_accuracies"][1],
                               atol=1e-5)
    for key in COUNTERS:
        assert live["final"][key] == want["final"][key], key


if __name__ == "__main__":
    fix = {"world": WORLD, "sim": SIM, "psa": PSA, "data_seeds": DATA_SEEDS,
           "models": FAMILIES, "sweeps": {}}
    for fam in FAMILIES:
        for policy in POLICIES:
            fix["sweeps"][f"{fam}/{policy}"] = reference_sweep(fam, policy)
            print(f"{fam}/{policy} done", flush=True)
    with open(FIXTURE, "w") as fh:
        json.dump(fix, fh, indent=1)
        fh.write("\n")
    print(f"wrote {FIXTURE}")
