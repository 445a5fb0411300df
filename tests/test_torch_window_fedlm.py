"""The fed-lm world with a sliding window, port against a live reference
run, on the CPU.

``fed-lm-smoke`` with ``sliding_window=8`` on the golden's fed-lm world
(``tests/test_golden.py``: 240 sequences of 16 tokens, so the window bites,
6 clients, horizon 6,000), from the legacy-threefry init (the reference
draws it inside ``jax.threefry_partitionable(False)``; the port loads the
committed ``fed_lm_smoke_init_seed0.npz``, which ``tests/test_torch_fedlm.py``
holds equal). fedasync and fedpsa: the reference's sequential run against
the committed fixture ``tests/torch_fixtures/fed_lm_window8_digests.json``
(which ``chip_smoke.py`` holds the card's runs to), and the port on the
three engine settings against the live run at the golden suite's
``RTOL=1e-4, ATOL=1e-3``, versions, dispatches, dropped and launched exact.

Rewrite the fixture from the reference with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_window_fedlm.py``.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget
from repro.core.psa import PSAConfig as RPSA
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch.convert import load_npz_params
from repro_torch.core.psa import PSAConfig
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.launch.train import build_task as t_build_task
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
INIT = os.path.join(HERE, "torch_fixtures", "fed_lm_smoke_init_seed0.npz")
FIXTURE = os.path.join(HERE, "torch_fixtures", "fed_lm_window8_digests.json")
FED = "fed-lm-smoke"
WINDOW = 8
WORLD = dict(samples=240, clients=6, alpha=0.3, seed=0, seq=16)
SIM = dict(num_clients=6, horizon=6_000.0, eval_every=3_000.0, seed=0,
           local_epochs=2, batch_size=8)
PSA = dict(queue_len=10)
POLICIES = ("fedasync", "fedpsa")
ENGINES = [("sequential", "vmap"), ("cohort", "vmap"), ("cohort", "grouped")]
RTOL, ATOL = 1e-4, 1e-3
COUNTERS = ("versions", "dispatches", "dropped", "launched")


def _world(build):
    W = WORLD
    cfg, clients, test, calib = build(FED, W["samples"], W["alpha"],
                                      W["clients"], W["seed"],
                                      seq_len=W["seq"])
    return dataclasses.replace(cfg, sliding_window=WINDOW), clients, test, \
        calib


def reference_run(name, world=None):
    """The reference's windowed run (sequential engine, legacy threefry
    init): digests, accuracies and the counters."""
    cfg, clients, test, calib = world or _world(r_build_task)
    kw = (dict(psa_cfg=RPSA(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    with jax.threefry_partitionable(False):
        params = RM.init_params(jax.random.PRNGKey(WORLD["seed"]), rget(FED))
        res = r_run(name, cfg, params, clients, test,
                    RSim(engine="sequential", record_trajectory=True, **SIM),
                    **kw)
    return {"digests": np.asarray(res.digests, np.float64).tolist(),
            "accuracies": [float(a) for a in res.accuracies],
            "final": {**{k: int(getattr(res, k)) for k in COUNTERS},
                      "final_accuracy": float(res.final_accuracy),
                      "aulc": float(res.aulc)}}


@pytest.fixture(scope="module")
def live():
    world = _world(r_build_task)
    return {name: reference_run(name, world) for name in POLICIES}


@pytest.fixture(scope="module")
def port_world():
    return _world(t_build_task)


def _check(res, want):
    for key in COUNTERS:
        assert getattr(res, key) == want["final"][key], key
    got, exp = np.asarray(res.digests), np.asarray(want["digests"])
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.accuracies, want["accuracies"], atol=2e-3)
    np.testing.assert_allclose(res.final_accuracy,
                               want["final"]["final_accuracy"], atol=2e-3)


@pytest.mark.parametrize("name", POLICIES)
def test_fixture_is_the_reference_run(live, name):
    with open(FIXTURE) as fh:
        fix = json.load(fh)
    assert fix["sliding_window"] == WINDOW and fix["sim"] == SIM
    want = fix["policies"][name]
    got = live[name]
    assert got["final"] == want["final"]
    np.testing.assert_allclose(got["digests"], want["digests"], rtol=1e-6,
                               atol=0)
    assert got["accuracies"] == want["accuracies"]


@pytest.mark.parametrize("engine,mk", ENGINES)
@pytest.mark.parametrize("name", POLICIES)
def test_windowed_fed_lm_matches_live_reference(live, port_world, name,
                                                engine, mk):
    cfg, clients, test, calib = port_world
    kw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    res = run_algorithm(name, cfg, load_npz_params(INIT), clients, test,
                        SimConfig(device="cpu", engine=engine,
                                  member_kernel=mk, record_trajectory=True,
                                  **SIM), **kw)
    assert res.engine == engine and res.local_steps > 0
    _check(res, live[name])
    # the window changes the run: the unwindowed golden misses this gate
    with open(os.path.join(HERE, "golden", "fed-lm-smoke.json")) as fh:
        golden = json.load(fh)["policies"][name]["digests"]
    assert not np.allclose(res.digests, golden, rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    fixture = {"world": {"model": FED, **WORLD}, "sim": SIM, "psa": PSA,
               "sliding_window": WINDOW, "engine": "sequential",
               "policies": {}}
    world = _world(r_build_task)
    for policy in POLICIES:
        fixture["policies"][policy] = reference_run(policy, world)
    with open(FIXTURE, "w") as fh:
        json.dump(fixture, fh, indent=1)
        fh.write("\n")
    print(f"wrote {FIXTURE}")
