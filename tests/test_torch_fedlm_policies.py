"""The other five async policies on the fed-lm world, port against a live
reference run, on the CPU.

fedbuff, ca2fl, fedfa, fedpac and asyncfeded (l2, cosine and sketch) on
``fed-lm-smoke``
(``tests/test_golden.py``'s fed-lm world: 240 sequences of 16 tokens, 6
clients), cohort engine, from the legacy-threefry init (the reference draws
it inside ``jax.threefry_partitionable(False)``, the port loads the
committed fixture, which ``tests/test_torch_fedlm.py`` holds equal). The
horizon is cut from the golden's 6,000 to 3,000 virtual units (17
receives, eval every 1,500) so that the five live reference runs fit the
file's time. Tolerances are the golden suite's ``RTOL=1e-4, ATOL=1e-3`` on
the digests; versions, dispatches, dropped and launched are exact.

The live reference runs are committed as
``tests/torch_fixtures/fed_lm_policies_digests.json``, which
``chip_smoke.py`` holds the card's runs to; the fixture is checked here
against the live runs. Rewrite it with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fedlm_policies.py``.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch.convert import load_npz_params
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.launch.train import build_task as t_build_task
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "fed_lm_smoke_init_seed0.npz")
DIGESTS = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "fed_lm_policies_digests.json")
# (policy, asyncfeded metric)
CASES = [("fedbuff", "l2"), ("ca2fl", "l2"), ("fedfa", "l2"),
         ("fedpac", "l2"), ("asyncfeded", "l2"), ("asyncfeded", "cosine"),
         ("asyncfeded", "sketch")]
COUNTERS = ("versions", "dispatches", "dropped", "launched")
WORLD = ("fed-lm-smoke", 240, 0.3, 6, 0)
SIM = dict(num_clients=6, horizon=3_000.0, eval_every=1_500.0, seed=0,
           local_epochs=2, batch_size=8, engine="cohort",
           record_trajectory=True)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def worlds():
    return (t_build_task(*WORLD, seq_len=16),
            r_build_task(*WORLD, seq_len=16))


def _kw(name, metric):
    return {"server_kwargs": {"metric": metric}} if name == "asyncfeded" \
        else {}


def reference_run(name, metric, world):
    """The reference's run from its legacy-threefry init: digests,
    accuracies and the counters."""
    rcfg, rclients, rtest, _ = world
    with jax.threefry_partitionable(False):
        rparams = RM.init_params(jax.random.PRNGKey(0), rget(WORLD[0]))
        res = r_run(name, rcfg, rparams, rclients, rtest, RSim(**SIM),
                    **_kw(name, metric))
    return {"digests": np.asarray(res.digests, np.float64).tolist(),
            "accuracies": [float(a) for a in res.accuracies],
            "engine": res.engine,
            "final": {**{k: int(getattr(res, k)) for k in COUNTERS},
                      "final_accuracy": float(res.final_accuracy)}}


@pytest.fixture(scope="module")
def live(worlds):
    """Each case's live reference run, run once for the module."""
    done = {}

    def get(name, metric):
        if (name, metric) not in done:
            done[name, metric] = reference_run(name, metric, worlds[1])
        return done[name, metric]

    return get


def _check_port(worlds, want, name, metric):
    cfg, clients, test, _ = worlds[0]
    got = run_algorithm(name, cfg, load_npz_params(FIXTURE), clients, test,
                        SimConfig(device="cpu", **SIM), **_kw(name, metric))
    assert got.engine == want["engine"] == "cohort"
    for key in COUNTERS:
        assert getattr(got, key) == want["final"][key], key
    assert got.dispatches == 17
    g, w = np.asarray(got.digests), np.asarray(want["digests"])
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.accuracies, want["accuracies"], atol=2e-3)


@pytest.mark.parametrize("name", ["fedbuff", "ca2fl", "fedfa", "fedpac",
                                  "asyncfeded"])
def test_policy_matches_live_reference(worlds, live, name):
    _check_port(worlds, live(name, "l2"), name, "l2")


@pytest.mark.parametrize("metric", ["cosine", "sketch"])
def test_asyncfeded_metric_matches_live_reference(worlds, live, metric):
    _check_port(worlds, live("asyncfeded", metric), "asyncfeded", metric)


@pytest.mark.parametrize("name,metric", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_fixture_is_the_live_reference(live, name, metric):
    with open(DIGESTS) as fh:
        fix = json.load(fh)
    assert fix["sim"] == {k: v for k, v in SIM.items()
                          if k not in ("engine", "record_trajectory")}
    want = fix["runs"][f"{name}/{metric}"]
    got = live(name, metric)
    assert got["final"] == want["final"]
    np.testing.assert_allclose(got["digests"], want["digests"], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(got["accuracies"], want["accuracies"],
                               atol=1e-6)


if __name__ == "__main__":
    world = r_build_task(*WORLD, seq_len=16)
    fix = {"world": dict(zip(("model", "samples", "alpha", "clients", "seed"),
                             WORLD), seq=16),
           "sim": {k: v for k, v in SIM.items()
                   if k not in ("engine", "record_trajectory")},
           "engine": SIM["engine"], "runs": {}}
    for name, metric in CASES:
        fix["runs"][f"{name}/{metric}"] = reference_run(name, metric, world)
    with open(DIGESTS, "w") as fh:
        json.dump(fix, fh, indent=1)
        fh.write("\n")
    print(f"wrote {DIGESTS}")
