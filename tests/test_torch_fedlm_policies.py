"""The other five async policies on the fed-lm world, port against a live
reference run, on the CPU.

fedbuff, ca2fl, fedfa, fedpac and asyncfeded (l2) on ``fed-lm-smoke``
(``tests/test_golden.py``'s fed-lm world: 240 sequences of 16 tokens, 6
clients), cohort engine, from the legacy-threefry init (the reference draws
it inside ``jax.threefry_partitionable(False)``, the port loads the
committed fixture, which ``tests/test_torch_fedlm.py`` holds equal). The
horizon is cut from the golden's 6,000 to 3,000 virtual units (17
receives, eval every 1,500) so that the five live reference runs fit the
file's time. Tolerances are the golden suite's ``RTOL=1e-4, ATOL=1e-3`` on
the digests; versions, dispatches, dropped and launched are exact.
"""
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
WORLD = ("fed-lm-smoke", 240, 0.3, 6, 0)
SIM = dict(num_clients=6, horizon=3_000.0, eval_every=1_500.0, seed=0,
           local_epochs=2, batch_size=8, engine="cohort",
           record_trajectory=True)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def worlds():
    return (t_build_task(*WORLD, seq_len=16),
            r_build_task(*WORLD, seq_len=16))


@pytest.mark.parametrize("name", ["fedbuff", "ca2fl", "fedfa", "fedpac",
                                  "asyncfeded"])
def test_policy_matches_live_reference(worlds, name):
    (cfg, clients, test, _), (rcfg, rclients, rtest, _) = worlds
    kw = {"server_kwargs": {"metric": "l2"}} if name == "asyncfeded" else {}
    with jax.threefry_partitionable(False):
        rparams = RM.init_params(jax.random.PRNGKey(0), rget(WORLD[0]))
        want = r_run(name, rcfg, rparams, rclients, rtest, RSim(**SIM), **kw)
    got = run_algorithm(name, cfg, load_npz_params(FIXTURE), clients, test,
                        SimConfig(device="cpu", **SIM), **kw)
    assert got.engine == want.engine == "cohort"
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.dispatches == 17
    g, w = np.asarray(got.digests), np.asarray(want.digests)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.accuracies, want.accuracies, atol=2e-3)
