"""The fed-lm ssm and moe scenarios, port against a live reference run: the
shared world, the reference's runs and the fixtures the card reads.

``fed-lm-ssm-smoke`` (a mamba backbone) and ``fed-lm-moe-smoke`` (an MoE
FFN at lossless capacity with ``router_aux_coef = 0``) on
``tests/test_golden.py``'s fed-lm world (240 sequences of 16 tokens, 6
clients), with the horizon cut from the golden's 6,000 to 2,000 virtual
units (10 receives, 70 local steps, two FedPSA aggregations, eval every
1,000) so that each file's live reference runs stay well under a minute
and ``chip_smoke.py``'s runs of both families within its time. The reference draws its init inside
``jax.threefry_partitionable(False)`` (ROADMAP "Reference caveats"); the
port loads it from ``tests/torch_fixtures/fed_lm_<family>_smoke_init_seed0
.npz``. The reference's sequential runs of fedasync and fedpsa are
committed as ``tests/torch_fixtures/fed_lm_<family>_digests.json``, which
``chip_smoke.py``'s ``[families]`` phase holds the card's runs to. Rewrite
both fixtures from the reference with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fedlm_families.py``.
"""
import json
import os

import jax
import numpy as np

from repro.configs import get_config as rget
from repro.core.psa import PSAConfig as RPSA
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM

HERE = os.path.dirname(os.path.abspath(__file__))
FAMILIES = {"ssm": "fed-lm-ssm-smoke", "moe": "fed-lm-moe-smoke"}
WORLD = dict(samples=240, clients=6, alpha=0.3, seed=0, seq=16)
SIM = dict(num_clients=6, horizon=2_000.0, eval_every=1_000.0, seed=0,
           local_epochs=2, batch_size=8)
PSA = dict(queue_len=10)
POLICIES = ("fedasync", "fedpsa")
ENGINES = [("sequential", "vmap"), ("cohort", "vmap"), ("cohort", "grouped")]
COUNTERS = ("versions", "dispatches", "dropped", "launched")
RTOL, ATOL = 1e-4, 1e-3


def init_path(family: str) -> str:
    return os.path.join(HERE, "torch_fixtures",
                        f"fed_lm_{family}_smoke_init_seed0.npz")


def digests_path(family: str) -> str:
    return os.path.join(HERE, "torch_fixtures", f"fed_lm_{family}_digests.json")


def build_world(build, family: str):
    W = WORLD
    return build(FAMILIES[family], W["samples"], W["alpha"], W["clients"],
                 W["seed"], seq_len=W["seq"])


def reference_init(family: str) -> dict:
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(WORLD["seed"]),
                           rget(FAMILIES[family]))
    return jax.tree_util.tree_map(np.asarray, p)


def reference_run(family: str, name: str, world=None, **sim) -> dict:
    """The reference's run (sequential engine, legacy threefry init):
    digests, accuracies and the counters; ``sim`` overrides ``SIM``'s
    fields (a sweep lane's ``seed`` on the shared ``timeline_seed``)."""
    cfg, clients, test, calib = world or build_world(r_build_task, family)
    kw = (dict(psa_cfg=RPSA(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    with jax.threefry_partitionable(False):
        params = RM.init_params(jax.random.PRNGKey(WORLD["seed"]),
                                rget(FAMILIES[family]))
        res = r_run(name, cfg, params, clients, test,
                    RSim(engine="sequential", record_trajectory=True,
                         **{**SIM, **sim}),
                    **kw)
    return {"digests": np.asarray(res.digests, np.float64).tolist(),
            "accuracies": [float(a) for a in res.accuracies],
            "final": {**{k: int(getattr(res, k)) for k in COUNTERS},
                      "final_accuracy": float(res.final_accuracy),
                      "aulc": float(res.aulc)}}


def check_run(res, want) -> None:
    """A port run against a reference run: counters exact, digests at the
    golden suite's RTOL/ATOL, accuracies within 2e-3."""
    for key in COUNTERS:
        assert getattr(res, key) == want["final"][key], key
    got, exp = np.asarray(res.digests), np.asarray(want["digests"])
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.accuracies, want["accuracies"], atol=2e-3)
    np.testing.assert_allclose(res.final_accuracy,
                               want["final"]["final_accuracy"], atol=2e-3)


def check_fixture(family: str, name: str, live: dict) -> None:
    """The committed fixture is the live reference run."""
    with open(digests_path(family)) as fh:
        fix = json.load(fh)
    assert fix["model"] == FAMILIES[family]
    assert fix["world"] == WORLD and fix["sim"] == SIM and fix["psa"] == PSA
    want = fix["policies"][name]
    assert live["final"] == want["final"]
    np.testing.assert_allclose(live["digests"], want["digests"], rtol=1e-6,
                               atol=0)
    assert live["accuracies"] == want["accuracies"]


def write_fixtures(family: str) -> None:
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key, val in tree.items():
                walk(val, prefix + (key,))
        else:
            flat[".".join(prefix)] = np.asarray(tree, np.float32)

    walk(reference_init(family), ())
    np.savez(init_path(family), **flat)
    world = build_world(r_build_task, family)
    fixture = {"model": FAMILIES[family], "world": WORLD, "sim": SIM,
               "psa": PSA, "engine": "sequential",
               "policies": {n: reference_run(family, n, world)
                            for n in POLICIES}}
    with open(digests_path(family), "w") as fh:
        json.dump(fixture, fh, indent=1)
        fh.write("\n")
    print(f"wrote {init_path(family)} and {digests_path(family)}")


if __name__ == "__main__":
    for fam in FAMILIES:
        write_fixtures(fam)
