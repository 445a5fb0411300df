"""The simulator's ``engine="cohort"`` in the port against the reference.

On the golden world (``tests/test_golden.py``'s constants and the
reference's legacy-threefry init): the cohort engine reproduces the
committed goldens of all seven async policies with both member kernels, matches the port's sequential
engine event for event (with dropouts, and with a receive_hook), and
matches a live reference cohort run's counters. Tolerances are the golden
suite's ``RTOL=1e-4, ATOL=1e-3`` on digests; counters are exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.common import tree as rtu
from repro.configs import get_config as rget
from repro.core import psa as rpsa
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.federated.simulator import make_sketch_fn_flat as r_sketch_flat
from repro.models import model as RM
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import simulator as tsim
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.kernels import ops
from repro_torch.models import member_math as tmm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
# tests/test_golden.py's world (the constants the digests were made with)
GOLDEN = dict(samples=1_500, classes=10, dim=32, clients=8, alpha=0.3, seed=0)
SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
RTOL, ATOL = 1e-4, 1e-3
POLICIES = ["fedpsa", "fedbuff", "fedasync", "ca2fl", "fedfa", "fedpac",
            "asyncfeded"]


def _golden_init():
    """The golden world's reference init (JAX's legacy threefry, which the
    committed digests were made with)."""
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(GOLDEN["seed"]),
                           rget("paper-synthetic-mlp"))
    return jax.tree_util.tree_map(np.asarray, p)


def _golden_world(lib):
    W = GOLDEN
    full = lib.make_classification(W["samples"], W["classes"], W["dim"],
                                   seed=W["seed"], class_sep=0.7)
    train, test = lib.train_test_split(full, 0.1)
    parts = lib.dirichlet_partition(train, W["clients"], alpha=W["alpha"],
                                    seed=W["seed"])
    clients = [lib.ClientDataset(train.subset(ix)) for ix in parts]
    calib = lib.make_calibration_batch(train, 64, "gaussian")
    return clients, test, calib


@pytest.fixture(scope="module")
def golden_world():
    clients, test, calib = _golden_world(tdata)
    return tget("paper-synthetic-mlp"), clients, test, calib, _golden_init()


def _run(world, name, receive_hook=None, **sim):
    cfg, clients, test, calib, params = world
    kw = (dict(psa_cfg=PSAConfig(queue_len=10), calib_batch=calib)
          if name == "fedpsa" else {})
    return run_algorithm(name, cfg, params_from_numpy(params), clients, test,
                         SimConfig(device="cpu", record_trajectory=True,
                                   **{**SIM, **sim}),
                         receive_hook=receive_hook, **kw)


def _orders(res):
    return [(e["t"], e["client"], e["tau"]) for e in res.receive_log]


@pytest.mark.parametrize("mode", tmm.MODES)
@pytest.mark.parametrize("name", POLICIES)
def test_cohort_run_matches_golden(golden_world, name, mode):
    res = _run(golden_world, name, engine="cohort", member_kernel=mode)
    with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
        golden = json.load(f)
    assert res.engine == "cohort" and res.cohorts > 0
    assert len(res.digests) == len(golden["digests"])
    np.testing.assert_allclose(np.asarray(res.digests),
                               np.asarray(golden["digests"]), rtol=RTOL,
                               atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(res, key) == golden["final"][key], key
    np.testing.assert_allclose(res.final_accuracy,
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc, golden["final"]["aulc"], atol=2e-3)
    if name == "fedpsa":
        assert len(res.server_log) == res.versions


@pytest.mark.parametrize("case", ["fedbuff", "fedbuff-hetero", "fedbuff-hook"])
def test_cohort_matches_sequential(golden_world, case):
    """Same receive order, versions, dispatches, dropouts and eval times as
    the port's sequential engine; accuracies within 1e-4. With a
    receive_hook, the hook sees the same pre-receive server state and
    metas on both engines (the cohort engine then flushes per event)."""
    name = case.split("-")[0]
    avail = (dict(availability_kind="hetero", dropout_rate=0.3)
             if case.endswith("hetero") else {})
    runs, seen = [], []
    for engine in ("sequential", "cohort"):
        hooked = []
        kw = {}
        if case.endswith("hook"):
            kw["receive_hook"] = lambda server, w, delta, meta, t: hooked.append(
                (t, server.version, meta["tau"], meta["client_id"],
                 float(FlatSpec(delta).flatten(delta).norm())))
        runs.append(_run(golden_world, name, engine=engine, **avail, **kw))
        seen.append(hooked)
    seq, coh = runs
    assert _orders(seq) == _orders(coh)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(seq, key) == getattr(coh, key), key
    if avail:
        assert coh.dropped > 0
    assert seq.times == coh.times
    np.testing.assert_allclose(coh.accuracies, seq.accuracies, atol=1e-4)
    np.testing.assert_allclose(np.asarray(coh.digests),
                               np.asarray(seq.digests), rtol=RTOL, atol=ATOL)
    assert [h[:4] for h in seen[0]] == [h[:4] for h in seen[1]]
    np.testing.assert_allclose([h[4] for h in seen[1]],
                               [h[4] for h in seen[0]], rtol=1e-4)
    if case.endswith("hook"):
        assert len(seen[1]) == coh.dispatches


def test_cohort_counters_match_live_reference(golden_world):
    """A dropout run on the cohort engine against the reference's live
    cohort run: cohorts and every counter exact, digests within the golden
    tolerance; launch counts stay 0 on the CPU path."""
    avail = dict(availability_kind="hetero", dropout_rate=0.3)
    rclients, rtest, _ = _golden_world(rdata)
    want = r_run("fedbuff", rget("paper-synthetic-mlp"), golden_world[4],
                 rclients, rtest, RSim(engine="cohort", record_trajectory=True,
                                       **avail, **SIM))
    ops.reset_launch_counts()
    got = _run(golden_world, "fedbuff", engine="cohort",
               member_kernel="grouped", **avail)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert want.engine == got.engine == "cohort"
    for key in ("cohorts", "versions", "dispatches", "dropped", "launched"):
        assert getattr(got, key) == getattr(want, key), key
    assert _orders(got) == _orders(want)
    np.testing.assert_allclose(np.asarray(got.digests),
                               np.asarray(want.digests), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_sensitivity", [True, False])
def test_member_batched_sketch_matches_reference(golden_world, use_sensitivity):
    """The wave sketch (``make_sketch_fn_flat``: one member-batched gradient
    pass plus the Fisher microbatches for the whole wave, one sens_sketch
    call) of a 3-member wave against the reference's ``make_sketch_fn_flat``
    (a jitted vmap of client_sketch) on the golden world's
    paper-synthetic-mlp, at the client-sketch tolerance of
    tests/test_torch_core.py (rtol 1e-5, atol 1e-5 * max|want|)."""
    cfg, clients, test, calib, params = golden_world
    kw = dict(queue_len=10, use_sensitivity=use_sensitivity)
    rspec = rtu.FlatSpec(params)
    spec = FlatSpec(params_from_numpy(params))
    base = np.asarray(rspec.flatten(params), np.float32)
    rng = np.random.RandomState(7)
    w = np.stack([base + 0.05 * i * rng.randn(base.size) for i in range(3)]
                 ).astype(np.float32)
    want = np.asarray(r_sketch_flat(rget("paper-synthetic-mlp"), calib,
                                    rpsa.PSAConfig(**kw), rspec)(jnp.asarray(w)))
    got = tsim.make_sketch_fn_flat(cfg, calib, PSAConfig(**kw), spec,
                                   "cpu")(torch.from_numpy(w)).numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("engine", ["sequential", "cohort"])
def test_sketch_is_one_call_per_tree_and_per_wave(golden_world, monkeypatch,
                                                  engine):
    """Wrapping the sketch entry counts one call per sketched model on the
    sequential engine (receives + aggregations + the initial global model)
    and one per wave on the cohort engine (waves + aggregations + 1), each
    wave's call holding all its members."""
    calls = []
    real = ops.sens_sketch_rows

    def counted(w, g, f, table):
        calls.append(int(w.shape[0]))
        return real(w, g, f, table)

    monkeypatch.setattr(ops, "sens_sketch_rows", counted)
    res = _run(golden_world, "fedpsa", engine=engine, horizon=3_000.0)
    assert res.versions > 0 and res.dispatches > 0
    if engine == "sequential":
        assert calls == [1] * (res.dispatches + res.versions + 1)
    else:
        assert len(calls) == res.cohorts + res.versions + 1
        assert sum(calls) == res.dispatches + res.versions + 1
        assert max(calls) > 1
