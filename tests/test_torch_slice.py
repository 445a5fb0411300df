"""The port's first slice end to end against the JAX reference.

* the numpy host layers the port copies (data, latency, timeline,
  scheduler) give the reference's exact arrays and streams;
* the port's sequential ``run_algorithm`` reproduces the committed golden
  digests of ``tests/golden/<policy>.json`` on the CPU, for all seven
  async policies;
* the committed initial-weights fixture (what ``chip_smoke.py`` runs the
  goldens from, since it imports no JAX) is the reference's init, and the
  committed asyncfeded digest streams of the metrics with no golden
  (cosine, sketch) are what the reference's live run gives; the port
  reproduces them on the CPU on both engines (and on a card, ``gpu``);
* unported paths raise, a CUDA request without a card raises, the CLI
  defaults to the reference's cohort engine, and the port imports neither
  ``jax`` nor ``repro``.
"""
import ast
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.configs import get_config as rget
from repro.federated import latency as rlat
from repro.federated import scheduler as rsched
from repro.federated import timeline as rtl
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params, params_from_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import latency as tlat
from repro_torch.federated import scheduler as tsched
from repro_torch.federated.servers import make_server
from repro_torch.federated import timeline as ttl
from repro_torch.federated.simulator import (SimConfig, run_algorithm,
                                             run_sweep)
from repro_torch.launch.train import build_task as t_build_task

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                       "paper_synthetic_mlp_init_seed0.npz")
# asyncfeded's metrics without a golden: digest streams the reference made
# on the golden world (regenerate with `python tests/test_torch_slice.py`)
ASYNCFEDED_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                                  "asyncfeded_{}_digests.json")
# tests/test_golden.py's world (the constants the digests were made with)
WORLD = dict(model="paper-synthetic-mlp", samples=1_500, classes=10, dim=32,
             clients=8, alpha=0.3, seed=0)
SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
PSA = dict(queue_len=10)
RTOL, ATOL = 1e-4, 1e-3
# every async policy with a committed golden (the first two, PR by PR, first)
POLICIES = ["fedpsa", "fedbuff", "fedasync", "ca2fl", "fedfa", "fedpac",
            "asyncfeded"]


def _reference_init():
    """The reference's initial weights of the golden world. The committed
    digests were made with JAX's non-partitionable threefry, the default
    before JAX 0.5; later JAX versions draw other values from the same key,
    so the legacy stream is selected (scoped) for this draw."""
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(WORLD["seed"]),
                           rget(WORLD["model"]))
    return jax.tree_util.tree_map(np.asarray, p)


def _world(lib):
    full = lib.make_classification(WORLD["samples"], WORLD["classes"],
                                   WORLD["dim"], seed=WORLD["seed"],
                                   class_sep=0.7)
    train, test = lib.train_test_split(full, 0.1)
    parts = lib.dirichlet_partition(train, WORLD["clients"],
                                    alpha=WORLD["alpha"], seed=WORLD["seed"])
    calib = lib.make_calibration_batch(train, 64, "gaussian")
    return full, train, test, parts, calib


@pytest.fixture(scope="module")
def torch_world():
    _, train, test, parts, calib = _world(tdata)
    clients = [tdata.ClientDataset(train.subset(ix)) for ix in parts]
    return tget(WORLD["model"]), clients, test, calib


def test_data_copies_match_reference():
    for a, b in zip(_world(rdata), _world(tdata)):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.y, b.y)
    full = tdata.make_classification(300, 10, 32, seed=1)
    for x, y in zip(rdata.iid_partition(full, 5, 2), tdata.iid_partition(full, 5, 2)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(rdata.epoch_batch_indices(37, 3, 8, 5),
                                  tdata.epoch_batch_indices(37, 3, 8, 5))
    rb = list(rdata.ClientDataset(full.subset(np.arange(40))).epochs(2, 16, 3))
    tb = list(tdata.ClientDataset(full.subset(np.arange(40))).epochs(2, 16, 3))
    for a, b in zip(rb, tb):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


def test_build_task_matches_reference_cnn_world():
    r = r_build_task("paper-cifar10-cnn", 400, 0.1, 5, 3)
    t = t_build_task("paper-cifar10-cnn", 400, 0.1, 5, 3)
    assert [len(c) for c in r[1]] == [len(c) for c in t[1]]
    for a, b in zip(r[1], t[1]):
        np.testing.assert_array_equal(a.data.x, b.data.x)
    np.testing.assert_array_equal(r[2].x, t[2].x)
    for k in r[3]:
        np.testing.assert_array_equal(r[3][k], t[3][k])


@pytest.mark.parametrize("avail", [("always", 0.0), ("hetero", 0.3),
                                   ("slow-fragile", 0.2), ("trace", 0.2)])
@pytest.mark.parametrize("sched", [("uniform", None), ("period", None),
                                   ("staleness", {"staleness_weight": 1.5})])
def test_streams_and_schedulers_match_reference(avail, sched):
    sim = SimConfig(num_clients=30, latency_kind="lognormal", seed=4,
                    availability_kind=avail[0], dropout_rate=avail[1],
                    scheduler=sched[0], scheduler_params=sched[1])
    rs, ts = rsched.make_streams(sim), tsched.make_streams(sim)
    np.testing.assert_array_equal(rs.lat_means, ts.lat_means)
    np.testing.assert_array_equal(rs.avail, ts.avail)
    sizes = np.arange(1, 31, dtype=np.float64)
    scheds = []
    for mod, st in ((rsched, rs), (tsched, ts)):
        s = mod.make_scheduler(sim)
        s.bind(num_clients=30, rng=st.rng, latency_means=st.lat_means,
               avail_probs=st.avail, data_sizes=sizes)
        scheds.append(s)
    rng = np.random.RandomState(0)
    for step in range(25):
        n = int(rng.randint(1, 6))
        t = np.sort(rng.uniform(0, 5000, size=n))
        v = np.full(n, step)
        np.testing.assert_array_equal(scheds[0].launch_times(t),
                                      scheds[1].launch_times(t))
        cids = scheds[0].select(t, v)
        np.testing.assert_array_equal(cids, scheds[1].select(t, v))
        np.testing.assert_array_equal(rs.latency.sample_for(cids),
                                      ts.latency.sample_for(cids))
        np.testing.assert_array_equal(rs.avail_rng.rand(n), ts.avail_rng.rand(n))
        if rs.use_trace:
            np.testing.assert_array_equal(rs.trace.on_at(cids, t),
                                          ts.trace.on_at(cids, t))


def test_timeline_order_matches_reference():
    rng = np.random.RandomState(1)
    rt, tt = rtl.Timeline(), ttl.Timeline()
    seq = 0
    popped = ([], [])
    for _ in range(40):
        n = int(rng.randint(1, 5))
        args = (np.round(rng.uniform(0, 100, size=n), 1),
                np.arange(seq, seq + n), rng.randint(0, 9, size=n),
                rng.randint(0, 4, size=n), rng.rand(n) < 0.8)
        seq += n
        rt.extend_arrays(*args, [None] * n)
        tt.extend_arrays(*args, [None] * n)
        for _ in range(int(rng.randint(0, 4))):
            if rt:
                popped[0].append(tuple(rt.pop()))
                popped[1].append(tuple(tt.pop()))
    while rt:
        popped[0].append(tuple(rt.pop()))
        popped[1].append(tuple(tt.pop()))
    assert not tt and popped[0] == popped[1]
    assert rlat._subseed(7, 3) == tlat._subseed(7, 3)


def test_npz_fixture_is_the_reference_init():
    want = _reference_init()
    got = load_npz_params(FIXTURE)
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k])
        for kk in want[k]:
            np.testing.assert_array_equal(got[k][kk].numpy(), want[k][kk])


@pytest.mark.parametrize("name", POLICIES)
def test_sequential_run_matches_golden(torch_world, name):
    cfg, clients, test, calib = torch_world
    kw = dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib) if name == "fedpsa" else {}
    sim = SimConfig(engine="sequential", record_trajectory=True, device="cpu",
                    **SIM)
    res = run_algorithm(name, cfg, params_from_numpy(_reference_init()),
                        clients, test, sim, **kw)
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    assert len(res.digests) == len(golden["digests"])
    np.testing.assert_allclose(np.asarray(res.digests),
                               np.asarray(golden["digests"]), rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(res, key) == golden["final"][key], key
    np.testing.assert_allclose(res.final_accuracy,
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc, golden["final"]["aulc"], atol=2e-3)
    if name == "fedpsa":
        assert len(res.server_log) == res.versions
        assert all(abs(e["weights"].sum() - 1.0) < 1e-5 for e in res.server_log)
    if name in ("fedasync", "asyncfeded"):   # one host-float entry a receive
        assert len(res.server_log) == res.versions == res.dispatches
        assert all(isinstance(e["weight"], float) for e in res.server_log)


def _reference_asyncfeded(metric):
    """The reference's sequential asyncfeded run on the golden world, with
    the legacy-threefry init: digests, final counters and the per-receive
    mixing coefficients."""
    from repro.federated import SimConfig as RSim, run_algorithm as r_run
    _, rtrain, rtest, rparts, _ = _world(rdata)
    rclients = [rdata.ClientDataset(rtrain.subset(ix)) for ix in rparts]
    res = r_run("asyncfeded", rget(WORLD["model"]), _reference_init(),
                rclients, rtest, RSim(engine="sequential",
                                      record_trajectory=True, **SIM),
                server_kwargs={"metric": metric})
    return {"world": WORLD, "sim": SIM, "policy": "asyncfeded",
            "server_kwargs": {"metric": metric},
            "digests": np.asarray(res.digests).tolist(),
            "weights": [e["weight"] for e in res.server_log],
            "final": {"final_accuracy": res.final_accuracy,
                      "versions": res.versions, "dispatches": res.dispatches,
                      "dropped": res.dropped, "launched": res.launched,
                      "aulc": res.aulc}}


def _load_asyncfeded(metric):
    with open(ASYNCFEDED_FIXTURE.format(metric)) as f:
        return json.load(f)


def _check_against(res, want, weights_rtol=1e-4):
    """Golden tolerance on digests, counters exact, accuracy and AULC
    within 2e-3, and the mixing coefficients within ``weights_rtol``."""
    assert len(res.digests) == len(want["digests"])
    np.testing.assert_allclose(np.asarray(res.digests),
                               np.asarray(want["digests"]), rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(res, key) == want["final"][key], key
    np.testing.assert_allclose(res.final_accuracy,
                               want["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc, want["final"]["aulc"], atol=2e-3)
    np.testing.assert_allclose([e["weight"] for e in res.server_log],
                               want["weights"], rtol=weights_rtol)


@pytest.mark.parametrize("metric", ["cosine", "sketch"])
def test_asyncfeded_fixture_is_the_reference_run(metric):
    """The committed digest stream is what the reference's live run gives
    (golden tolerance), and it is not the l2 metric's: the per-receive
    coefficients tell the metrics apart."""
    want = _reference_asyncfeded(metric)
    fixture = _load_asyncfeded(metric)
    assert fixture["server_kwargs"] == {"metric": metric}
    assert fixture["world"] == WORLD and fixture["sim"] == SIM
    np.testing.assert_allclose(fixture["digests"], want["digests"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fixture["weights"], want["weights"], rtol=1e-4)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert fixture["final"][key] == want["final"][key], key
    for key in ("final_accuracy", "aulc"):
        np.testing.assert_allclose(fixture["final"][key], want["final"][key],
                                   atol=2e-3)
    l2 = _reference_asyncfeded("l2")["weights"]
    assert np.max(np.abs(np.asarray(l2) - fixture["weights"])) > 1e-2


def _port_asyncfeded(torch_world, metric, engine, mk="vmap", device="cpu"):
    cfg, clients, test, calib = torch_world
    sim = SimConfig(engine=engine, member_kernel=mk, record_trajectory=True,
                    device=device, **SIM)
    return run_algorithm("asyncfeded", cfg, params_from_numpy(_reference_init()),
                         clients, test, sim, server_kwargs={"metric": metric})


@pytest.mark.parametrize("engine", ["sequential", "cohort-vmap",
                                    "cohort-grouped"])
@pytest.mark.parametrize("metric", ["cosine", "sketch"])
def test_asyncfeded_metric_run_matches_fixture(torch_world, metric, engine):
    res = _port_asyncfeded(torch_world, metric, *engine.split("-"))
    assert res.engine == engine.split("-")[0]
    _check_against(res, _load_asyncfeded(metric))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cosine", "sketch"])
def test_asyncfeded_metric_run_matches_fixture_on_card(torch_world, metric):
    """The same runs on the card: the sketch metric launches sens_sketch
    once per receive (dw and the drift in one launch), and no run launches
    buffer_agg."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ops
    for engine, mk in (("sequential", "vmap"), ("cohort", "vmap"),
                       ("cohort", "grouped")):
        ops.reset_launch_counts()
        res = _port_asyncfeded(torch_world, metric, engine, mk, device="cuda")
        counts = ops.launch_counts()
        _check_against(res, _load_asyncfeded(metric))
        assert counts["sens_sketch"] == (res.dispatches if metric == "sketch"
                                         else 0)
        assert counts["buffer_agg"] == 0
        assert (counts["grouped_matmul"] > 0) == (mk == "grouped")


def test_dropout_run_matches_reference(torch_world):
    """A run with client dropouts (the availability stream and held-slot
    re-dispatch) against the reference's live sequential run."""
    from repro.federated import SimConfig as RSim, run_algorithm as r_run
    cfg, clients, test, calib = torch_world
    _, rtrain, rtest, rparts, _ = _world(rdata)
    rclients = [rdata.ClientDataset(rtrain.subset(ix)) for ix in rparts]
    kw = dict(availability_kind="hetero", dropout_rate=0.3,
              record_trajectory=True, engine="sequential", **SIM)
    params = _reference_init()
    want = r_run("fedbuff", rget(WORLD["model"]), params, rclients, rtest,
                 RSim(**kw))
    got = run_algorithm("fedbuff", cfg, params_from_numpy(params), clients,
                        test, SimConfig(device="cpu", **kw))
    assert want.dropped > 0
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_allclose(np.asarray(got.digests), np.asarray(want.digests),
                               rtol=RTOL, atol=ATOL)


def test_cuda_without_a_card_raises(torch_world, monkeypatch):
    cfg, clients, test, calib = torch_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SimConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_algorithm("fedbuff", cfg, load_npz_params(FIXTURE), clients, test,
                      SimConfig(engine="sequential", **SIM))


@pytest.mark.parametrize("case", ["mesh", "shard_size", "shard_size_cohort",
                                  "checkpoint", "fedavg", "fedasync", "sweep",
                                  "token_arch", "cohort_family"])
def test_unported_paths_raise(torch_world, case):
    cfg, clients, test, calib = torch_world
    sim = SimConfig(engine="sequential", device="cpu", **SIM)
    name = "fedbuff"
    if case == "token_arch":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tget("fed-lm-smoke")
        return
    if case == "sweep":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_sweep("fedbuff", cfg, None, clients, test, sim, None)
        return
    sim = {"mesh": dataclasses.replace(sim, mesh=object()),
           "shard_size": dataclasses.replace(sim, shard_size=3),
           "shard_size_cohort": dataclasses.replace(sim, shard_size=3,
                                                    engine="cohort"),
           "checkpoint": dataclasses.replace(sim, checkpoint_dir="ckpt")
           }.get(case, sim)
    if case == "fedasync":
        # every policy is ported; its server on a mesh is not (item 9)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_server("fedasync", load_npz_params(FIXTURE), mesh=object())
        return
    if case == "fedavg":
        name = case
    if case == "cohort_family":  # a family the port's registry lacks
        cfg = dataclasses.replace(cfg, family="dense")
        sim = dataclasses.replace(sim, engine="cohort")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_algorithm(name, cfg, load_npz_params(FIXTURE), clients, test, sim)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    scanned = {os.path.relpath(f, ROOT).replace(os.sep, "/") for f in files}
    for mod in ("models/layers.py", "kernels/flash_attention.py",
                "launch/serve.py", "configs/phi4_mini_38b.py"):
        assert f"src/repro_torch/{mod}" in scanned, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


def test_cli_default_engine_runs(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train
    monkeypatch.setattr("sys.argv", [
        "train", "--alg", "fedbuff", "--device", "cpu", "--samples", "300",
        "--clients", "4", "--horizon", "1500", "--out", str(tmp_path)])
    train.main()
    (path,) = tmp_path.glob("*.json")
    rec = json.load(open(path))
    assert rec["engine"] == "cohort" and rec["versions"] >= 1
    assert "final=" in capsys.readouterr().out


if __name__ == "__main__":
    # regenerate the asyncfeded digest fixtures from the reference
    for m in ("cosine", "sketch"):
        with open(ASYNCFEDED_FIXTURE.format(m), "w") as fh:
            json.dump(_reference_asyncfeded(m), fh, indent=1)
            fh.write("\n")
