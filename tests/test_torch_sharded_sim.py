"""The port's simulator on a mesh (``SimConfig.mesh``) against the goldens,
on gloo process groups of CPU ranks (``tests/torch_dist.py``).

The mesh-sharded server with the data-parallel cohort engine reproduces
the committed goldens of all seven async policies (``tests/golden/``,
made by the reference's sequential oracle; ``tests/test_golden.py``
holds the reference's sharded runs to them the same way) on 2 and 4
ranks (d = 4,522: 4 ranks pad the last shard), with counters exact and
every rank returning the same run; the sequential engine does for fedpsa
and fedbuff on 2 ranks, and ``run_fedavg`` reproduces the reference's
FedAvg fixture. A mesh run checkpointed, pruned to a mid-run snapshot and
resumed equals the unbroken mesh run, and its snapshot (rank 0's,
unpadded) resumes on one device too. A wave splits over the ranks only
into shares of whole buckets, and then trains to the single-device
engine's parameters. Tolerances are the golden suite's ``RTOL=1e-4,
ATOL=1e-3``.
"""
import json
import os

import numpy as np
import pytest

from repro_torch.federated.simulator import SimConfig, run_algorithm
from torch_dist import GOLDEN_SIM, Ranks, _golden_world
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL, ATOL = 1e-4, 1e-3
POLICIES = ["fedpsa", "fedbuff", "fedasync", "ca2fl", "fedfa", "fedpac",
            "asyncfeded"]
COHORT = [("golden", p, "cohort", "grouped") for p in POLICIES]
SEQUENTIAL = [("golden", p, "sequential", "vmap") for p in ("fedpsa",
                                                            "fedbuff")]
# waves of 4, 8 and 16 members: a wave splits over n ranks only into
# shares of whole buckets (4 members)
SPLITS = [("split", B) for B in (8, 16)]
FEDAVG = ("fedavg",)
RESUME = ("resume", "ca2fl", "cohort", "grouped")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every rank's ``sim_program`` results: {2: ..., 4: ...} (the two
    jobs side by side) and the pruned snapshot directory of the 2-rank
    resume case."""
    ckdir = str(tmp_path_factory.mktemp("ckpt"))
    two = Ranks(2, "sim_program", {
        "cases": COHORT + SEQUENTIAL + SPLITS + [FEDAVG, RESUME],
        "ckdir": ckdir}, tmp_path_factory.mktemp("ranks2"))
    four = Ranks(4, "sim_program", {"cases": COHORT + SPLITS},
                 tmp_path_factory.mktemp("ranks4"))
    return {2: two.results(), 4: four.results(), "ckdir": ckdir}


def _golden(name: str) -> dict:
    with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as fh:
        return json.load(fh)


def _same_on_every_rank(ranks, case) -> dict:
    first = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == first, case
    return first


def _check_golden(res: dict, golden: dict) -> None:
    got, want = np.asarray(res["digests"]), np.asarray(golden["digests"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert res[key] == golden["final"][key], key
    np.testing.assert_allclose(res["final_accuracy"],
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res["aulc"], golden["final"]["aulc"],
                               atol=2e-3)
    if "weights" in golden:
        np.testing.assert_allclose(res["weights"], golden["weights"],
                                   rtol=1e-4)


@pytest.mark.parametrize("n", (2, 4), ids=["n2", "n4"])
@pytest.mark.parametrize("name", POLICIES)
def test_mesh_cohort_matches_golden(mesh_runs, name, n):
    case = ("golden", name, "cohort", "grouped")
    res = _same_on_every_rank(mesh_runs[n], case)
    assert res["engine"] == "cohort" and res["cohorts"] > 0
    _check_golden(res, _golden(name))


@pytest.mark.parametrize("n", (2, 4), ids=["n2", "n4"])
@pytest.mark.parametrize("B", (8, 16))
def test_data_parallel_wave_matches_one_device(mesh_runs, B, n):
    """A wave splits into whole-bucket shares (B = 8 on 2 ranks, 16 on 2
    and 4) and trains to the single-device engine's parameters; a wave of
    8 on 4 ranks trains whole on every rank, as the golden world's waves
    of 4 do. ``map_members`` follows the same rule."""
    for r in mesh_runs[n]:
        out = r[("split", B)]
        assert out["split"] == (B % (4 * n) == 0)
        assert out["split_waves"] == int(out["split"])   # the engine's count
        assert out["deltas"] <= 1e-6 and out["params"] <= 1e-6, out
        assert out["mapped"] == 0.0


@pytest.mark.parametrize("name", ("fedpsa", "fedbuff"))
def test_mesh_sequential_matches_golden(mesh_runs, name):
    res = _same_on_every_rank(mesh_runs[2],
                              ("golden", name, "sequential", "vmap"))
    assert res["engine"] == "sequential" and res["cohorts"] == 0
    _check_golden(res, _golden(name))


def test_mesh_fedavg_matches_fixture(mesh_runs):
    """The data-parallel FedAvg waves against the reference's live
    ``run_fedavg`` (``tests/torch_fixtures/fedavg_golden_world.json``):
    times and counters exact, accuracies within 2e-3, each evaluated
    model's digest at the golden tolerance."""
    with open(os.path.join(ROOT, "tests", "torch_fixtures",
                           "fedavg_golden_world.json")) as fh:
        want = json.load(fh)
    res = _same_on_every_rank(mesh_runs[2], FEDAVG)
    assert res["times"] == want["times"]
    for key in ("versions", "dispatches", "launched"):
        assert res[key] == want[key], key
    np.testing.assert_allclose(res["accuracies"], want["accuracies"],
                               atol=2e-3)
    np.testing.assert_allclose(res["final_accuracy"], want["final_accuracy"],
                               atol=2e-3)
    np.testing.assert_allclose(res["eval_digests"], want["digests"],
                               rtol=RTOL, atol=ATOL)


def test_mesh_resume_equals_unbroken_run(mesh_runs):
    """ca2fl (a ring, the per-client cache and its total, all sharded):
    the unbroken run is the cohort/grouped golden case's."""
    out = _same_on_every_rank(mesh_runs[2], RESUME)
    base = mesh_runs[2][0][("golden",) + RESUME[1:]]
    assert out["checkpointed"] == base   # checkpoints do not perturb the run
    steps = sorted(int(d.split("_")[1])
                   for d in os.listdir(mesh_runs["ckdir"]))
    assert 0 < steps[-1] < base["dispatches"]
    # digests, times, counters, the receive log; the policy's own log is
    # not checkpointed (a resumed run's covers the part after the resume)
    res = {k: v for k, v in out["resumed"].items() if k != "weights"}
    assert res == {k: v for k, v in base.items() if k != "weights"}


def test_mesh_checkpoint_resumes_on_one_device(mesh_runs):
    """The 2-rank run's snapshot holds the unpadded state in the
    single-device layout: a run on one device resumes from it and ends
    where the unbroken mesh run ends, within the golden tolerance."""
    base = mesh_runs[2][0][("golden",) + RESUME[1:]]
    cfg, clients, test, calib, params = _golden_world()
    res = run_algorithm(RESUME[1], cfg, params, clients, test, SimConfig(
        device="cpu", record_trajectory=True, member_kernel="grouped",
        checkpoint_dir=mesh_runs["ckdir"], checkpoint_every=1_500.0,
        resume=True, **GOLDEN_SIM))
    np.testing.assert_allclose(np.asarray(res.digests),
                               np.asarray(base["digests"]), rtol=RTOL,
                               atol=ATOL)
    for key in ("dispatches", "versions", "cohorts", "launched"):
        assert getattr(res, key) == base[key], key
    assert res.times == base["times"]

