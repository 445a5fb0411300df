"""The dense token family on a mesh (``SimConfig.mesh``), on gloo process
groups of CPU ranks (``tests/torch_dist.py``).

The fed-lm world (``tests/test_golden.py``'s constants, the committed
legacy-threefry init): fedasync and fedpsa on the cohort engine under
``member_kernel="grouped"``, with the mesh-sharded server (d = 6,224, so 4
ranks hold shards of 1,556) and data-parallel waves, reproduce
``tests/golden/fed-lm-smoke.json`` on 2 and 4 ranks at the golden suite's
``RTOL=1e-4, ATOL=1e-3``, with the counters exact and every rank
returning the same run; fedpsa with ``sliding_window=8`` reproduces the
reference's windowed run (``tests/torch_fixtures/fed_lm_window8_digests.json``)
on 2 ranks. The world's waves are one client (padded to 4 members), so
they never split: waves of 8, 16 and 24 token members go through the
cohort engine with the mesh and without it, split only into shares of
whole buckets (on 2 ranks into 4, 8 and 12 members a rank; on 4 ranks 16
into 4, while 8 trains whole), and train to the single-device engine's
parameters. ``launch.train --arch fed-lm-smoke --mesh 2`` runs.
"""
import json
import os
import sys

import numpy as np
import pytest

from torch_dist import Ranks, run_command
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL, ATOL = 1e-4, 1e-3
GOLDEN = [("golden", p, "cohort", "grouped", 0)
          for p in ("fedasync", "fedpsa")]
WINDOWED = ("golden", "fedpsa", "cohort", "grouped", 8)
SPLITS = {2: [("split", B) for B in (8, 16, 24)],
          4: [("split", B) for B in (8, 16)]}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every rank's ``fedlm_program`` results on 2 and 4 ranks (the two
    jobs side by side)."""
    two = Ranks(2, "fedlm_program", {"cases": GOLDEN + [WINDOWED] + SPLITS[2]},
                tmp_path_factory.mktemp("ranks2"))
    four = Ranks(4, "fedlm_program", {"cases": GOLDEN + SPLITS[4]},
                 tmp_path_factory.mktemp("ranks4"))
    return {2: two.results(), 4: four.results()}


def _same_on_every_rank(ranks, case) -> dict:
    first = ranks[0][case]
    for r in ranks[1:]:
        assert r[case] == first, case
    return first


def _check(res: dict, want: dict) -> None:
    got, exp = np.asarray(res["digests"]), np.asarray(want["digests"])
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert res[key] == want["final"][key], key
    np.testing.assert_allclose(res["final_accuracy"],
                               want["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res["aulc"], want["final"]["aulc"], atol=2e-3)


@pytest.mark.parametrize("n", (2, 4), ids=["n2", "n4"])
@pytest.mark.parametrize("name", ("fedasync", "fedpsa"))
def test_mesh_fed_lm_matches_golden(mesh_runs, name, n):
    res = _same_on_every_rank(mesh_runs[n],
                              ("golden", name, "cohort", "grouped", 0))
    assert res["engine"] == "cohort" and res["cohorts"] > 0
    with open(os.path.join(ROOT, "tests", "golden",
                           "fed-lm-smoke.json")) as fh:
        _check(res, json.load(fh)["policies"][name])


def test_mesh_windowed_fed_lm_matches_reference(mesh_runs):
    res = _same_on_every_rank(mesh_runs[2], WINDOWED)
    with open(os.path.join(ROOT, "tests", "torch_fixtures",
                           "fed_lm_window8_digests.json")) as fh:
        fix = json.load(fh)
    assert fix["sliding_window"] == 8
    _check(res, fix["policies"]["fedpsa"])


@pytest.mark.parametrize("n,B", [(n, c[1]) for n in (2, 4)
                                 for c in SPLITS[n]])
def test_token_wave_splits_match_one_device(mesh_runs, n, B):
    """A token wave splits into whole-bucket shares (``B % (4 n) == 0``)
    and trains to the single-device engine's parameters at the image
    ``SPLITS``' tolerance; ``map_members`` follows the same rule."""
    for r in mesh_runs[n]:
        out = r[("split", B)]
        assert out["split"] == (B % (4 * n) == 0)
        assert out["split_waves"] == int(out["split"])
        assert out["deltas"] <= 1e-6 and out["params"] <= 1e-6, out
        assert out["mapped"] == 0.0


def test_cli_fed_lm_mesh_runs(tmp_path):
    """``--arch fed-lm-smoke --mesh 2 --dist-backend gloo --device cpu``:
    two spawned gloo ranks; rank 0 writes the run."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    proc = run_command(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "fed-lm-smoke", "--alg", "fedpsa", "--mesh", "2", "--dist-backend",
         "gloo", "--device", "cpu", "--samples", "240", "--clients", "6",
         "--alpha", "0.3", "--seq", "16", "--horizon", "1500", "--out",
         str(tmp_path)], env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (path,) = tmp_path.glob("fedpsa_fed-lm-smoke*_mesh2.json")
    rec = json.loads(path.read_text())
    assert rec["mesh_devices"] == 2 and rec["dispatches"] > 0
    assert rec["model"] == "fed-lm-smoke" and rec["engine"] == "cohort"
    assert proc.stdout.count("[train]") == 1
