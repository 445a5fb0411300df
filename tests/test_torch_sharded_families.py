"""The recurrent and MoE token families on a mesh (``SimConfig.mesh``), on
2 gloo ranks of CPU processes (``tests/torch_dist.py``).

``fed-lm-ssm-smoke`` and ``fed-lm-moe-smoke`` in the shared world of
``tests/torch_fedlm_families.py`` (240 sequences of 16 tokens, 6 clients,
horizon 2,000), from the committed legacy-threefry inits: fedasync and
fedpsa on the cohort engine under ``member_kernel`` "vmap" and "grouped",
with the mesh-sharded server (each rank holds half of the flat parameter
axis) and the data-parallel cohort engine. On 2 ranks every run equals the
single-device run: the same digests, accuracies, counters and log, bit for
bit (the world's waves are one client padded to 4 members, which train
whole on every rank, and every sum over d runs in one fixed order), on
every rank; and each holds the reference's sequential run
(``tests/torch_fixtures/fed_lm_<family>_digests.json``) at the golden
suite's ``RTOL=1e-4, ATOL=1e-3`` with the counters exact. The ranks run
while this process runs the single-device runs.
"""
import json

import numpy as np
import pytest

from torch_dist import (FAMILY_MODELS, FAMILY_SIM, FEDLM_PSA, FEDLM_WORLD,
                        Ranks, family_run)
from torch_fedlm_families import (COUNTERS, FAMILIES, PSA, POLICIES, SIM,
                                  WORLD, digests_path)
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-3
N = 2
CASES = [(f, p, mk) for f in FAMILIES for p in POLICIES
         for mk in ("vmap", "grouped")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the single-device results) of ``CASES``."""
    ranks = Ranks(N, "families_program", {"cases": CASES},
                  tmp_path_factory.mktemp("ranks"))
    one = {case: family_run(*case) for case in CASES}
    return ranks.results(), one


def test_rank_programs_share_the_families_constants():
    assert FAMILY_MODELS == FAMILIES and FAMILY_SIM == SIM
    assert FEDLM_PSA == PSA
    assert {k: FEDLM_WORLD[k] for k in WORLD} == WORLD


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_two_ranks_equal_one_device(runs, case):
    ranks, one = runs
    want = one[case]
    assert want["engine"] == "cohort" and want["cohorts"] > 0
    for r, res in enumerate(ranks):
        assert res[case] == want, (r, case)
    family, name, _ = case
    with open(digests_path(family)) as fh:
        ref = json.load(fh)["policies"][name]
    got, exp = np.asarray(want["digests"]), np.asarray(ref["digests"])
    assert got.shape == exp.shape and len(got) > 0
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    for key in COUNTERS:
        assert want[key] == ref["final"][key], key
    np.testing.assert_allclose(want["accuracies"], ref["accuracies"],
                               atol=2e-3)
