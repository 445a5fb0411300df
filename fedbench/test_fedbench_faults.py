"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU, once for each fault a cell can have (one chip: no exchange
between chips to leave out)."""
import time

import pytest

from fedbench import run
from fedbench.discover import load_cell
from fedbench.faults import CATCHES, FAULTS, applies
from fedbench.testing import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


MIXES = ("fedpsa", "fedasync", "fedpsa.sweep3")
CASES = [pytest.param(mix, fault, id=f"{mix}-{fault}")
         for mix in MIXES for fault in sorted(FAULTS)
         if applies(fault, mix.split(".")[0])]


@pytest.mark.parametrize("mix,fault", CASES)
def test_fault_is_not_correct(root, mix, fault):
    cell = load_cell(root, f"tiny.{mix}")
    with FAULTS[fault]():
        out = run.run(cell, 41, 0.1, False, "cpu",
                      t_start=time.perf_counter())
    assert out["correct"] is False
    failed = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert CATCHES[fault][1] & set(failed)
