"""Sweep lanes over the dense token family with ``sliding_window=8``, port
against the JAX reference, on the CPU.

The lanes of ``tests/test_torch_sweep_fedlm.py`` on the fed-lm world with
the window (240 sequences of 16 tokens, so the window bites): lane 0
reproduces the reference's windowed standalone runs
(``tests/torch_fixtures/fed_lm_window8_digests.json``, which
``tests/test_torch_window_fedlm.py`` holds to the live reference), and
every lane the reference's windowed ``run_sweep`` lanes
(``tests/torch_fixtures/fed_lm_sweep_digests.json``), at the golden
suite's ``RTOL=1e-4, ATOL=1e-3`` with the counters exact.
"""
import json
import os

import numpy as np
import pytest

from test_torch_sweep_fedlm import (COUNTERS, HERE, POLICIES, SIM, _check,
                                    fixture, port)  # noqa: F401
from test_torch_sweep_fedlm import \
    test_lanes_match_reference_sweep as _lanes_match_reference
from torch_threads import one_torch_thread  # noqa: F401

WINDOW = 8
WINDOW_FIXTURE = os.path.join(HERE, "torch_fixtures",
                              "fed_lm_window8_digests.json")


@pytest.mark.parametrize("name", POLICIES)
def test_windowed_sweep_lane0_matches_window_fixture(port, name):  # noqa: F811
    res = port("sweep", name, WINDOW)
    with open(WINDOW_FIXTURE) as fh:
        want = json.load(fh)
    assert want["sliding_window"] == WINDOW and want["sim"] == SIM
    want = want["policies"][name]
    _check(res.digests[0], want["digests"], res,
           {k: want["final"][k] for k in COUNTERS})
    np.testing.assert_allclose(res.lane_accuracies[0], want["accuracies"],
                               atol=2e-3)


@pytest.mark.parametrize("name", POLICIES)
def test_windowed_lanes_match_reference_sweep(port, fixture,  # noqa: F811
                                              name):
    _lanes_match_reference(port, fixture, name, WINDOW)
