"""``repro_torch.examples.paper_protocol`` against the reference's
``examples/paper_protocol.py``, on the CPU.

The reference's script is loaded from ``examples/`` with ``importlib`` and
run unedited through its ``main()`` with ``--horizon HORIZON`` (its
``SimConfig`` is wrapped to set ``record_trajectory=True``; its
``run_algorithm`` is wrapped to keep each run, the init and the world it
was given).

* The port's world (every client's arrays, the test set, the calibration
  batch) equals the reference's exactly.
* From the reference's init, converted, the port's ``run_all`` gives each
  of the 8 algorithms' runs: digests at the golden suite's ``RTOL=1e-4,
  ATOL=1e-3``, accuracies within ``ATOL``, versions, dispatches, dropped
  and launched exact, and FedPSA's log (temperatures, kappas and weights)
  within 1e-4.
* The lines that ``run_all`` and ``report`` print are the reference's,
  number for number within ``ATOL`` (each printed to 3 decimals; 2 for the
  temperatures); ``main([... "--device", "cpu"])`` prints lines of the same
  form, one a run, and the ordering, thermometer and kappa lines.
"""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import numpy as np
import pytest

from repro.federated import SimConfig as RSim
from repro_torch.convert import params_from_numpy
from repro_torch.examples import paper_protocol as P
from repro_torch.federated import ALGORITHMS
from test_torch_example_quickstart import load_reference
from torch_threads import one_torch_thread  # noqa: F401

HORIZON = 1_500
CLIENTS = 50
RTOL, ATOL = 1e-4, 1e-3
COUNTERS = ("versions", "dispatches", "dropped", "launched")
NUMBER = re.compile(r"-?\d+\.\d+|\d+")


@pytest.fixture(scope="module")
def reference():
    """The reference's ``main()`` at ``--horizon HORIZON``: its printed
    lines, its runs, the init and the world."""
    mod = load_reference("paper_protocol")
    runs, seen = {}, {}
    run_algorithm = mod.run_algorithm

    def recording(alg, cfg, params, clients, test, sim, **kw):
        seen.update(cfg=cfg, params=params, clients=clients, test=test,
                    calib=kw["calib_batch"], sim=sim)
        runs[alg] = run_algorithm(alg, cfg, params, clients, test, sim, **kw)
        return runs[alg]

    mod.SimConfig = lambda **kw: RSim(**{**kw, "record_trajectory": True})
    mod.run_algorithm = recording
    argv, out = sys.argv, io.StringIO()
    sys.argv = ["paper_protocol.py", "--horizon", str(HORIZON)]
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    return {"lines": out.getvalue().splitlines(), "runs": runs, **seen}


@pytest.fixture(scope="module")
def port(reference):
    """The port's ``run_all`` and ``report`` from the reference's init:
    the results and the printed lines."""
    world = P.build_world(CLIENTS)
    sim = dataclasses.replace(P.simulation(HORIZON, CLIENTS, "cpu"),
                              record_trajectory=True)
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                    reference["params"]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = P.run_all(world, sim, init)
        P.report(results)
    return {"world": world, "results": results,
            "lines": out.getvalue().splitlines()}


def _shape(line: str) -> str:
    return NUMBER.sub("#", line)


def test_world_equals_the_reference_world(reference, port):
    cfg, clients, test, calib = port["world"]
    assert cfg.name == reference["cfg"].name
    assert len(clients) == len(reference["clients"]) == CLIENTS
    for c, r in zip(clients, reference["clients"]):
        np.testing.assert_array_equal(c.data.x, r.data.x)
        np.testing.assert_array_equal(c.data.y, r.data.y)
    np.testing.assert_array_equal(test.x, reference["test"].x)
    np.testing.assert_array_equal(test.y, reference["test"].y)
    for k in calib:
        np.testing.assert_array_equal(np.asarray(calib[k]),
                                      np.asarray(reference["calib"][k]))
    sim = reference["sim"]
    for f in ("num_clients", "concurrency", "horizon", "eval_every", "seed"):
        assert getattr(P.simulation(HORIZON, CLIENTS), f) == getattr(sim, f)


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_run_matches_the_reference_run(reference, port, alg):
    want, res = reference["runs"][alg], port["results"][alg]
    for key in COUNTERS:
        assert getattr(res, key) == getattr(want, key), key
    got, exp = np.asarray(res.digests), np.asarray(want.digests)
    assert got.shape == exp.shape
    assert len(got) > 0 or alg == "fedavg"   # FedAvg records no digests
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.accuracies, want.accuracies, atol=ATOL)
    assert res.aulc == pytest.approx(want.aulc, abs=ATOL)
    if alg == "fedpsa":
        assert len(res.server_log) == len(want.server_log) > 0
        for e_p, e_r in zip(res.server_log, want.server_log):
            assert (e_p["temp"] is None) == (e_r["temp"] is None)
            if e_r["temp"] is not None:
                assert e_p["temp"] == pytest.approx(e_r["temp"], rel=1e-4)
            for key in ("kappas", "weights"):
                np.testing.assert_allclose(e_p[key], e_r[key], atol=1e-4)


def test_printed_lines_are_the_reference_lines(reference, port):
    assert len(port["lines"]) == len(reference["lines"])
    assert any(line.startswith("FedPSA thermometer")
               for line in reference["lines"])
    for got, want in zip(port["lines"], reference["lines"]):
        assert _shape(got) == _shape(want), (got, want)
        np.testing.assert_allclose(
            [float(x) for x in NUMBER.findall(got)],
            [float(x) for x in NUMBER.findall(want)], atol=ATOL + 5e-3
            if got.startswith("FedPSA thermometer") else ATOL,
            err_msg=f"{got!r} vs {want!r}")


def test_main_prints_the_protocol(capsys):
    out = P.main(["--horizon", "600", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(out) == list(ALGORITHMS)
    for alg, line in zip(ALGORITHMS, lines):
        assert re.match(rf"^{alg} +final=\d\.\d{{3}} aulc=\d\.\d{{3}} "
                        rf"updates=\d+$", line), line
    assert lines[len(ALGORITHMS) + 1].startswith("Table-2-style ordering")
    assert sorted(lines[len(ALGORITHMS) + 2].split()[::2]) \
        == sorted(ALGORITHMS)
    assert lines[-1].startswith("kappa over run: mean=")
