"""``repro_torch.examples.quickstart`` against the reference's
``examples/quickstart.py``, on the CPU.

The reference's script is loaded from ``examples/`` with ``importlib`` and
run unedited through its ``main()`` at a cut horizon (its ``SimConfig`` is
wrapped to set ``horizon=HORIZON`` and ``record_trajectory=True``; its
``run_sweep`` is wrapped to keep each sweep and the world it was given).

* The port's world (every client's arrays, the test set, the calibration
  batch) equals the reference's exactly.
* Each of the reference's sweep lanes (init ``init_params(PRNGKey(seed))``,
  data seed ``seed``) equals the port's standalone run of that lane
  (``quickstart.run_lane``) from that init, converted: digests at the
  golden suite's ``RTOL=1e-4, ATOL=1e-3``, accuracies within ``ATOL``,
  versions, dispatches, dropped and launched exact. The port's lanes draw
  their inits from ``torch.Generator``s, so a port sweep is held to the
  reference through its standalone runs (``tests/test_torch_sweep.py``
  holds the port's lanes to its standalone runs).
* ``quickstart.line`` formats the reference's sweep results into the
  reference's printed lines, character for character, and
  ``main(["--device", "cpu"])`` (its ``HORIZON`` cut to the test's)
  prints one such line per algorithm.
"""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest

from repro.federated import SimConfig as RSim
from repro_torch.convert import params_from_numpy
from repro_torch.examples import quickstart as Q
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HORIZON = 2_000
RTOL, ATOL = 1e-4, 1e-3
COUNTERS = ("versions", "dispatches", "dropped", "launched")
LINE = re.compile(r"^(\w+) +seed\d=\d\.\d{3}(  seed\d=\d\.\d{3})*  ->  "
                  r"\d\.\d{3}±\d\.\d{3}  \(AULC \d\.\d{3}, global updates "
                  r"\d+\)$")


def load_reference(name: str):
    """The reference's ``examples/<name>.py`` as a module, unedited."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """The reference's ``main()`` at ``HORIZON``: its printed lines, its
    sweeps by algorithm and the world it ran on."""
    mod = load_reference("quickstart")
    sweeps, world = {}, {}
    run_sweep = mod.run_sweep

    def recording(alg, cfg, params, clients, test, sim, sweep, **kw):
        world.update(cfg=cfg, clients=clients, test=test,
                     calib=kw["calib_batch"], sim=sim)
        sweeps[alg] = run_sweep(alg, cfg, params, clients, test, sim, sweep,
                                **kw)
        return sweeps[alg]

    mod.SimConfig = lambda **kw: RSim(**{**kw, "horizon": HORIZON,
                                         "record_trajectory": True})
    mod.run_sweep = recording
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return {"mod": mod, "lines": out.getvalue().splitlines(),
            "sweeps": sweeps, **world}


@pytest.fixture(scope="module")
def port_world():
    return Q.build_world()


def test_world_equals_the_reference_world(reference, port_world):
    cfg, clients, test, calib = port_world
    assert cfg.name == reference["cfg"].name
    assert len(clients) == len(reference["clients"]) == 30
    for c, r in zip(clients, reference["clients"]):
        np.testing.assert_array_equal(c.data.x, r.data.x)
        np.testing.assert_array_equal(c.data.y, r.data.y)
    np.testing.assert_array_equal(test.x, reference["test"].x)
    np.testing.assert_array_equal(test.y, reference["test"].y)
    assert set(calib) == set(reference["calib"])
    for k in calib:
        np.testing.assert_array_equal(np.asarray(calib[k]),
                                      np.asarray(reference["calib"][k]))
    sim = reference["sim"]
    want = Q.simulation("cpu")
    for f in ("num_clients", "concurrency", "eval_every", "seed"):
        assert getattr(want, f) == getattr(sim, f), f
    assert want.horizon == 30_000
    assert Q.SEEDS == reference["mod"].SEEDS


@pytest.mark.parametrize("lane", range(3))
@pytest.mark.parametrize("alg", Q.ALGS)
def test_reference_lane_is_the_port_standalone_run(reference, port_world,
                                                   alg, lane):
    import dataclasses
    want = reference["sweeps"][alg]
    ref_init = reference["mod"].M.init_params(
        jax.random.PRNGKey(Q.SEEDS[lane]), reference["cfg"])
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_init))
    sim = dataclasses.replace(Q.simulation("cpu"), horizon=HORIZON,
                              record_trajectory=True)
    res = Q.run_lane(alg, port_world, sim, init, lane)
    for key in COUNTERS:
        assert getattr(res, key) == getattr(want, key), key
    got, exp = np.asarray(res.digests), np.asarray(want.digests[lane])
    assert got.shape == exp.shape and len(got) > 0
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.accuracies, want.lane_accuracies[lane],
                               atol=ATOL)
    assert res.final_accuracy == pytest.approx(want.final_accuracy[lane],
                                               abs=ATOL)


def test_lines_are_the_reference_lines(reference, capsys, monkeypatch):
    """``line`` of the reference's own sweeps is its printed line; the
    port's ``main`` prints one line of that form per algorithm."""
    assert [Q.line(a, reference["sweeps"][a]) for a in Q.ALGS] \
        == reference["lines"]
    monkeypatch.setattr(Q, "HORIZON", HORIZON)
    out = Q.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(Q.ALGS)
    for alg, got, want in zip(Q.ALGS, lines, reference["lines"]):
        assert LINE.match(got) and LINE.match(want), (got, want)
        assert got.split()[0] == want.split()[0] == alg
        # the shared timeline fixes the number of global updates
        assert out[alg].versions == reference["sweeps"][alg].versions
        assert got.endswith(f"global updates {out[alg].versions})")


def test_default_device_is_the_card(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    monkeypatch.setattr(Q, "HORIZON", 10)
    with pytest.raises(Exception, match="(?i)cuda"):
        Q.main([])
