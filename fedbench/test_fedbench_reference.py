"""The port and the plain reference agree on a tiny world on the CPU, and
the control (the reference in TF32) fails the same comparison."""
import math
import time

import torch

import pytest

from fedbench import check, control, run
from fedbench.discover import load_cell
from fedbench.testing import tiny_root
from fedbench.world import layout, make_world, sub_seed

MIXES = ("fedpsa", "fedasync", "fedpsa.sweep3")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("mix", MIXES)
def test_port_matches_reference(root, mix):
    cell = load_cell(root, f"tiny.{mix}")
    out = run.run(cell, 2 ** 31 + 11, 0.2, False, "cpu",
                  t_start=time.perf_counter())
    assert out["correct"] is True
    assert out["attempted"] > 10
    checks = out["checks"]
    assert checks["schedule"]["value"] == 0
    assert all(v["value"] < 1e-5 for v in checks.values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("mix", ("fedpsa", "fedasync"))
def test_control_fails(root, mix):
    cell = load_cell(root, f"tiny.{mix}")
    (case, numbers, _), = control.cases(cell, 7, "cpu")
    assert case == "control_tf32"
    assert numbers["schedule"] == 0
    assert not check.judge(numbers, cell.limits)


@pytest.mark.parametrize("mix", ("fedpsa", "fedasync"))
def test_whole_horizon_matches(root, mix):
    """On a world this small nothing drifts, so the reference follows the
    port over the whole horizon: the thermometer's softmax phase, every
    aggregation's kappas and weights, and the final model."""
    import numpy as np
    from fedbench.program import Program
    from fedbench.reference.sim import simulate
    cell = load_cell(root, f"tiny.{mix}")
    world = make_world(cell.cfg, 17, "cpu")
    prog = Program(cell.cfg, cell.mix, world, "cpu")
    try:
        rec = prog.run(cell.mix["horizon"], [5], 0, keep=10 ** 6)
    finally:
        prog.close()
    ref = simulate(cell.cfg, cell.mix, world, seed=5, timeline_seed=0,
                   device="cpu")
    sizes = [math.prod(s) for _, s in layout(cell.cfg)]
    assert check.schedule_mismatch(rec["receive_log"],
                                   ref["receive_log"]) == 0
    assert len(rec["rows"][0]) == len(ref["rows"]) == len(rec["receive_log"])
    w0 = world.init_flat.double()
    gaps = check.norm_gaps(rec["rows"][0][-1][2].double() - w0,
                           ref["final"] - w0, sizes)
    assert gaps.max() < 1e-4
    assert len(rec["logs"][0]) == len(ref["log"]) > 3
    for p, r in zip(rec["logs"][0], ref["log"]):
        for key in ("kappas", "weights") if mix == "fedpsa" else ("weight",):
            np.testing.assert_allclose(np.asarray(p[key], np.float64),
                                       np.asarray(r[key], np.float64),
                                       atol=1e-5)
    if mix == "fedpsa":
        assert any(e["temp"] is not None for e in rec["logs"][0])


def test_reference_follows_its_timeline(root):
    """The reference's receives come in time order, each within the
    horizon, and a run repeats exactly."""
    from fedbench.reference.sim import schedule, simulate
    cell = load_cell(root, "tiny.fedasync")
    world = make_world(cell.cfg, 3, "cpu")
    a = simulate(cell.cfg, cell.mix, world, seed=sub_seed(3, "x"),
                 timeline_seed=0, device="cpu", versions=2)
    b = simulate(cell.cfg, cell.mix, world, seed=sub_seed(3, "x"),
                 timeline_seed=0, device="cpu")
    ts = [t for t, _, _ in a["receive_log"]]
    assert ts == sorted(ts) and ts[-1] <= cell.mix["horizon"]
    # the schedule does not depend on how far the reference trains
    assert a["receive_log"] == b["receive_log"]
    assert len(a["rows"]) == 2 < len(b["rows"])
    assert torch.equal(a["rows"][1][2], b["rows"][1][2])
    # each receive starts from the global model after the receive whose
    # completion dispatched it
    sched = schedule(cell.cfg, cell.mix, 0)
    assert [(r.t, r.tau, r.client) for r in sched] == b["receive_log"]
    assert all(-1 <= r.trigger < i for i, r in enumerate(sched))
