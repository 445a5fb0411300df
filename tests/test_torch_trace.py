"""The port's spans and tallies (``repro_torch.common.trace``) and the
cohort engine's member-step counters: off, a span is one shared no-op and
nothing is tallied; on, under ``torch.profiler``, the spans land in the
trace and change nothing a simulation computes."""
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro_torch.common import trace
from repro_torch.common.tree import FlatSpec
from repro_torch.configs import get_config
from repro_torch.core.psa import PSAConfig
from repro_torch.data import synthetic
from repro_torch.data.loader import ClientDataset, StackedClients
from repro_torch.federated import servers, simulator
from repro_torch.federated.cohort import CohortEngine
from repro_torch.launch import op_cost
from repro_torch.models.model import init_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = get_config("paper-synthetic-mlp")
SPANS = ("setup", "loop", "train", "sketch", "receive", "aggregate",
         "refresh", "redispatch", "eval")


def _world(sizes=(40, 10, 25, 30, 18, 22)):
    data = synthetic.make_classification(sum(sizes) + 40, 10, 32, seed=1)
    train, test = synthetic.train_test_split(data, 40 / len(data))
    bounds = np.cumsum((0,) + tuple(sizes))
    clients = [ClientDataset(train.subset(np.arange(a, b)))
               for a, b in zip(bounds[:-1], bounds[1:])]
    calib = {"x": train.x[:16].copy(), "y": train.y[:16].copy()}
    return clients, test, calib


def test_span_off_is_one_shared_noop(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not trace.recording()
    before = (trace.kernel_tally(), trace.counts())
    a, b = trace.span("train"), trace.span("eval")
    assert a is b is trace.OFF
    with a:
        op_cost.report("grouped_matmul", 1.0, 2.0)
        trace.count("member_steps_run", 3)
    assert (trace.kernel_tally(), trace.counts()) == before


def test_span_on_lands_in_the_trace():
    before = (trace.kernel_tally(), trace.counts())
    with torch.profiler.profile() as prof:
        assert trace.recording()
        with trace.span("train"):
            torch.ones(3).sum()
            op_cost.report("grouped_matmul", 8.0, 16.0)
        trace.count("member_steps_run", 5)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("repro_torch.train") == 1
    key = ("grouped_matmul", 8.0, 16.0, 0.0, 0.0)
    assert trace.kernel_tally()[key] == before[0].get(key, 0) + 1
    assert trace.counts()["member_steps_run"] == \
        before[1].get("member_steps_run", 0) + 5


def test_member_steps_hand_computed():
    """Two epochs at batch 16: clients of 40, 10 and 25 samples take 4, 2
    and 2 steps. The wave of the three pads to 4 members and runs 4 steps
    (16 member-steps, 8 live); client 1 alone pads to 4 and runs 2 (8, 2)."""
    clients, _, _ = _world()
    params = init_params(torch.Generator().manual_seed(0), CFG)
    spec = FlatSpec(params)
    eng = CohortEngine(CFG, StackedClients.from_datasets(clients), spec,
                       local_epochs=2, batch_size=16, device="cpu")
    flat = spec.flatten(params)
    eng.cohort_update(torch.stack([flat] * 3), [0, 1, 2], [0.1] * 3,
                      [1, 2, 3])
    assert (eng.member_steps_run, eng.member_steps_live) == (16, 8)
    eng.cohort_update(flat[None], [1], [0.1], [4])
    assert (eng.member_steps_run, eng.member_steps_live) == (24, 10)
    assert eng.steps_run == 6


def _simulate(engine, profiled):
    clients, test, calib = _world()
    made = []
    make = servers.make_server

    def catch(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    sim = simulator.SimConfig(num_clients=len(clients), concurrency=0.5,
                              local_epochs=1, batch_size=16, horizon=1000.0,
                              eval_every=700.0, seed=3, engine=engine,
                              device="cpu")
    params = init_params(torch.Generator().manual_seed(0), CFG)
    servers.make_server = catch
    try:
        with (torch.profiler.profile() if profiled
              else nullcontext()) as prof:
            res = simulator.run_async(
                "fedpsa", CFG, params, clients, test, sim,
                psa_cfg=PSAConfig(buffer_size=2, queue_len=4),
                calib_batch=calib)
    finally:
        servers.make_server = make
    return res, made[0].flat_params, prof


@pytest.mark.parametrize("engine", ["cohort", "sequential"])
def test_profiler_changes_nothing_and_spans_cover_the_path(engine):
    plain, w_plain, _ = _simulate(engine, False)
    res, w, prof = _simulate(engine, True)
    assert res.receive_log == plain.receive_log
    assert res.versions == plain.versions > 0
    assert res.accuracies == plain.accuracies
    assert len(res.server_log) == len(plain.server_log)
    for a, b in zip(res.server_log, plain.server_log):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert torch.equal(w, w_plain)
    assert (res.member_steps_run, res.member_steps_live) == \
        (plain.member_steps_run, plain.member_steps_live)
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            n = e.name()[len(trace.PREFIX):]
            seen[n] = seen.get(n, 0) + 1
    assert set(seen) == set(SPANS)
    waves = res.cohorts if engine == "cohort" else res.dispatches
    assert seen["train"] == seen["sketch"] == waves
    assert seen["aggregate"] == res.versions
    assert seen["refresh"] == res.versions + 1
    assert seen["loop"] == 1
    if engine == "cohort":
        assert 0 < res.member_steps_live < res.member_steps_run
    else:
        assert res.member_steps_run == res.member_steps_live == 0
