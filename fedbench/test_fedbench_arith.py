"""The yardstick's frozen arithmetic: the published shapes' FLOPs and
parameter counts, the kernels' bounds, and shares that cannot pass 100%
for the work a window did."""
import json

import pytest
import torch

from fedbench import arith
from fedbench.discover import load_cell
from fedbench.testing import ROOT, tiny_root

CONFIGS = {"paper-cifar10-cnn": (65_556_224, 1_756_426),
           "paper-mnist-cnn": (24_546_304, 1_663_370)}


def _cfg(name):
    return json.loads((ROOT / "fedbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_and_params(name):
    cfg = _cfg(name)
    flops, d = CONFIGS[name]
    assert arith.forward_flops_per_sample(cfg) == flops
    assert cfg["forward_flops_per_sample"] == flops
    assert arith.num_params(cfg) == d == cfg["d"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_ports_model(name):
    """The configuration as run is the port's registered model, and the
    layout the benchmark makes its weights in is the port's tree's."""
    from repro_torch.common.tree import FlatSpec
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    from fedbench.world import layout
    cfg, port = _cfg(name), get_config(_cfg(name)["model"])
    assert (port.family, list(port.cnn_channels), port.cnn_kernel,
            list(port.mlp_hidden), list(port.input_hw), port.num_classes) \
        == (cfg["family"], cfg["cnn_channels"], cfg["cnn_kernel"],
            cfg["mlp_hidden"], cfg["input_hw"], cfg["num_classes"])
    spec = FlatSpec(init_params(torch.Generator().manual_seed(0), port))
    assert spec.size == cfg["d"]
    assert spec.shapes == tuple(s for _, s in layout(cfg))


def test_buffer_agg_bound():
    b = arith.bound_s(arith.buffer_agg_cost(5, 1_756_426))
    assert round(b * 1e6, 1) == 14.7


@pytest.mark.parametrize("members,n", [(1, 1_572_864), (1, 1_756_426),
                                       (8, 1_756_426), (256, 4_522),
                                       (1, 946_260_480)])
def test_frozen_costs_are_todays(members, n):
    from repro_torch.kernels import buffer_agg, sens_sketch
    assert arith.sens_sketch_cost(members, n, 16) == \
        sens_sketch.cost(members, n, 16)
    assert arith.buffer_agg_cost(5, n) == buffer_agg.cost(5, n)
    assert arith.SKETCH_INT_OPS_PER_ELEM_ROW == \
        sens_sketch.INT_OPS_PER_ELEM_ROW
    # the CNN's sketch row is bound by the INT32 pipe: 15.1 µs a tree row
    if n == 1_756_426 and members == 1:
        assert round(arith.bound_s(arith.sens_sketch_cost(1, n, 16)) * 1e6,
                     1) == 15.1


def test_shares_count_only_the_work_done(tmp_path):
    """Run the tiny FedPSA cell with the kernels' entries counted; the
    readers' rows and applies equal what was launched and their samples
    what local SGD trained, so a device time that equals the bound of the
    work done reads 100% and never more."""
    from repro_torch.core import aggregation, psa
    from repro_torch.federated import cohort

    from fedbench.program import Program
    from fedbench.world import make_world

    root = tiny_root(tmp_path, policies=("fedpsa",))
    cell = load_cell(root, "tiny.fedpsa")
    world = make_world(cell.cfg, 5, "cpu")
    seen = {"rows": 0, "applies": 0, "samples": 0}
    o_sketch, o_agg, o_sched = (psa.sketch_flat, aggregation.buffer_agg,
                                cohort.CohortEngine._schedules)

    def sketch(spec, w, *a, **kw):
        seen["rows"] += w.shape[0]
        return o_sketch(spec, w, *a, **kw)

    def agg(*a):
        seen["applies"] += 1
        return o_agg(*a)

    def sched(self, cids, seeds):
        out = o_sched(self, cids, seeds)
        seen["samples"] += int(out[1].sum())
        return out

    psa.sketch_flat, aggregation.buffer_agg = sketch, agg
    cohort.CohortEngine._schedules = sched
    prog = Program(cell.cfg, cell.mix, world, "cpu")
    try:
        rec = prog.run(cell.mix["horizon"], [3], 0)
    finally:
        psa.sketch_flat, aggregation.buffer_agg = o_sketch, o_agg
        cohort.CohortEngine._schedules = o_sched
        prog.close()
    assert rec["versions"] > 0
    d, k = cell.cfg["d"], cell.mix["psa"]["sketch_k"]
    L = cell.mix["psa"]["buffer_size"]
    sk_t = seen["rows"] * arith.bound_s(arith.sens_sketch_cost(1, d, k))
    ag_t = seen["applies"] * arith.bound_s(arith.buffer_agg_cost(L, d))
    flops = 3.0 * arith.forward_flops_per_sample(cell.cfg) * seen["samples"]
    summary = {"window_s": flops / arith.F32_FLOPS_PER_S, "busy_s": 1.0,
               "kernel_launches": 1,
               "kernels": {"sens_sketch_tiles<16>": [1, sk_t],
                           "buffer_agg_kernel": [1, ag_t]}}
    full = {"cfg": cell.cfg, "mix": cell.mix, "sizes": world.sizes,
            "sims": [rec], "receives": rec["dispatches"], "trace": summary}
    for name in ("sens_sketch_roofline", "buffer_agg_roofline"):
        assert cell.readers[name](full) == pytest.approx(100.0, rel=1e-12)
    assert 0.0 < cell.readers["train_mfu"](full) <= 100.0 + 1e-9
