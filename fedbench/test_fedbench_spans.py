"""The idle-by-span split (``fedbench.spans``) on synthetic intervals and
on tiny traced runs, and the readers of the program's spans and tallies."""
import json
from types import SimpleNamespace

import pytest
import torch

from fedbench import spans
from fedbench import trace as trace_lib
from fedbench.discover import load_cell
from fedbench.testing import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the per-layer metrics that read the program's spans and tallies
NEW = ("wave_pad_pct", "grouped_matmul_roofline", "loop_idle_pct",
       "train_idle_pct", "policy_idle_pct")


def test_idle_by_span_nests_and_sums():
    """loop [0, 100] holds train [10, 40] and receive [50, 80], which holds
    aggregate [60, 70]; gaps cross their boundaries and the window's end."""
    sp = [(0, 100, "L"), (10, 40, "T"), (50, 80, "R"), (60, 70, "A")]
    gaps = [(5, 15), (35, 65), (68, 90), (95, 120)]
    out = spans.idle_by_span(gaps, sp)
    idle = {n: round(v["idle_s"] * 1e9, 6) for n, v in out.items()}
    assert idle == {"L": 30, "T": 10, "R": 20, "A": 7, spans.OUTSIDE: 20}
    assert sum(idle.values()) == sum(b - a for a, b in gaps)
    assert out["L"]["count"] == 1 and out["T"]["host_s"] == pytest.approx(
        30e-9)


def _event(name, s, t, device=False):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=lambda: name, start_ns=lambda: s,
                           end_ns=lambda: t, device_type=lambda: kind)


def test_window_spans_agrees_with_summarize(monkeypatch):
    """On the same events: the window and busy time ``summarize`` reads,
    the idle split summing to what is not busy, the spans' mirror on the
    device's timeline not counted as work, ``summarize``'s keys as they
    were, and the span readers' shares with the rest summing to
    ``device_idle_pct``."""
    ev = [_event(trace_lib.WINDOW_SPAN, 100, 1100),
          _event("fedbench.sim", 100, 1090),
          _event("repro_torch.loop", 120, 1080),
          _event("repro_torch.train", 200, 500),
          _event("repro_torch.train", 200, 500, device=True),
          _event("repro_torch.receive", 600, 900),
          _event("kernel_a", 250, 450, device=True),
          _event("kernel_b", 400, 700, device=True),
          _event("Memcpy HtoD", 1050, 1200, device=True),
          _event("kernel_c", 0, 110, device=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    summary = trace_lib.summarize(prof)
    assert set(summary) == {"window_s", "busy_s", "kernels",
                            "kernel_launches", "device_ops", "idle_gaps"}
    win = spans.window_spans(prof)
    assert win["window_s"] == pytest.approx(summary["window_s"])
    assert win["busy_s"] == pytest.approx(summary["busy_s"])
    idle = sum(v["idle_s"] for v in win["spans"].values())
    assert idle == pytest.approx(summary["window_s"] - summary["busy_s"])
    got = {n: round(v["idle_s"] * 1e9) for n, v in win["spans"].items()}
    assert got == {spans.OUTSIDE: 10, "repro_torch.loop": 230,
                   "repro_torch.train": 50, "repro_torch.receive": 200}
    pct = spans.idle_pct(win)
    assert sum(pct.values()) == pytest.approx(
        100.0 * (1.0 - summary["busy_s"] / summary["window_s"]))
    # the readers, from the split the profiler hands over as it stops:
    # with the eval, setup and outside shares they sum to device_idle_pct
    monkeypatch.setattr(spans, "_last", None)
    spans._keep(prof)
    readers = load_cell(ROOT, "cifar10-cnn.fedpsa").readers
    rec = {"trace": summary}
    shares = {n: readers[f"{n}_idle_pct"](rec)
              for n in ("loop", "train", "policy")}
    assert shares == pytest.approx({"loop": 23.0, "train": 5.0,
                                    "policy": 20.0})
    rest = pct["eval"] + pct["setup"] + pct[spans.OUTSIDE]
    assert sum(shares.values()) + rest == pytest.approx(
        readers["device_idle_pct"](rec), abs=1e-9)
    assert readers["loop_idle_pct"]({"trace": None}) is None


def test_tiny_traced_run_splits_idle_by_span(tmp_path):
    """A traced CPU run of the tiny FedAsync cell: every span the mix runs
    is there, one ``train`` a wave, the split sums to the idle share, and
    the new readers read a number or nothing (no device work on the CPU).
    FedPSA's spans are held by ``tests/test_torch_trace.py``: its tiny cell
    runs for tens of seconds on the CPU."""
    from fedbench import run
    root = tiny_root(tmp_path, policies=("fedasync",))
    cell = load_cell(root, "tiny.fedasync")
    out = run.run(cell, 9, 0.1, True, "cpu")
    win = spans.last()
    names = {n[len(spans.SPAN_PREFIX):] for n in win["spans"]
             if n != spans.OUTSIDE}
    assert names == {"setup", "loop", "train", "receive", "redispatch",
                     "eval"}
    waves = out["attempted"] / out["metrics"]["members_per_wave"]["value"]
    assert win["spans"]["repro_torch.train"]["count"] == round(waves)
    dev = out["device"]
    assert sum(spans.idle_pct(win).values()) == pytest.approx(
        100.0 * (1.0 - dev["busy_s"] / dev["window_s"]))
    assert 0.0 < out["metrics"]["wave_pad_pct"]["value"] < 100.0
    for name in NEW:
        if name != "wave_pad_pct":
            assert name not in out["metrics"]
        assert cell.readers[name]({"trace": None}) is None


# the CIFAR CNN's grouped_matmul calls at G = 4: the dense layers' forward,
# dx and dW at batch 64, and the convolutions' weight gradients
CIFAR_CALLS = [(4, 64, 4096, 384), (4, 64, 384, 4096), (4, 4096, 64, 384),
               (4, 64, 384, 192), (4, 64, 192, 10),
               (4, 64, 64 * 32 * 32, 75), (4, 64, 64 * 16 * 16, 64 * 25)]


@pytest.mark.parametrize("G,M,K,N", CIFAR_CALLS)
def test_grouped_matmul_cost_is_frozen(G, M, K, N):
    """The program's cost of a call, which the roofline reads from its
    tally, is the frozen copy beside the reader."""
    from repro_torch.kernels import grouped_matmul
    cell = load_cell(ROOT, "cifar10-cnn.fedpsa")
    reader = cell.readers["grouped_matmul_roofline"]
    frozen = reader.__globals__["cost"](G, M, K, N)
    assert grouped_matmul.cost(G, M, K, N) == frozen
    assert frozen == {"flops": 2.0 * G * M * N * K,
                      "nbytes": 4.0 * G * (M * K + K * N + M * N)}


def test_new_metrics_are_declared():
    metrics = {m["name"]: m for m in BENCH["per_layer"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for name in NEW:
        assert metrics[name]["workloads"] == cells
        assert metrics[name]["moves"] == "receives_per_s"
    assert list(metrics)[-len(NEW):] == list(NEW)
