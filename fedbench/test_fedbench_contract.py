"""``BENCHMARK.json`` keeps to the benchmark's format, and the harness is
driven by data: a cell added as files and entries runs without an edit."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from fedbench.discover import load_cell
from fedbench.testing import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fedbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "fedbench" / "metrics" / f"{m['name']}.py").exists()
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"| {layer} |" in perf for layer in layers)


def test_every_cell_finds_its_files():
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        used.add(w["config"])
        cell = load_cell(ROOT, w["name"])
        assert cell.per_layer and cell.readers
        assert set(cell.limits) >= {"schedule", "update_norm_gap"}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_added_traffic_is_found_without_an_edit(tmp_path):
    """A copy of the benchmark gains a mix, a cell and its limits as new
    files and entries; the harness finds and runs it unchanged."""
    root = tiny_root(tmp_path, policies=("fedasync",))
    base = root / "fedbench"
    mix = json.loads((base / "traffic" / "tiny.fedasync.json").read_text())
    mix["server_kwargs"] = {"alpha": 0.4, "a": 0.5}
    mix["concurrency"] = 0.4
    (base / "traffic" / "tiny.fedasync.busy.json").write_text(json.dumps(mix))
    (base / "limits" / "tiny.busy.json").write_text(
        (base / "limits" / "tiny.fedasync.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.busy", "config": "tiny-cnn",
                               "traffic": "tiny.fedasync.busy", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from fedbench import run
    cell = load_cell(root, "tiny.busy")
    assert cell.mix["concurrency"] == 0.4
    out = run.run(cell, 9, 0.1, False, "cpu", t_start=time.perf_counter())
    assert out["correct"] is True and out["attempted"] > 0


def _command(cwd: Path):
    return subprocess.run(
        [sys.executable, "-m", "fedbench.run", "--workload",
         "cifar10-cnn.fedpsa", "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result (decided here, in the test: on a card this is not the case)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _command(ROOT)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, the command fails and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and '"correct"' not in p.stdout
