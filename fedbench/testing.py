"""A tiny copy of the benchmark for the CPU tests: the same harness, mixes
and readers over a CNN of the paper's structure at toy widths and a small
world, written into a directory of its own beside a ``BENCHMARK.json``
that names it."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_CFG = {
    "name": "tiny-cnn", "model": "tiny-cnn", "source": "test",
    "family": "cnn", "cnn_channels": [2, 3], "cnn_kernel": 5,
    "mlp_hidden": [8, 6], "input_hw": [8, 8, 1], "num_classes": 4,
    "d": 0, "forward_flops_per_sample": 0,
    "world": {"samples": 200, "test_frac": 0.1, "clients": 8,
              "dirichlet_alpha": 0.5, "partition_seed": 3, "local_epochs": 1,
              "batch_size": 16, "lr": 0.05, "lr_decay": 0.999,
              "calib_batch": 16, "eval_batches": 2, "eval_batch_size": 16},
    "assumed": {}, "reduced": []}
TINY_MIX = {"horizon": 2000.0, "warmup_horizon": 300.0}
# a short ring and queue, so that a small world reaches the softmax phase
TINY_PSA = {"buffer_size": 2, "queue_len": 4}
# the updates judged on the small world: the first, and late ones past the
# queue with a client dispatched just after an update
TINY_JUDGE = {"fedpsa": [[1, 1], [6, 6]], "fedasync": [[1, 2], [8, 9]]}
# limits for the tiny world, where the port reads 1e-6 of the reference
# at most and the TF32 control 9e-5 and more
TINY_LIMITS = {"schedule": 0, "update_norm_gap": 1e-4, "update_gap_med": 1e-5,
               "update_gap_mid": 1e-5,
               "late_update_norm_gap": 1e-4, "late_update_gap_med": 1e-5,
               "sketch_gap": 1e-4, "kappa_gap": 1e-4, "late_kappa_gap": 1e-4,
               "temp_gap": 1e-5, "weight_gap": 1e-5, "apply_gap": 1e-5}


def tiny_root(tmp: Path,
              policies=("fedpsa", "fedasync", "fedpsa.sweep3")) -> Path:
    """A checkout-like directory holding the real ``BENCHMARK.json``'s
    metrics and a ``tiny.<mix>`` cell for each mix in ``policies``."""
    from fedbench.arith import forward_flops_per_sample, num_params
    from fedbench.check import numbers
    root = Path(tmp)
    shutil.copytree(HERE, root / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(TINY_CFG, d=num_params(TINY_CFG),
               forward_flops_per_sample=forward_flops_per_sample(TINY_CFG))
    (root / "fedbench" / "configs" / "tiny-cnn.json").write_text(
        json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-cnn", "source": "test",
                         "file": "fedbench/configs/tiny-cnn.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for mix_name in policies:
        mix = json.loads((HERE / "traffic" / f"{mix_name}.json").read_text())
        mix.update(TINY_MIX, judge_versions=TINY_JUDGE[mix["policy"]])
        if mix["psa"]:
            mix["psa"].update(TINY_PSA)
        (root / "fedbench" / "traffic" / f"tiny.{mix_name}.json").write_text(
            json.dumps(mix))
        name = f"tiny.{mix_name}"
        bench["workloads"].append({"name": name, "config": "tiny-cnn",
                                   "traffic": name, "chips": 1, "why": "test"})
        limits = {k: {"limit": TINY_LIMITS[k]} for k in numbers(mix)}
        (root / "fedbench" / "limits" / f"{name}.json").write_text(
            json.dumps(limits))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
