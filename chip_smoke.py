#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout (it builds the kernels
from ``src/repro_torch/csrc`` and reads the golden digests under
``tests/``). Phases, each of which raises on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` for every kernel source, with ptxas register/spill lines;
3. kernel parity: each kernel against its plain PyTorch version on the
   card at the main path's shapes and edge shapes, the ``sens_sketch``
   shard composition, and bit-identical repeated ``sens_sketch`` runs;
4. kernel timing: CUDA events around each launch (L2 flushed before each),
   kernel / plain version / one-call library yardstick / computed bound;
5. golden: the sequential FedPSA and FedBuff runs on the golden world
   reproduce ``tests/golden/{fedpsa,fedbuff}.json`` on the card;
6. main path: FedPSA on ``paper-cifar10-cnn`` at full width (d =
   1,756,426), with exact kernel launch counts.

Then it prints one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line. Without a card it exits non-zero
and prints no result. It imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, as the on-chip
# measurement guide tabulates them) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The data sheet gives no INT32 rate. A Hopper SM has 64 INT32 lanes beside
# its 128 FP32 lanes, and the FP32 peak counts an FMA as two operations, so
# the INT32 pipe's peak is a quarter of the FP32 figure: 16.75 TOP/s.
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
# sens_sketch: integer operations per (element, projection row) that the
# function needs on the INT32 pipe. Inner pcg: (state >> 28) + 4 as one
# LEA.HI, the variable shift, the XOR, word >> 22, and one three-input LOP3
# that also folds in the seed (5). Outer pcg: only bit 31 is read, and
# word >> 22 has a zero top bit, so its last shift and XOR are dead: LEA.HI,
# shift, XOR (3). Sign: one LOP3 moves bit 31 of the hash onto s (1). Not
# on this pipe: the three multiplies (IMAD, FMA pipe), the per-row state add
# ((base + r) * A is base * A plus a constant; either pipe takes it) and the
# FADD into the row's sum. phase_build prints what the built kernel issues.
SKETCH_INT_OPS_PER_ELEM_ROW = 9

GOLDEN_WORLD = dict(model="paper-synthetic-mlp", samples=1_500, classes=10,
                    dim=32, clients=8, alpha=0.3, seed=0)
GOLDEN_SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
GOLDEN_PSA = dict(queue_len=10)
RTOL, ATOL = 1e-4, 1e-3
CIFAR_D = 1_756_426


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} x{count} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.splitlines()[0])
    return name, count, smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        log(f"[build] {name}.cu nvcc {rep['seconds']:.2f}s"
            f"{' (cached)' if rep['cached'] else ''}")
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all sources in {wall:.2f}s (parallel)")
    _sass_mix(_build, "sens_sketch", "sens_sketch_partialILi16E", rows=16)


def _sass_mix(_build, lib: str, func: str, rows: int) -> None:
    """Print the instruction mix of the main loop (the longest backward
    branch) of ``func`` in the built library, per (element, row): elements
    per iteration are the loop's global loads over the three input
    streams."""
    import re
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target(lib))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = sass[sass.index(func):]
    nxt = body.find("Function :", 1)
    body = body if nxt < 0 else body[:nxt]
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;",
        body)]
    loops = [(int(t, 16), int(a, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?BRA[^;]*?(0x[0-9a-f]+)", body)
        if int(t, 16) < int(a, 16)]
    lo, hi = max(loops, key=lambda r: r[1] - r[0])
    loop = [op for a, op in ins if lo <= a <= hi]
    elems = max(1, sum(op.startswith("LDG") for op in loop) // 3)
    mix = {}
    for op in loop:
        key = op.split(".")[0]
        mix[key] = mix.get(key, 0) + 1
    per = {k: round(v / (elems * rows), 2) for k, v in sorted(mix.items())}
    log(f"[sass] {func}: main loop {len(loop)} instructions, {elems} "
        f"element(s) x {rows} rows per iteration; per (element, row): {per}")


def _rand(torch, rng, shape, dev, positive=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if positive else x).to(dev)


def phase_parity(torch, dev):
    """Kernel vs plain version on the card. Returns max |err| per kernel."""
    from repro_torch.kernels import buffer_agg as ba, sens_sketch as ss
    rng = np.random.default_rng(0)
    errs = {"buffer_agg": 0.0, "sens_sketch": 0.0}
    # buffer_agg: a different summation order from the plain version
    # (fmaf chain vs addcmul) moves a result by a few ulp of its magnitude.
    for L, d in ((5, CIFAR_D), (1, 64), (8, 8193), (20, 100)):
        w = torch.softmax(_rand(torch, rng, (L,), dev), 0)
        g, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
        got = ba.buffer_agg(w, g, u)
        want = ba.buffer_agg_plain(w, g, u)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-6 * (1.0 + float(want.abs().max())) * L
        log(f"[parity] buffer_agg L={L} d={d} max|err|={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"buffer_agg L={L} d={d}: {err} > {tol}")
        errs["buffer_agg"] = max(errs["buffer_agg"], err)

    # sens_sketch: reduction order only; |err| <= 1e-5 * sum|s| / sqrt(k) + 1e-7
    from repro_torch.configs import get_config
    from repro_torch.common.tree import FlatSpec
    from repro_torch.models.model import init_params
    cifar = FlatSpec(init_params(torch.Generator().manual_seed(0),
                                 get_config("paper-cifar10-cnn")))
    cases = [(n, 16) for n in cifar.sizes] + \
        [(d, k) for d in (1, 7, 4097, 20000) for k in ss.KS]
    for d, k in cases:
        t, g = _rand(torch, rng, (d,), dev), _rand(torch, rng, (d,), dev)
        f = _rand(torch, rng, (d,), dev, positive=True)
        got = ss.sens_sketch(t, g, f, k=k, seed=12345 + d)
        want = ss.sens_sketch_plain(t, g, f, k=k, seed=12345 + d)
        s_sum = float(torch.abs(g * t - 0.5 * f * t * t).sum())
        err = float((got - want).abs().max())
        tol = 1e-5 * s_sum / math.sqrt(k) + 1e-7
        log(f"[parity] sens_sketch d={d} k={k} max|err|={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"sens_sketch d={d} k={k}: {err} > {tol}")
        errs["sens_sketch"] = max(errs["sens_sketch"], err)

    d = 4096 + 640
    t, g = _rand(torch, rng, (d,), dev), _rand(torch, rng, (d,), dev)
    f = _rand(torch, rng, (d,), dev, positive=True)
    full = ss.sens_sketch(t, g, f, k=16, seed=11)
    bounds = np.linspace(0, d, 5).astype(int)
    parts = sum(ss.sens_sketch(t[lo:hi], g[lo:hi], f[lo:hi], k=16, seed=11,
                               index_offset=int(lo))
                for lo, hi in zip(bounds[:-1], bounds[1:]))
    err = float((parts - full).abs().max())
    tol = 1e-5 * float(torch.abs(g * t - 0.5 * f * t * t).sum()) / 4 + 1e-7
    log(f"[parity] sens_sketch 4-shard index_offset composition "
        f"max|err|={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"sens_sketch shard composition: {err} > {tol}")

    n = cifar.sizes[cifar.sizes.index(max(cifar.sizes))]
    t, g = _rand(torch, rng, (n,), dev), _rand(torch, rng, (n,), dev)
    f = _rand(torch, rng, (n,), dev, positive=True)
    a = ss.sens_sketch(t, g, f, k=16, seed=7)
    b = ss.sens_sketch(t, g, f, k=16, seed=7)
    if not torch.equal(a, b):
        raise AssertionError("sens_sketch is not bit-identical across runs")
    log(f"[parity] sens_sketch d={n} repeated runs bit-identical")
    return errs


def _time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    its own CUDA events after an L2 flush (flush time excluded)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def phase_timing(torch, dev):
    from repro_torch.kernels import buffer_agg as ba, sens_sketch as ss
    rng = np.random.default_rng(1)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    out = {}

    L, d = 5, CIFAR_D
    w = torch.softmax(_rand(torch, rng, (L,), dev), 0)
    g, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
    bytes_ = (L + 2) * d * 4
    b_ms, f_ms = bytes_ / HBM_BYTES_PER_S * 1e3, 2 * L * d / FP32_FLOPS_PER_S * 1e3
    out["buffer_agg"] = dict(
        shape=f"L={L} d={d}",
        ms=_time_ms(torch, lambda: ba.buffer_agg(w, g, u), 200, flush),
        plain_ms=_time_ms(torch, lambda: ba.buffer_agg_plain(w, g, u), 200, flush),
        library_ms=_time_ms(torch, lambda: torch.addmv(g, u.t(), w), 200, flush),
        bound_ms=max(b_ms, f_ms), bound_by="bytes" if b_ms >= f_ms else "operations")

    k, n = 16, 1_572_864          # the main path's largest leaf, fc0.w
    t, gg = _rand(torch, rng, (n,), dev), _rand(torch, rng, (n,), dev)
    f = _rand(torch, rng, (n,), dev, positive=True)
    b_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    o_ms = SKETCH_INT_OPS_PER_ELEM_ROW * k * n / INT32_OPS_PER_S * 1e3
    out["sens_sketch"] = dict(
        shape=f"d={n} k={k}",
        ms=_time_ms(torch, lambda: ss.sens_sketch(t, gg, f, k=k, seed=3), 200, flush),
        plain_ms=_time_ms(torch, lambda: ss.sens_sketch_plain(t, gg, f, k=k, seed=3),
                          20, flush),
        library_ms=None,
        bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")
    for name, r in out.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f}us"
        log(f"[timing] {name} {r['shape']}: kernel {r['ms'] * 1e3:.1f}us "
            f"plain {r['plain_ms'] * 1e3:.1f}us library {lib} "
            f"bound {r['bound_ms'] * 1e3:.1f}us ({r['bound_by']})")
    return out


def _golden_world():
    from repro_torch.configs import get_config
    from repro_torch.convert import load_npz_params
    from repro_torch.data import (ClientDataset, dirichlet_partition,
                                  make_calibration_batch, make_classification,
                                  train_test_split)
    W = GOLDEN_WORLD
    cfg = get_config(W["model"])
    full = make_classification(W["samples"], W["classes"], W["dim"],
                               seed=W["seed"], class_sep=0.7)
    train, test = train_test_split(full, 0.1)
    parts = dirichlet_partition(train, W["clients"], alpha=W["alpha"],
                                seed=W["seed"])
    clients = [ClientDataset(train.subset(ix)) for ix in parts]
    calib = make_calibration_batch(train, 64, "gaussian")
    params = load_npz_params(os.path.join(
        ROOT, "tests", "torch_fixtures", "paper_synthetic_mlp_init_seed0.npz"))
    return cfg, clients, test, calib, params


def phase_golden(torch):
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _golden_world()
    for name in ("fedpsa", "fedbuff"):
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        sim = SimConfig(engine="sequential", device="cuda",
                        record_trajectory=True, **GOLDEN_SIM)
        ops.reset_launch_counts()
        res = run_algorithm(name, cfg, params, clients, test, sim, **kw)
        counts = ops.launch_counts()
        with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as fh:
            golden = json.load(fh)
        got, want = np.asarray(res.digests), np.asarray(golden["digests"])
        if got.shape != want.shape:
            raise AssertionError(f"golden {name}: {got.shape} != {want.shape}")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for key in ("versions", "dispatches", "dropped", "launched"):
            if getattr(res, key) != golden["final"][key]:
                raise AssertionError(f"golden {name}: {key} "
                                     f"{getattr(res, key)} != {golden['final'][key]}")
        np.testing.assert_allclose(res.final_accuracy,
                                   golden["final"]["final_accuracy"], atol=2e-3)
        np.testing.assert_allclose(res.aulc, golden["final"]["aulc"], atol=2e-3)
        need = ("buffer_agg", "sens_sketch") if name == "fedpsa" else ("buffer_agg",)
        for k in need:
            if counts[k] == 0:
                raise AssertionError(f"golden {name}: {k} never launched")
        rel = float(np.max(np.abs(got - want) / (np.abs(want) + ATOL / RTOL)))
        log(f"[golden] {name}: {len(got)} digests match (max rel {rel:.2e}), "
            f"versions={res.versions} dispatches={res.dispatches} "
            f"final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
            f"launches={counts}")


def phase_main(torch):
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_task
    from repro_torch.models.model import init_params
    cfg, clients, test, calib = build_task("paper-cifar10-cnn", 10_000,
                                           alpha=0.1, num_clients=50, seed=0)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    sim = SimConfig(engine="sequential", num_clients=50, concurrency=0.2,
                    horizon=6_000, eval_every=2_000, seed=0, device="cuda")
    psa = PSAConfig()
    captured = {}

    def hook(server, w_client, delta, meta, t):
        captured["server"] = server

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_algorithm("fedpsa", cfg, params, clients, test, sim,
                        psa_cfg=psa, calib_batch=calib, receive_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_leaves = 10
    want_sk = n_leaves * (res.dispatches + res.versions + 1)
    if counts["sens_sketch"] != want_sk or counts["buffer_agg"] != res.versions:
        raise AssertionError(f"main path launches {counts}: want sens_sketch="
                             f"{want_sk} buffer_agg={res.versions}")
    if res.versions < 1:
        raise AssertionError("main path never aggregated")
    flat = captured["server"].flat_params
    if flat.shape != (CIFAR_D,) or not bool(torch.isfinite(flat).all()):
        raise AssertionError("main path global model is not finite (d,)")
    if not (0.0 <= res.final_accuracy <= 1.0 and math.isfinite(res.aulc)):
        raise AssertionError(f"bad accuracy {res.final_accuracy} / {res.aulc}")
    log(f"[main] paper-cifar10-cnn fedpsa d={flat.shape[0]} receives="
        f"{res.dispatches} versions={res.versions} final={res.final_accuracy:.4f} "
        f"aulc={res.aulc:.4f} wall={wall:.2f}s "
        f"s/receive={wall / max(res.dispatches, 1):.4f} "
        f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB "
        f"launches={counts}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.federated.simulator  # noqa: F401  (fail before any output)
    name, count, smi = phase_device(torch)
    dev = torch.device("cuda")
    # full float32 throughout (cuDNN's TF32 default would move the convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    errs = phase_parity(torch, dev)
    timing = phase_timing(torch, dev)
    phase_golden(torch)
    launches = phase_main(torch)
    sources = {"buffer_agg": ("src/repro_torch/csrc/buffer_agg.cu",
                              "src/repro/kernels/buffer_agg.py:38",
                              "1e-6 * (1 + max|plain|) * L"),
               "sens_sketch": ("src/repro_torch/csrc/sens_sketch.cu",
                               "src/repro/kernels/sens_sketch.py:69",
                               "1e-5 * sum|s| / sqrt(k) + 1e-7")}
    kernels = []
    for k, (src, rep, tol) in sources.items():
        r = timing[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[k],
                        "max_abs_err": errs[k], "tolerance": tol, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"]})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
