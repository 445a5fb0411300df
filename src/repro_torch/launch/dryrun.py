"""Multi-pod dry run of the port: every (arch x shape x mesh) combination's
step traced on meta tensors laid out on the production mesh, with the
per-device cost of the step counted op by op. The port of the reference's
``repro.launch.dryrun``.

Usage (CPU only; needs no card, allocates nothing):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON per combination into ``artifacts/dryrun_torch/``, with the
reference's record keys and ``status`` values. The per-device program is
rank 0's: a DTensor ``DeviceMesh`` of the production mesh's shape
(``launch.mesh.make_production_mesh``) over torch's fake process group of
256 (pod) or 512 (multipod) ranks, which runs no collective. Parameters
come from ``init_params`` on the ``meta`` device; they and the inputs
(``configs.shapes.input_specs``) are distributed with the placements of
``shard_pytree_spec`` under ``rules_for``'s rules, and the step
(``launch.steps.make_step``) runs under ``logical_rules(rules)`` and the op
counter (``launch.op_cost``), which counts the recurrences' time loops
from two steps (there are no values on meta tensors). A
DTensor op's flops are its global flops over the devices that share them,
its bytes its local shards' (see ``op_cost``). Where the rules are pure
data parallel (``launch.mesh._pure_dp_rules``), every weight is replicated
and the per-device program is the global one at batch ``global_batch /
world``.

Against the reference's record: ``memory_analysis`` holds
``argument_size_in_bytes`` and ``output_size_in_bytes`` from the local
shard shapes (the reference's lr or pos scalar counted as its 4 bytes);
there is no ``temp_size_in_bytes``, because no compiler plans eager's
buffers (the peak is measured on the card instead). ``xla_cost_analysis``,
``lower_s``, ``compile_s``, ``analyze_s`` and ``hlo_lines`` have no
counterpart (the count is taken as the step is traced); ``trace_s`` is the
seconds the counted step took to trace. ``kernels`` holds the port
kernels' counts and costs. A failing combination is recorded as ``status:
"error"`` with its traceback, and ``main`` exits 1.

The fake process group is process-global: run each dry run in a process of
its own (this CLI, or a subprocess).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common import sharding
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.shapes import (SHAPES, config_for_shape, input_specs,
                                        shape_supported)
from repro_torch.launch import op_cost
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import model as model_lib

DEFAULT_OUT = "artifacts/dryrun_torch"


def device_mesh(desc):
    """A DTensor ``DeviceMesh`` of the description's shape and axis names
    over torch's fake process group (created, or re-created at another
    world size), this process rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(desc.devices.shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    return init_device_mesh("cpu", tuple(desc.devices.shape),
                            mesh_dim_names=tuple(desc.axis_names))


def _like(tree, ref):
    """Each DTensor of ``tree`` redistributed to its ``ref``'s placements."""
    if isinstance(tree, dict):
        return {k: _like(v, ref[k]) for k, v in tree.items()}
    return tree.redistribute(ref.device_mesh, ref.placements)


def local_bytes(tree) -> int:
    """Bytes of the tree's tensors on this device (a DTensor's shard)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        local = getattr(tree, "_local_tensor", tree)
        return math.prod(local.shape) * local.element_size()
    return 0


def _trace(mode, step, params, inputs, pos: int):
    """Run the step once on the distributed inputs -> its outputs; a train
    step's new parameters laid out as the parameters (a gradient that is a
    ``Partial`` sum is reduced there, the data-parallel sync)."""
    if mode == "train":
        new, loss = step(params, inputs["batch"], 1e-3)
        return _like(new, params), loss
    if mode in ("prefill", "encode"):
        with torch.no_grad():
            return step(params, inputs["batch"])
    with torch.no_grad():
        return step(params, inputs["cache"], inputs["tokens"], pos)


def run_one(arch: str, shape: str, mesh_kind: str, out_dir: str,
            verbose: bool = True, overrides: dict = None,
            tag: str = "") -> dict:
    cfg0 = get_config(arch)
    ok, why = shape_supported(cfg0, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if tag:
        rec["tag"] = tag
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _save(rec, out_dir)
        return rec
    cfg = config_for_shape(cfg0, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    desc = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    world = math.prod(desc.devices.shape)
    gb = SHAPES[shape].global_batch
    rules = rules_for(cfg, desc, gb)
    mode, specs, axes = input_specs(cfg0, shape)
    total, active = model_lib.count_params(cfg)
    rec.update({
        "mode": mode, "world": world,
        "params_total": total, "params_active": active,
        "seq_len": SHAPES[shape].seq_len, "global_batch": gb,
        "rules": {k: (list(v) if isinstance(v, (list, tuple)) else v)
                  for k, v in rules.rules.items()},
    })
    try:
        from torch.distributed.tensor.experimental import implicit_replication
        mesh = device_mesh(desc)
        params = model_lib.init_params(None, cfg, "meta")
        p_spec = sharding.shard_pytree_spec(
            rules, model_lib.param_axes(cfg, params))
        params = sharding.distribute(params, p_spec, mesh, mode == "train")
        inputs = {k: v for k, v in specs.items() if k != "pos"}
        inputs = sharding.distribute(inputs, sharding.shard_pytree_spec(
            rules, {k: axes[k] for k in inputs}), mesh)
        # the reference's lr (train) or pos (decode) scalar argument
        scalar = 4 if mode in ("train", "decode") else 0
        arg_bytes = local_bytes(params) + local_bytes(inputs) + scalar
        step = steps_lib.make_step(mode, cfg)
        t0 = time.time()
        with implicit_replication(), sharding.logical_rules(rules), \
                op_cost.OpCounter(world) as counter:
            out = _trace(mode, step, params, inputs,
                         SHAPES[shape].seq_len - 1)
        t_trace = time.time() - t0
        hc = counter.result()
        rec.update({
            "status": "ok",
            "trace_s": round(t_trace, 2),
            "flops_per_device": hc["flops_per_device"],
            "bytes_per_device": hc["bytes_per_device"],
            "collective_ici_bytes": hc["ici_bytes_per_device"],
            "transcendentals_per_device": hc["transcendentals"],
            "collectives": hc["collectives"],
            "unparsed_loops": hc["unparsed_loops"],
            "kernels": hc["kernels"],
            "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                                "output_size_in_bytes": local_bytes(out)},
            "n_collectives": int(sum(s["count"] for s in
                                     hc["collectives"].values())),
        })
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_kind}: OK "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"ici={rec['collective_ici_bytes']:.3e}B "
                  f"(trace {t_trace:.1f}s)", flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_kind}: FAIL "
                  f"{rec['error']}", flush=True)
    _save(rec, out_dir)
    return rec


def _save(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    # DTensor warns at every two-step reduction over the pod and data dims;
    # the counter counts both steps
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="suffix for artifact filenames")
    ap.add_argument("--scan-groups", type=int, default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--dispatch-groups", type=int, default=None)
    ap.add_argument("--pure-dp", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.scan_groups is not None:
        overrides["scan_groups"] = args.scan_groups
    if args.seq_shard:
        overrides["seq_shard"] = True
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.dispatch_groups is not None:
        overrides["dispatch_groups"] = args.dispatch_groups
    if args.pure_dp:
        overrides["pure_data_parallel"] = True
    if args.grad_accum is not None:
        overrides["grad_accum"] = args.grad_accum

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    results = []
    for m in meshes:
        for a in archs:
            for s in shapes:
                results.append(run_one(a, s, m, args.out,
                                       overrides=overrides or None,
                                       tag=args.tag))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if dist.is_initialized():
        dist.destroy_process_group()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
