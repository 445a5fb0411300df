"""The federated stack's one-axis device mesh over ``torch.distributed``,
and the production meshes with their per-architecture rules: the port of
the reference's ``repro.launch.mesh``.

``make_production_mesh`` describes the reference's production mesh,
single-pod (data=16, model=16) = 256 cards or multi-pod (pod=2, data=16,
model=16) = 512, by its ``axis_names`` and ``devices.shape``, which are all
that ``rules_for`` reads: no machine has 256 cards, and the dry run
(``launch/dryrun.py``) lays a DTensor ``DeviceMesh`` of that shape over
torch's fake process group itself. ``rules_for(cfg, mesh, global_batch)``
resolves the logical rules against one architecture, line for line the
reference's: a logical axis whose tensor dimension does not divide its
mesh-axis product falls back to replication; recurrent-only archs whose
head counts do not divide the model axis move tensor parallelism to
head_dim; a decode KV cache whose kv heads cannot shard shards over its
sequence (``cache_seq``); and ``cfg.pure_data_parallel`` replicates every
weight when every card gets a sequence.

``make_fed_mesh`` is the one-axis mesh of the federated stack. One
process runs each rank. The caller creates the process group first, with
the backend of its choice: ``nccl`` for one rank per card, ``gloo`` for
CPU tensors and for several ranks on one card (NCCL refuses two ranks on
one GPU). ``make_fed_mesh`` then lays a one-axis ``DeviceMesh`` over that
group; it never creates a group of its own.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.common.sharding import (EXPERT_TP_RULES, PRODUCTION_RULES,
                                         LogicalRules)
from repro_torch.models.config import ModelConfig


def make_fed_mesh(n: int, axis: str = "d", device: str = "cuda"):
    """One-axis ``DeviceMesh`` named ``axis`` over the ``n`` ranks of the
    process group that already exists, for tensors on ``device`` ("cuda",
    the default, or "cpu"). Raises when no group is initialized or its
    world size is not ``n``."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_fed_mesh: no torch.distributed process group; call "
            "dist.init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) first (nccl for one rank per card, gloo for "
            "CPU tensors or several ranks on one card)")
    world = dist.get_world_size()
    if world != int(n):
        raise ValueError(f"make_fed_mesh: asked for {n} ranks, the process "
                         f"group has {world}")
    device_type = torch.device(device).type
    if device_type == "cuda":
        # initialize the caller's current card first, so that the mesh does
        # not pick one by its own rule
        torch.cuda.current_device()
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def make_production_mesh(*, multi_pod: bool = False) -> SimpleNamespace:
    """The production mesh's layout: ``axis_names`` and ``devices.shape``,
    (16, 16) ``data x model`` or (2, 16, 16) ``pod x data x model``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SimpleNamespace(axis_names=axes,
                           devices=SimpleNamespace(shape=shape))


def axis_dims(cfg: ModelConfig,
              global_batch: Optional[int] = None) -> Dict[str, List[int]]:
    """Every concrete tensor dimension each logical axis annotates, per arch.
    Used to verify divisibility before assigning a mesh axis."""
    dims: Dict[str, List[int]] = {
        "embed": [cfg.d_model],
        "heads": [cfg.num_heads],
        "kv_heads": [cfg.num_kv_heads],
        "head_dim": [cfg.head_dim] if cfg.head_dim else [],
        "vocab": [cfg.vocab_padded],
        "mlp": [],
        "expert": [],
        "expert_mlp": [],
        "ssm_inner": [],
    }
    if "dense" in cfg.ffn_pattern or cfg.d_ff:
        dims["mlp"].append(cfg.d_ff)
    if cfg.num_shared_experts:
        dims["mlp"].append(cfg.shared_d_ff
                           or cfg.num_shared_experts * cfg.moe_d_ff)
    if cfg.num_experts:
        dims["expert"].append(cfg.num_experts)
        dims["expert_mlp"].append(cfg.moe_d_ff)
    if "mamba" in cfg.block_pattern:
        dims["ssm_inner"] += [cfg.ssm_inner, 2 * cfg.ssm_inner]
    if "mlstm" in cfg.block_pattern:
        inner = int(cfg.d_model * cfg.mlstm_proj_factor)
        dims["ssm_inner"] += [inner, 2 * inner]
        dims["heads"].append(cfg.num_heads)
        dims["head_dim"].append(inner // cfg.num_heads)
    if "slstm" in cfg.block_pattern:
        dims["mlp"].append(cfg.slstm_ffn_dim)
        dims["head_dim"].append(cfg.d_model // cfg.num_heads)
    if global_batch is not None:
        dims["batch"] = [global_batch]
        dims["tokens"] = [global_batch]  # token arrays lead with batch too
    return {k: [d for d in v if d] for k, v in dims.items()}


def _nshards(mesh, assign) -> int:
    if assign is None:
        return 1
    axes = assign if isinstance(assign, (list, tuple)) else (assign,)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return math.prod(sizes[a] for a in axes)


def rules_for(cfg: ModelConfig, mesh,
              global_batch: Optional[int] = None) -> LogicalRules:
    world = math.prod(mesh.devices.shape)
    if cfg.pure_data_parallel and global_batch and global_batch >= world:
        # pure DP only pays off when every card gets >= 1 sequence; the
        # small-batch inference shapes fall back to the standard rules
        return _pure_dp_rules(mesh, global_batch)
    base = EXPERT_TP_RULES if cfg.expert_tensor_parallel else PRODUCTION_RULES
    rules = dict(base.rules)
    # the pod axis only exists on the multi-pod mesh
    present = set(mesh.axis_names)
    for name, assign in list(rules.items()):
        if assign is None:
            continue
        axes = assign if isinstance(assign, (list, tuple)) else (assign,)
        kept = tuple(a for a in axes if a in present)
        rules[name] = kept if len(kept) > 1 else (kept[0] if kept else None)

    dims = axis_dims(cfg, global_batch)
    dropped = set()
    for name, sizes in dims.items():
        assign = rules.get(name)
        if assign is None or not sizes:
            continue
        ns = _nshards(mesh, assign)
        if any(d % ns for d in sizes):
            rules[name] = None
            dropped.add(name)

    # heads-based TP impossible -> head_dim TP, for recurrent mixers only:
    # softmax attention with a sharded head_dim all-reduces every score
    # block, so those archs run attention replicated over `model`
    if "heads" in dropped and "attn" not in cfg.block_pattern:
        hd_sizes = dims.get("head_dim", [])
        ns = _nshards(mesh, base.rules.get("heads"))
        if hd_sizes and all(d % ns == 0 for d in hd_sizes):
            rules["head_dim"] = base.rules.get("heads")

    # decode KV caches: when kv-head TP is impossible, shard the cache over
    # its sequence dim instead of replicating it
    if rules.get("kv_heads") is None and "attn" in cfg.block_pattern:
        rules["cache_seq"] = "model" if "model" in present else None
    return LogicalRules(rules)


def dims_conflict(cfg: ModelConfig) -> set:
    """Logical axes that must stay replicated for this arch (reserved)."""
    return set()


def _pure_dp_rules(mesh, global_batch: Optional[int]) -> LogicalRules:
    """All weights replicated; batch sharded over the largest axis prefix
    whose product divides it (gradients sync with one all-reduce)."""
    names = list(mesh.axis_names)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    best: list = []
    best_prod = 1
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            trial = names[i:j]
            prod = math.prod(sizes[a] for a in trial)
            if (global_batch is None or global_batch % prod == 0) \
                    and prod > best_prod:
                best, best_prod = trial, prod
    assign = tuple(best) if len(best) > 1 else (best[0] if best else None)
    rules = {k: None for k in PRODUCTION_RULES.rules}
    rules["batch"] = assign
    rules["tokens"] = assign
    return LogicalRules(rules)


def describe_rules(cfg: ModelConfig, mesh, global_batch=None) -> str:
    r = rules_for(cfg, mesh, global_batch)
    return "\n".join(f"  {k:16s} -> {v}" for k, v in sorted(r.rules.items()))
