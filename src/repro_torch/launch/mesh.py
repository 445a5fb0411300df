"""The federated stack's one-axis device mesh over ``torch.distributed``.

The port of the reference's ``repro.launch.mesh.make_fed_mesh``. One
process runs each rank. The caller creates the process group first, with
the backend of its choice: ``nccl`` for one rank per card, ``gloo`` for
CPU tensors and for several ranks on one card (NCCL refuses two ranks on
one GPU). ``make_fed_mesh`` then lays a one-axis ``DeviceMesh`` over that
group; it never creates a group of its own.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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
