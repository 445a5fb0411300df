"""Logical-axis rules, the model's sharding constraints and the
flat-parameter collectives of the federated stack, over
``torch.distributed``: the port of the reference's
``repro.common.sharding``.

A ``LogicalRules`` table maps logical axis names to mesh axes (``None``:
replicated); a spec is the tuple ``mesh_axes`` returns, one entry per
tensor axis. ``PRODUCTION_RULES`` and ``EXPERT_TP_RULES`` are the
reference's tables for the production mesh (``launch/mesh.rules_for``
resolves them per architecture); ``shard_pytree_spec`` maps a tree of
logical-axis tuples to specs and ``placements`` a spec to DTensor
placements.

The model code has no ``rules`` argument. It reads them from a context,
``logical_rules(rules)``, at the reference's ``with_logical_constraint``
sites (``constrain``): empty rules, every run on one card, cost one
context read a site and return the tensor unchanged; under non-empty
rules (the dry run, ``launch/dryrun.py``) the site's DTensor is
redistributed to the placements of its resolved spec, and a plain tensor
raises.

The federated stack shards two
axes over its one-axis mesh (``launch.mesh.make_fed_mesh``):
``param_shard``, the flat ``(d,)`` parameter axis of the policy server's
state, and ``cohort``, the client axis of a completion wave trained
data-parallel.

One process runs each rank. The policy steps are the single-device code:
the server runs them on its local shard inside ``param_axis(axis, d)``,
and the few places that contract over d go through the helpers below,
which complete a shard's partial result across the axis and are plain
reductions outside the context. What crosses shards: a scalar sum's
chunk partials in one ``dist.all_reduce`` (``param_axis_sums``: one
fixed summation order on any rank count, so the same bits as on one
device), a sketch's (k,) partials in one ``all_reduce``, and whole
vectors through ``dist.all_gather`` (FedPSA's global-sketch refresh and
the gathered global model a dispatch snapshots).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

MeshAxis = Union[str, Sequence[str], None]


class LogicalRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes)."""

    def __init__(self, rules: Mapping[str, MeshAxis]):
        self.rules = dict(rules)

    def mesh_axes(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """Resolve logical names to a partition spec, one entry per name (a
        mesh axis, a tuple of them, or None). A mesh axis appears at most
        once per spec: when two names resolve to the same axis the first
        keeps it and later ones are replicated, as in the reference."""
        out = []
        used: set = set()
        for name in logical_axes:
            if name is None:
                out.append(None)
                continue
            ax = self.rules.get(name)
            axes = (tuple(ax) if isinstance(ax, (list, tuple))
                    else ((ax,) if ax else ()))
            kept = tuple(a for a in axes if a not in used)
            if len(kept) != len(axes):
                kept = ()  # partial overlap: replicate rather than half-shard
            used.update(kept)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        return tuple(out)

    def __repr__(self):
        return f"LogicalRules({self.rules})"


# The reference's production rules. ``batch`` spans pod+data so that one
# client step is synchronous data-parallel across the slice it owns.
PRODUCTION_RULES = LogicalRules(
    {
        "batch": ("pod", "data"),
        "tokens": ("pod", "data"),
        "seq": None,
        "embed": "data",          # FSDP: contraction/embed dim of weights
        "embed_act": None,        # activations keep embed replicated
        "seq_act": "model",       # residual-stream sequence sharding
                                  # (only constrained when cfg.seq_shard)
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "vocab_lookup": None,     # the lookup table keeps vocab replicated
        "expert": "model",
        "expert_mlp": None,
        "expert_capacity": None,
        "qkv_inner": "model",
        "conv_kernel": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "layers": None,
        "sketch": None,
        "buffer": None,
        "cache_seq": None,        # decode KV cache seq dim (rules_for upgrades)
    }
)

# Architectures whose expert count does not divide the model axis
# (qwen2-moe: 60 experts): experts replicated, each expert's d_ff sharded.
EXPERT_TP_RULES = LogicalRules({**PRODUCTION_RULES.rules, "expert": None,
                                "expert_mlp": "model"})

FEDERATED_RULES = LogicalRules({"param_shard": "d", "cohort": "d"})
SINGLE_DEVICE_RULES = LogicalRules({})


def logical_to_pspec(rules: LogicalRules, logical_axes) -> tuple:
    return rules.mesh_axes(logical_axes)


def _is_axes(x) -> bool:
    """Whether ``x`` is one tensor's logical-axis tuple (a leaf of an axes
    tree)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, tree):
    """``fn`` over the logical-axis tuples of a tree of dicts and lists."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_axes(fn, v) for v in tree)
    raise TypeError(f"map_axes: not an axes tree node: {tree!r}")


def shard_pytree_spec(rules: LogicalRules, logical_tree):
    """Map a tree of logical-axis tuples to the tree of their specs."""
    return map_axes(rules.mesh_axes, logical_tree)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh axis that spec entry ``i`` names (a tuple entry shards its tensor
    axis over several mesh axes, the first outermost, in mesh order, as
    JAX orders them), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            owner[ax] = i
    return [Shard(owner[name]) if name in owner else Replicate()
            for name in mesh.mesh_dim_names]


def distribute(tree, specs, mesh, requires_grad: bool = False):
    """A tree of dicts of tensors as DTensors on ``mesh`` with the
    placements of ``specs``, its matching tree of specs."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh, requires_grad)
                for k, v in tree.items()}
    t = distribute_tensor(tree, mesh, placements(specs, mesh))
    return t.requires_grad_(True) if requires_grad else t


def with_logical_constraint(x, rules: LogicalRules, logical_axes):
    """``x`` laid out by logical names: unchanged when the rules are empty;
    else ``x``, a DTensor, redistributed to the placements of its resolved
    spec (a ``Partial`` sum is reduced on the way). A plain tensor under
    non-empty rules raises: there is no silent no-op."""
    if not rules.rules:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"with_logical_constraint: rules are set but x is a "
                        f"plain {type(x).__name__}; lay the inputs out as "
                        f"DTensors (launch/dryrun.py)")
    want = placements(rules.mesh_axes(logical_axes), x.device_mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# The rules the model's constraint sites read: None for empty rules, so an
# unsharded run pays one context read a site.
_RULES: contextvars.ContextVar = contextvars.ContextVar("logical_rules",
                                                        default=None)


@contextlib.contextmanager
def logical_rules(rules: Optional[LogicalRules]):
    """Run the code inside under ``rules`` (None or empty: none)."""
    token = _RULES.set(rules if rules is not None and rules.rules else None)
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[LogicalRules]:
    """The rules of the innermost ``logical_rules`` context, None when
    there are none."""
    return _RULES.get()


def constrain(x, logical_axes):
    """A model site's ``with_logical_constraint`` under the context's
    rules: ``x`` itself when there are none."""
    rules = _RULES.get()
    if rules is None:
        return x
    return with_logical_constraint(x, rules, logical_axes)


class AxisGroup:
    """One mesh axis as this process sees it: its name, its process group,
    its size and this process's index on it. ``gather`` keeps the last
    vector it gathered, for the global vector alone (the policies never
    write it in place, so the source tensor's identity names its values)."""

    def __init__(self, name: str, group):
        self.name = name
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._last: Optional[tuple] = None

    def gather(self, vec: torch.Tensor, d: int) -> torch.Tensor:
        """The (..., d) whole of a (..., d_local) shard: every rank's shard
        in rank order along the last axis, the padding past d stripped."""
        last = self._last
        if last is not None and last[0] is vec and last[1] == d:
            return last[2]
        full = all_gather_cat(vec, self, dim=-1)[..., :d]
        self._last = (vec, d, full)
        return full


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a torch ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(launch.mesh.make_fed_mesh), got "
                        f"{type(mesh).__name__}")


def mesh_axis(mesh, rules: Optional[LogicalRules],
              logical: str) -> Optional[AxisGroup]:
    """The mesh axis that ``rules`` (default ``FEDERATED_RULES``) map the
    logical axis ``logical`` onto, or None when they map it onto no axis
    of ``mesh``. ``mesh`` is a one-axis ``DeviceMesh``
    (``launch.mesh.make_fed_mesh``); anything else raises."""
    check_mesh(mesh)
    axis = (rules or FEDERATED_RULES).mesh_axes((logical,))[0]
    if axis is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return AxisGroup(axis, mesh.get_group(axis))


def writes(mesh) -> bool:
    """Whether this process writes a run's files: always without a mesh,
    rank 0 alone with one."""
    return mesh is None or dist.get_rank() == 0


def all_gather_cat(t: torch.Tensor, axis: AxisGroup,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated in rank
    order along ``dim`` (list-form ``all_gather``, which gloo takes for
    CPU and CUDA tensors)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


def host_barrier(axis: AxisGroup, device) -> None:
    """Return only when every rank of ``axis`` has reached this call: an
    all-reduce of one element, read on the host."""
    t = torch.zeros((1,), dtype=torch.float32, device=device)
    dist.all_reduce(t, group=axis.group)
    float(t)


# ---------------------------------------------------------------------------
# The flat parameter axis: helpers the policy code calls
# ---------------------------------------------------------------------------

_PARAM_AXIS: contextvars.ContextVar = contextvars.ContextVar(
    "param_axis", default=(None, 0))


@contextlib.contextmanager
def param_axis(axis: Optional[AxisGroup], d: int = 0):
    """Mark that the code inside runs on one shard of the flat parameter
    axis ``axis`` of a d-element vector zero-padded to a multiple of the
    rank count (None: on the whole vector)."""
    token = _PARAM_AXIS.set((axis, d))
    try:
        yield
    finally:
        _PARAM_AXIS.reset(token)


def current_param_axis() -> Optional[AxisGroup]:
    return _PARAM_AXIS.get()[0]


# A sum over d runs in one order on any rank count: the flat axis is cut
# into SUM_CHUNK-element chunks from index 0, each chunk is summed by a
# pairwise tree, and the chunk sums by another. A chunk that lies in one
# shard is summed by its rank; a chunk that a shard boundary cuts is
# summed, on every rank, from its elements after the all_reduce.
SUM_CHUNK = 1024


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) by adjacent pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _chunk_sums(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """(k, m) -> (k, chunks): the pairwise sum of each SUM_CHUNK-element
    chunk of the rows, zero-padded to chunks * SUM_CHUNK."""
    x = F.pad(x, (0, chunks * SUM_CHUNK - x.shape[-1]))
    return _pairwise(x.view(x.shape[0], chunks, SUM_CHUNK))


def _total(partials: torch.Tensor) -> torch.Tensor:
    """(k, N) chunk sums -> (k,): pairwise, zero-padded to a power of two."""
    n = partials.shape[-1]
    return _pairwise(F.pad(partials, (0, (1 << (n - 1).bit_length()) - n)))


@functools.lru_cache(maxsize=64)
def _sum_plan(d: int, d_local: int, rank: int) -> tuple:
    """Where rank ``rank``'s shard ``[rank * d_local, (rank + 1) *
    d_local)`` of a d-element axis goes in a sum: (its valid element
    count, the chunks [a, b) that lie whole in it, the cut chunks (those a
    shard boundary crosses, on every rank alike), and its pieces of them
    as (row in the cut block, first column, first local element, count))."""
    C = SUM_CHUNK
    chunks = -(-d // C)
    lo = rank * d_local
    hi = max(lo, min(lo + d_local, d))
    a = -(-lo // C)
    b = chunks if hi == d else hi // C
    cut = sorted({lo_r // C for lo_r in range(d_local, d, d_local)
                  if lo_r % C})
    pieces = []
    for row, j in enumerate(cut):
        s, e = max(j * C, lo), min(j * C + C, hi)
        if s < e:
            pieces.append((row, s - j * C, s - lo, e - s))
    return hi - lo, (a, max(a, b)), tuple(cut), tuple(pieces)


def param_axis_sums(*xs: torch.Tensor) -> list:
    """The sum of each of ``xs`` (elementwise functions of the flat
    parameter axis) in one fixed order (``SUM_CHUNK`` chunks, pairwise):
    the same bits on one device and inside ``param_axis`` on any rank
    count, where a sum added up differently a rounding off grows to some
    200x the lane tolerance at full width within 93 receives (PERF.md).
    Inside ``param_axis`` each rank sums the chunks that lie in its shard
    and places them, and its elements of the chunks a shard boundary cuts,
    in a zero buffer of ceil(d / SUM_CHUNK) + SUM_CHUNK x (cut chunks)
    floats a sum; one ``all_reduce`` adds the buffers exactly (each slot is
    nonzero on one rank at most) and every rank finishes the sums."""
    axis, d = _PARAM_AXIS.get()
    x = torch.stack(xs)
    if axis is None:
        return list(_total(_chunk_sums(x, -(-x.shape[-1] // SUM_CHUNK)))
                    .unbind())
    chunks = -(-d // SUM_CHUNK)
    valid, (a, b), cut, pieces = _sum_plan(d, x.shape[-1], axis.rank)
    buf = x.new_zeros((len(xs), chunks + len(cut) * SUM_CHUNK))
    if b > a:
        first = axis.rank * x.shape[-1]
        buf[:, a:b] = _chunk_sums(
            x[:, a * SUM_CHUNK - first:min(b * SUM_CHUNK - first, valid)],
            b - a)
    for row, col, start, count in pieces:
        at = chunks + row * SUM_CHUNK + col
        buf[:, at:at + count] = x[:, start:start + count]
    dist.all_reduce(buf, group=axis.group)
    partials = buf[:, :chunks]
    if cut:
        partials[:, list(cut)] = _pairwise(
            buf[:, chunks:].reshape(len(xs), len(cut), SUM_CHUNK))
    return list(_total(partials).unbind())


def param_axis_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the flat parameter axis, the single-device
    bits inside ``param_axis`` too (``param_axis_sums``)."""
    return param_axis_sums(x)[0]


def param_axis_reduce(partial: torch.Tensor) -> torch.Tensor:
    """A shard's partial sums over the flat parameter axis (a (k,) or
    (2, k) sketch), summed across the shards inside ``param_axis`` (one
    ``all_reduce``, in place); unchanged outside it."""
    axis = current_param_axis()
    if axis is not None:
        dist.all_reduce(partial, group=axis.group)
    return partial


def param_axis_offset(d_local: int) -> int:
    """Global index of this shard's first element: ``rank * d_local``
    inside ``param_axis``, 0 outside it."""
    axis = current_param_axis()
    return 0 if axis is None else axis.rank * d_local


def gather_param_axis(vec: torch.Tensor, d: int) -> torch.Tensor:
    """The whole (d,) flat vector of a shard inside ``param_axis``
    (all_gather, then the padding stripped); ``vec`` itself outside it."""
    axis = current_param_axis()
    return vec if axis is None else axis.gather(vec, d)
