"""Server-side aggregation strategies: a host adapter over the policy core.

``PolicyServer`` speaks the object interface the simulator uses, as the
reference's ``repro.federated.servers.PolicyServer`` does:

    receive(delta, client_params, meta) -> bool   # True if global updated
    receive_many(deltas, client_params, ...)      # B in-order receives
    params                                        # current global tree
    flat_params                                   # current global (d,) vector
    version                                       # number of global updates
    psa                                           # FedPSA sub-state
    host_log()                                    # the log, on the host

``meta`` carries tau (version gap), client_id, data_size and, for FedPSA,
the uploaded sensitivity sketch. Every version of the global model is its
own tensor (policies never write it in place), so ``flat_params`` and
``params`` can hand it out without a copy: a dispatch snapshot taken now
is still the same values after later receives.

``ShardedPolicyServer`` is the mesh-sharded drop-in, one process a rank:
every ``(..., d)`` tensor of ``ServerState`` holds this rank's slice of
the zero-padded flat parameter axis (``server_state_specs`` is the layout
contract), and the policy's own step runs on the slices inside
``common.sharding.param_axis``, where its contractions over d complete
across the ranks.

``LanePolicyServer`` holds S sweep lanes of one policy, each a
``PolicyServer`` with its own hyperparameters, over one shared timeline.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.tree import FlatSpec
from repro_torch.core import psa as psa_lib
from repro_torch.federated import policies as pol


class PolicyServer:
    """Owns the ``ServerState`` of one ``Policy``, turns metas into
    ``Arrival``s and keeps the per-update log the benchmarks read."""

    axis: Optional[sharding.AxisGroup] = None   # the sharded server's

    def __init__(self, policy: pol.Policy, params,
                 hyper: Optional[pol.PolicyParams] = None):
        self.policy = policy
        self.name = policy.name
        self.needs_sketch = policy.needs_sketch
        self.client_align = policy.client_align
        self.state = policy.init(params,
                                 policy.hyper if hyper is None else hyper)
        self.log: List[dict] = []
        self._tree_cache = None
        self._tree_cache_version = -1

    @property
    def params(self):
        """Current global model as a tree of views into ``flat_params``."""
        if self._tree_cache_version != self.version:
            self._tree_cache = self.policy.spec.unflatten(self.flat_params)
            self._tree_cache_version = self.version
        return self._tree_cache

    @property
    def flat_params(self):
        return self.state.params

    @property
    def version(self) -> int:
        return self.state.version

    @property
    def psa(self) -> Optional[psa_lib.PSAState]:
        return self.state.psa

    def state_arrays(self) -> dict:
        """The server state as named host arrays (``policies.state_arrays``),
        what a checkpoint saves."""
        return pol.state_arrays(self.state)

    def load_state_arrays(self, arrays: dict) -> None:
        """Restore ``state_arrays`` output (a checkpoint) into this
        server."""
        pol.load_state_arrays(self.state, arrays)
        self._tree_cache_version = -1

    def receive(self, delta, client_params, meta) -> bool:
        """Ingest one completion; returns whether the global model moved."""
        if self.needs_sketch and "sketch" not in meta:
            raise KeyError(
                f"{self.name} requires meta['sketch'] (behavioral sketch)")
        if self.state.cache is not None:
            cid = int(meta["client_id"])  # cache policies require a real id
            n = self.state.cache.data.shape[0]
            if not 0 <= cid < n:
                raise ValueError(f"client_id {cid} outside the server's "
                                 f"num_clients={n} cache")
        else:
            cid = int(meta.get("client_id", 0))
        arrival = pol.Arrival(update=delta, client_params=client_params,
                              tau=meta.get("tau", 0), client_id=cid,
                              data_size=float(meta.get("data_size", 1.0)),
                              sketch=meta.get("sketch"))
        self.state, updated, entry = self.policy.step(self.state, arrival)
        if entry is not None:
            self.log.append(entry)
        return updated

    def host_log(self) -> List[dict]:
        """The per-update log with every tensor moved to the host: a 0-d
        tensor (asyncfeded's coefficient) becomes a float, any other a
        numpy array. Entries keep device tensors while the run goes on, so
        that a receive does not wait on the device."""
        def host(v):
            if not isinstance(v, torch.Tensor):
                return v
            return float(v) if v.dim() == 0 else v.cpu().numpy()
        return [{k: host(v) for k, v in e.items()} for e in self.log]

    def receive_many(self, deltas, client_params, client_ids, data_sizes,
                     v_dispatch, sketches=None):
        """Batched ingest for the cohort engine: B completions, ordered by
        completion time, as stacked flat ``(B, d)`` rows. An in-order loop
        of ``receive``, staleness resolved per arrival from the running
        version and ``v_dispatch`` (the version each client was dispatched
        at). Returns ``(updated (B,) bool, taus, snapshots)``:
        ``snapshots[i]`` is the flat global vector after arrival i — what a
        completion-triggered re-dispatch at that instant trains from. The
        B rows are the versions' own tensors, never written in place, so
        they need no copy."""
        if self.needs_sketch and sketches is None:
            raise KeyError(f"{self.name} requires behavioral sketches")
        B = int(deltas.shape[0])
        updated = np.zeros((B,), bool)
        taus: List[int] = []
        snapshots = []
        for i in range(B):
            tau = self.version - int(v_dispatch[i])
            meta = {"tau": tau, "client_id": int(client_ids[i]),
                    "data_size": float(data_sizes[i])}
            if sketches is not None:
                meta["sketch"] = sketches[i]
            updated[i] = self.receive(deltas[i], client_params[i], meta)
            taus.append(tau)
            snapshots.append(self.flat_params)
        return updated, taus, snapshots


# ---------------------------------------------------------------------------
# Mesh-sharded execution layer
# ---------------------------------------------------------------------------

def server_state_specs(state: pol.ServerState, axis: str) -> dict:
    """The sharded-layout contract: state field name (``policies.
    state_array_names``) -> its partition spec, one entry per dimension (a
    mesh axis, or None for a replicated one). Exactly the tensors whose
    trailing axis is the flat parameter axis shard over ``axis``:
    ``params`` (d,), ``ring/data`` (L, d), ``psa/buffer`` (L_s, d),
    ``cache/data`` (C, d) and ``cache/total`` (d,). Everything else
    (versions, fill counts, kappas, the thermometer, sketches, the cache's
    valid mask) is small and replicated, with spec ``()``."""
    row, mat = (axis,), (None, axis)
    sharded = {"params": row, "ring/data": mat, "psa/buffer": mat,
               "cache/data": mat, "cache/total": row}
    return {name: sharded.get(name, ())
            for name in pol.state_array_names(state)}


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the trailing (flat parameter) axis up to ``width``. The pad
    is zero in every d-sized input, so it stays zero through every
    policy's elementwise rules and adds nothing to the sums across
    shards."""
    pad = width - x.shape[-1]
    return x if pad == 0 else F.pad(x, (0, pad))


class ShardedPolicyServer(PolicyServer):
    """``PolicyServer`` with ``ServerState`` laid out over a one-axis mesh,
    one process a rank.

    The flat parameter axis is zero-padded to ``d_pad``, the next multiple
    of the rank count n, and rank r holds ``[r * d_pad / n, (r + 1) * d_pad
    / n)`` of every tensor ``server_state_specs`` shards, each shard a
    tensor of its own. The policy's step is the single-device code, run on
    the shards inside ``common.sharding.param_axis``: each rank launches
    ``buffer_agg`` on its shard, its scalar sums over d add their chunk
    partials in one ``all_reduce`` (``common.sharding.param_axis_sums``:
    the single-device bits), asyncfeded's sketch sums its (k,) partials in
    one ``all_reduce``, and FedPSA's sketch refresh
    gathers the whole vector first. Every rank keeps the replicated fields (versions, kappas,
    sketches, the thermometer) equal, so the ranks take the same branches
    and issue the same collectives in the same order.

    Host-facing results are the single-device server's: ``flat_params`` is
    the gathered, unpadded (d,) vector (one ``all_gather`` a version,
    cached), ``receive_many`` returns unpadded rows, and ``receive`` takes
    whole (d,) vectors or trees; ``state_arrays`` gathers the unpadded state
    and ``load_state_arrays`` takes it, so a checkpoint resumes on any rank
    count."""

    def __init__(self, policy: pol.Policy, params, mesh,
                 rules: Optional[sharding.LogicalRules] = None):
        axis = sharding.mesh_axis(mesh, rules, "param_shard")
        if axis is None:
            got = (rules or sharding.FEDERATED_RULES).mesh_axes(
                ("param_shard",))[0]
            raise ValueError(f"rules must map 'param_shard' onto a mesh axis "
                             f"of {tuple(mesh.mesh_dim_names or ())}, got "
                             f"{got!r}")
        self.axis = axis
        d, n = policy.spec.size, axis.size
        self._d = d
        self._d_pad = -(-d // n) * n
        self._d_local = self._d_pad // n
        self._lo = axis.rank * self._d_local
        super().__init__(policy, params)
        self._specs = server_state_specs(self.state, axis.name)
        self._sharded = {k for k, v in self._specs.items() if v}
        pol.map_state_tensors(self.state, self._sharded,
                              lambda t: torch.clone(self._local(t)))

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the trailing (padded) flat axis of x: a view
        where it lies inside d, zero-padded where it reaches past d."""
        lo = self._lo
        return _pad_last(x[..., lo:min(lo + self._d_local, self._d)],
                         self._d_local)

    def _flat(self, x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else self.policy.spec.flatten(x)

    @property
    def flat_params(self) -> torch.Tensor:
        """The unpadded (d,) global vector, gathered once a version."""
        return self.axis.gather(self.state.params, self._d)

    def receive(self, delta, client_params, meta) -> bool:
        with sharding.param_axis(self.axis, self._d):
            return super().receive(self._local(self._flat(delta)),
                                   self._local(self._flat(client_params)),
                                   meta)

    def state_arrays(self) -> dict:
        def whole(name, t):
            if name not in self._sharded:
                return t
            return sharding.all_gather_cat(t, self.axis, dim=-1)[..., :self._d]
        return pol.state_arrays(self.state, whole)

    def load_state_arrays(self, arrays: dict) -> None:
        def local(name, a):
            if name not in self._sharded:
                return a
            return self._local(torch.from_numpy(np.ascontiguousarray(a))
                               ).numpy()
        pol.load_state_arrays(self.state, arrays, local)
        self._tree_cache_version = -1


class LanePolicyServer:
    """S experiment lanes of one policy over one shared event timeline.

    Each lane is a ``PolicyServer`` with its own ``ServerState``, built by
    the policy's ``init`` with that lane's ``PolicyParams``, so every lane
    runs the standalone server's code. ``receive_many`` steps the lanes in
    lane order over their own ``(B, d)`` rows (one ``buffer_agg`` launch
    per lane and per apply). Every policy's update decision depends only on
    arrival counts, never on values, so the ``updated`` flags and the
    version are the same in every lane (asserted at ingest)."""

    def __init__(self, policy: pol.Policy, params_per_lane,
                 hypers: List[pol.PolicyParams]):
        if len(params_per_lane) != len(hypers) or not hypers:
            raise ValueError("one params tree and one hyper record a lane")
        self.policy = policy
        self.name = policy.name
        self.needs_sketch = policy.needs_sketch
        self.client_align = policy.client_align
        self.num_lanes = len(hypers)
        self.lanes = [PolicyServer(policy, p, h)
                      for p, h in zip(params_per_lane, hypers)]
        self._flat = None
        self._flat_version = -1

    @property
    def version(self) -> int:
        return self.lanes[0].version

    @property
    def flat_params(self) -> torch.Tensor:
        """(S, d) stack of the lanes' global vectors: a fresh tensor per
        version, never written in place (dispatch snapshots hold it)."""
        if self._flat_version != self.version:
            self._flat = torch.stack([l.flat_params for l in self.lanes])
            self._flat_version = self.version
        return self._flat

    def receive_many(self, deltas, client_params, client_ids, data_sizes,
                     v_dispatch, sketches=None):
        """B completions for every lane: ``deltas``/``client_params`` (and
        ``sketches``) are ``(S, B, ...)`` stacks, the scalar arrival fields
        are shared. Returns ``(updated (B,) bool, taus, snapshots (S, B,
        d))``, ``PolicyServer.receive_many``'s contract with a lane axis."""
        S = int(deltas.shape[0])
        if S != self.num_lanes:
            raise ValueError(f"{S} lanes of rows for {self.num_lanes} lanes")
        if self.needs_sketch and sketches is None:
            raise KeyError(f"{self.name} requires behavioral sketches")
        out = [lane.receive_many(deltas[s], client_params[s], client_ids,
                                 data_sizes, v_dispatch,
                                 None if sketches is None else sketches[s])
               for s, lane in enumerate(self.lanes)]
        updated, taus, _ = out[0]
        # the lane contract: update decisions are count-driven, never
        # value-driven, so they cannot diverge across lanes
        if any(not np.array_equal(u, updated) for u, _, _ in out):
            raise AssertionError("policy update decisions diverged across "
                                 "sweep lanes")
        snaps = torch.stack([r for _, _, rows in out for r in rows])
        return updated, taus, snaps.view(S, len(taus), -1)


def _policy(name: str, spec: FlatSpec, num_clients: int,
            psa_cfg: Optional[psa_lib.PSAConfig],
            sketch_fn: Optional[Callable], kw: dict) -> pol.Policy:
    refresh = None
    if name == "fedpsa":
        if psa_cfg is None or sketch_fn is None:
            raise ValueError("fedpsa needs psa_cfg and sketch_fn")
        # the refresh reads the whole vector: on a shard it gathers first
        # (the same (k,) sketch on every rank)
        refresh = lambda vec: sketch_fn(spec.unflatten(  # noqa: E731
            sharding.gather_param_axis(vec, spec.size)))
    return pol.make_policy(name, spec, num_clients=num_clients,
                           psa_cfg=psa_cfg, sketch_refresh=refresh, **kw)


def make_server(name: str, params, *, num_clients: int = 50,
                psa_cfg: Optional[psa_lib.PSAConfig] = None,
                sketch_fn: Optional[Callable] = None, mesh=None,
                rules: Optional[sharding.LogicalRules] = None,
                **kw) -> PolicyServer:
    """Build the policy-backed server for one algorithm. ``sketch_fn``
    (fedpsa) maps a params tree to its (k,) sketch; the policy applies it
    to the flat global vector through ``spec.unflatten``. With ``mesh`` (a
    ``DeviceMesh``, ``launch.mesh.make_fed_mesh``) the state is sharded
    over the mesh axis that ``rules`` (default ``common.sharding.
    FEDERATED_RULES``) map ``param_shard`` onto (``ShardedPolicyServer``);
    every rank of the mesh builds its server with the same arguments."""
    policy = _policy(name, FlatSpec(params), num_clients, psa_cfg, sketch_fn,
                     kw)
    if mesh is not None:
        return ShardedPolicyServer(policy, params, mesh, rules)
    return PolicyServer(policy, params)


def make_lane_server(name: str, params_per_lane, lane_hypers, *,
                     num_clients: int = 50,
                     psa_cfg: Optional[psa_lib.PSAConfig] = None,
                     sketch_fn: Optional[Callable] = None,
                     **kw) -> LanePolicyServer:
    """Build the lane server for one algorithm. ``params_per_lane`` is a
    list of S trees of one layout; ``lane_hypers`` a list of S dicts of
    per-lane overrides (``PolicyParams`` field names, e.g. ``{"alpha":
    0.3}`` or ``{"gamma": 0.1, "use_thermometer": False}``) merged over the
    policy's factory values. Structural kwargs (buffer_size, psa_cfg
    shapes, ...) are shared by all lanes; ``make_hyper`` rejects them per
    lane."""
    policy = _policy(name, FlatSpec(params_per_lane[0]), num_clients,
                     psa_cfg, sketch_fn, kw)
    hypers = [pol.make_hyper(**{**policy.hyper._asdict(), **(over or {})})
              for over in lane_hypers]
    return LanePolicyServer(policy, params_per_lane, hypers)
