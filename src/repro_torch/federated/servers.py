"""Server-side aggregation strategies: a host adapter over the policy core.

``PolicyServer`` speaks the object interface the simulator uses, as the
reference's ``repro.federated.servers.PolicyServer`` does:

    receive(delta, client_params, meta) -> bool   # True if global updated
    params                                        # current global tree
    flat_params                                   # current global (d,) vector
    version                                       # number of global updates
    psa                                           # FedPSA sub-state

``meta`` carries tau (version gap), client_id, data_size and, for FedPSA,
the uploaded sensitivity sketch. Every version of the global model is its
own tensor (policies never write it in place), so ``flat_params`` and
``params`` can hand it out without a copy: a dispatch snapshot taken now
is still the same values after later receives.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.common.tree import FlatSpec
from repro_torch.core import psa as psa_lib
from repro_torch.federated import policies as pol


class PolicyServer:
    """Owns the ``ServerState`` of one ``Policy``, turns metas into
    ``Arrival``s and keeps the per-update log the benchmarks read."""

    def __init__(self, policy: pol.Policy, params):
        self.policy = policy
        self.name = policy.name
        self.needs_sketch = policy.needs_sketch
        self.client_align = policy.client_align
        self.state = policy.init(params)
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

    def receive(self, delta, client_params, meta) -> bool:
        """Ingest one completion; returns whether the global model moved."""
        if self.needs_sketch and "sketch" not in meta:
            raise KeyError(
                f"{self.name} requires meta['sketch'] (behavioral sketch)")
        arrival = pol.Arrival(update=delta, client_params=client_params,
                              tau=meta.get("tau", 0),
                              client_id=int(meta.get("client_id", 0)),
                              data_size=float(meta.get("data_size", 1.0)),
                              sketch=meta.get("sketch"))
        self.state, updated, entry = self.policy.step(self.state, arrival)
        if entry is not None:
            self.log.append(entry)
        return updated


def make_server(name: str, params, *, num_clients: int = 50,
                psa_cfg: Optional[psa_lib.PSAConfig] = None,
                sketch_fn: Optional[Callable] = None, mesh=None,
                **kw) -> PolicyServer:
    """Build the policy-backed server for one algorithm. ``sketch_fn``
    (fedpsa) maps a params tree to its (k,) sketch; the policy applies it
    to the flat global vector through ``spec.unflatten``."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded server is not ported to repro_torch "
            "(ROADMAP.md Queue 1 item 9)")
    spec = FlatSpec(params)
    refresh = None
    if name == "fedpsa":
        if psa_cfg is None or sketch_fn is None:
            raise ValueError("fedpsa needs psa_cfg and sketch_fn")
        refresh = lambda vec: sketch_fn(spec.unflatten(vec))  # noqa: E731
    policy = pol.make_policy(name, spec, num_clients=num_clients,
                             psa_cfg=psa_cfg, sketch_refresh=refresh, **kw)
    return PolicyServer(policy, params)
