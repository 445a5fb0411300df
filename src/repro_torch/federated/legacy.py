"""Legacy class-based servers: the pre-policy implementations.

The reference's ``repro.federated.legacy``: mutable Python-object servers
that apply one eager tree op at a time over list and deque buffers, with
host ``int`` versions. They are the numerical oracle of the policy servers
(``tests/test_torch_legacy.py`` holds every policy in
``repro_torch.federated.policies`` to its legacy trajectory, as the
reference's ``tests/test_policies.py`` does) and the baseline of the
server-step microbenchmark. Production traffic goes through
``repro_torch.federated.servers``.

Interface:
    receive(delta, client_params, meta) -> bool   # True if global updated
    params                                        # current global tree
    version                                       # number of global updates

Trees are dicts of tensors on one device; no op writes a tree it was
given. FedPSA's ``sketch_fn`` maps a tree to its (k,) sketch: on the card
the simulator's ``make_sketch_fn`` launches ``sens_sketch`` once a tree,
and the Eq. 20 apply here is the tree path (``aggregate_buffer``), not the
``buffer_agg`` kernel of the fused policy step.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import tree as tu
from repro_torch.core import aggregation as agg
from repro_torch.core import psa as psa_lib
from repro_torch.core import sketch as sketch_lib
from repro_torch.core import thermometer


def _device(params) -> torch.device:
    return tu.tree_leaves(params)[0].device


class BaseServer:
    name = "base"
    needs_sketch = False

    def __init__(self, params):
        self.params = params
        self.version = 0
        self.log: List[dict] = []

    def receive(self, delta, client_params, meta) -> bool:
        raise NotImplementedError


class FedAsyncServer(BaseServer):
    """FedAsync: immediate mixing w <- (1-a)w + a*w_i, a = alpha*s(tau)."""
    name = "fedasync"

    def __init__(self, params, alpha: float = 0.6, a: float = 0.5):
        super().__init__(params)
        self.alpha, self.a = alpha, a

    def receive(self, delta, client_params, meta) -> bool:
        s = agg.staleness_polynomial(meta["tau"], self.alpha, self.a)
        self.params = tu.tree_map(lambda w, wi: (1 - s) * w + s * wi,
                                  self.params, client_params)
        self.version += 1
        self.log.append({"tau": meta["tau"], "weight": s})
        return True


class FedBuffServer(BaseServer):
    """FedBuff: buffer K staleness-scaled deltas, apply their mean."""
    name = "fedbuff"

    def __init__(self, params, buffer_size: int = 5, server_lr: float = 1.0,
                 a: float = 0.5):
        super().__init__(params)
        self.buffer_size = buffer_size
        self.server_lr = server_lr
        self.a = a
        self.buffer: List = []

    def receive(self, delta, client_params, meta) -> bool:
        scale = agg.staleness_polynomial(meta["tau"], 1.0, self.a)
        self.buffer.append(tu.tree_scale(delta, scale))
        if len(self.buffer) < self.buffer_size:
            return False
        w = agg.uniform_weights(len(self.buffer),
                                _device(self.params)) * self.server_lr
        self.params = agg.aggregate_buffer(self.params, self.buffer, w)
        self.buffer.clear()
        self.version += 1
        return True


class _PSAEntry(NamedTuple):
    update: object           # tree dw_i
    kappa: torch.Tensor      # behavioral similarity vs the global sketch


class FedPSAServer(BaseServer):
    """FedPSA (Algorithm 1) with the original Python-list buffer: kappa
    scoring + thermometer + temperature-softmax aggregation, one host-driven
    tree op per arrival."""
    name = "fedpsa"
    needs_sketch = True

    def __init__(self, params, cfg_psa: psa_lib.PSAConfig,
                 sketch_fn: Callable):
        super().__init__(params)
        self.cfg = cfg_psa
        self.buffer: List[_PSAEntry] = []
        self.thermo = thermometer.init_thermometer(cfg_psa.queue_len,
                                                   _device(params))
        self.sketch_fn = sketch_fn  # params -> k-vector (shared calib batch)
        self.global_sketch = sketch_fn(params)

    def receive(self, delta, client_params, meta) -> bool:
        kappa = sketch_lib.cosine(meta["sketch"], self.global_sketch)
        self.buffer.append(_PSAEntry(delta, kappa))
        self.thermo = thermometer.push(self.thermo, tu.tree_sq_norm(delta))
        if len(self.buffer) < self.cfg.buffer_size:
            return False
        cfg = self.cfg
        kappas = torch.stack([e.kappa for e in self.buffer])
        if cfg.use_thermometer:
            if thermometer.is_full(self.thermo):
                temp = thermometer.temperature(self.thermo, cfg.gamma,
                                               cfg.delta)
                weights = agg.psa_weights(kappas, temp)
            else:
                weights = agg.uniform_weights(len(self.buffer), kappas.device)
                temp = None
        else:  # w/o T ablation: fixed early-phase temperature
            temp = torch.tensor(cfg.gamma + cfg.delta, dtype=torch.float32,
                                device=kappas.device)
            weights = agg.psa_weights(kappas, temp)
        self.params = agg.aggregate_buffer(
            self.params, [e.update for e in self.buffer], weights,
            cfg.server_lr)
        self.buffer.clear()
        self.version += 1
        self.global_sketch = self.sketch_fn(self.params)
        self.log.append({
            "weights": weights.cpu().numpy(),
            "kappas": kappas.cpu().numpy(),
            "temp": None if temp is None else float(temp),
        })
        return True


class CA2FLServer(BaseServer):
    """CA2FL: cached-update calibration. Keeps the latest delta h_i per
    client; aggregation calibrates the buffer mean with the cache mean."""
    name = "ca2fl"

    def __init__(self, params, num_clients: int, buffer_size: int = 5,
                 server_lr: float = 1.0):
        super().__init__(params)
        self.buffer_size = buffer_size
        self.server_lr = server_lr
        self.buffer: List = []
        self.cache: Dict[int, object] = {}
        self.num_clients = num_clients
        self.h_sum = None  # running sum of cached deltas

    def receive(self, delta, client_params, meta) -> bool:
        cid = meta["client_id"]
        prev = self.cache.get(cid)
        self.buffer.append((delta, prev))
        # update cache & running sum
        if self.h_sum is None:
            self.h_sum = tu.tree_zeros_like(delta)
        if prev is not None:
            self.h_sum = tu.tree_sub(self.h_sum, prev)
        self.h_sum = tu.tree_add(self.h_sum, delta)
        self.cache[cid] = delta
        if len(self.buffer) < self.buffer_size:
            return False
        n_cached = max(len(self.cache), 1)
        h_mean = tu.tree_scale(self.h_sum, 1.0 / n_cached)
        resid = [tu.tree_sub(d, p) if p is not None else d
                 for d, p in self.buffer]
        # the residuals summed in arrival order, then scaled once
        v = tu.tree_add(
            tu.tree_scale(
                tu.tree_map(lambda *xs: sum(xs), *resid)
                if len(resid) > 1 else resid[0],
                1.0 / len(resid)),
            h_mean)
        self.params = tu.tree_axpy(self.server_lr, v, self.params)
        self.buffer.clear()
        self.version += 1
        return True


class FedFaServer(BaseServer):
    """FedFa: fully-asynchronous queue of recent client models; the global
    model is a recency-weighted average of the queue, refreshed per arrival.
    The queue is a deque(maxlen=...) so eviction is O(1)."""
    name = "fedfa"

    def __init__(self, params, queue_len: int = 5, beta: float = 0.5):
        super().__init__(params)
        self.queue_len = queue_len
        self.beta = beta
        self.queue: collections.deque = collections.deque(maxlen=queue_len)

    def receive(self, delta, client_params, meta) -> bool:
        self.queue.append(client_params)
        n = len(self.queue)
        # the recency weights in numpy float32, then normalised
        w = np.array([self.beta ** (n - 1 - j) for j in range(n)], np.float32)
        w /= w.sum()
        self.params = tu.tree_weighted_sum(list(self.queue), w)
        self.version += 1
        return True


class FedPACLiteServer(BaseServer):
    """FedPAC-lite: FedBuff-style buffering; clients train with an extra
    classifier-alignment term (see client.local_update(align=...)). The
    feature-alignment of the full method is approximated by the head
    alignment — enough to reproduce its qualitative async behavior."""
    name = "fedpac"
    client_align = 0.1

    def __init__(self, params, buffer_size: int = 5, server_lr: float = 1.0):
        super().__init__(params)
        self.buffer_size = buffer_size
        self.server_lr = server_lr
        self.buffer: List = []

    def receive(self, delta, client_params, meta) -> bool:
        self.buffer.append(delta)
        if len(self.buffer) < self.buffer_size:
            return False
        w = agg.uniform_weights(len(self.buffer),
                                _device(self.params)) * self.server_lr
        self.params = agg.aggregate_buffer(self.params, self.buffer, w)
        self.buffer.clear()
        self.version += 1
        return True


def make_legacy_server(name: str, params, *, num_clients: int = 50,
                       psa_cfg: Optional[psa_lib.PSAConfig] = None,
                       sketch_fn: Optional[Callable] = None,
                       **kw) -> BaseServer:
    if name == "fedasync":
        return FedAsyncServer(params, **kw)
    if name == "fedbuff":
        return FedBuffServer(params, **kw)
    if name == "fedpsa":
        if psa_cfg is None or sketch_fn is None:
            raise ValueError("fedpsa needs psa_cfg and sketch_fn")
        return FedPSAServer(params, psa_cfg, sketch_fn)
    if name == "ca2fl":
        return CA2FLServer(params, num_clients=num_clients, **kw)
    if name == "fedfa":
        return FedFaServer(params, **kw)
    if name == "fedpac":
        return FedPACLiteServer(params, **kw)
    raise ValueError(f"unknown legacy server {name!r}")
