"""One asynchronous simulation, one client update at a time.

The event loop: ``concurrency x clients`` dispatches at t = 0; each
completion, in order of (completion time, dispatch order), trains the
client's local SGD from the global model it was dispatched with, hands
the update to the server policy, and dispatches a new client at that
instant with the global model as it then is. Completions after the
horizon are not received. The random streams are NumPy's MT19937 as the
paper code seeds them: client picks from ``RandomState(timeline_seed)``,
per-client mean latencies U(lo, hi) and a U(0.9, 1.1) jitter from
sub-seeds of it; each local update's batches from ``RandomState(seed *
100003 + receives)``, a fresh permutation an epoch, drop-last.

The server policy is ``fedbench/reference/policies/<policy>.py``, found by
the mix's name for it (``policy``): a new policy is a new file there.
"""
from __future__ import annotations

import heapq
import importlib
from contextlib import contextmanager
from typing import List, NamedTuple

import numpy as np
import torch

from fedbench.reference.model import CNN


def policy(name: str):
    """The reference module of server policy ``name``."""
    try:
        return importlib.import_module(f"fedbench.reference.policies.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference for policy {name!r}") from e


def _subseed(seed: int, stream: int) -> int:
    return (int(seed) * 0x9E3779B1 + 0x85EBCA77 * (stream + 1)) % (2 ** 32)


def batch_schedule(n: int, epochs: int, batch_size: int, seed: int):
    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    m = n // bs
    return [rng.permutation(n)[:m * bs].reshape(m, bs)
            for _ in range(epochs)]


class Receive(NamedTuple):
    t: float
    tau: int
    client: int
    trigger: int     # the receive whose completion dispatched it; -1: t = 0


class Timeline:
    def __init__(self, num_clients: int, lo: float, hi: float,
                 timeline_seed: int):
        self.C, self.lo, self.hi = num_clients, lo, hi
        self.pick = np.random.RandomState(timeline_seed)
        self.means = np.random.RandomState(
            _subseed(timeline_seed, 0)).uniform(lo, hi, size=num_clients)
        self.jitter = np.random.RandomState(_subseed(timeline_seed, 1))
        self.heap, self.seq = [], 0

    def dispatch(self, ts, version: int, trigger: int) -> None:
        ts = np.asarray(ts, np.float64)
        cids = self.pick.randint(self.C, size=len(ts))
        lat = np.clip(self.means[cids]
                      * self.jitter.uniform(0.9, 1.1, size=len(ts)),
                      self.lo, self.hi)
        for t, c in zip(ts + lat, cids):
            heapq.heappush(self.heap, (float(t), self.seq, int(c), version,
                                       trigger))
            self.seq += 1

    def pop(self):
        return heapq.heappop(self.heap)


def schedule(cfg: dict, mix: dict, timeline_seed: int) -> List[Receive]:
    """Every receive within the horizon, in order. The timeline does not
    depend on the model: versions are count-driven (the policy's
    ``versions_after``)."""
    lat = mix["latency"]
    if lat["kind"] != "uniform":
        raise ValueError(f"no reference for latency {lat['kind']!r}")
    pol = policy(mix["policy"])
    C = int(cfg["world"]["clients"])
    tl = Timeline(C, float(lat["lo"]), float(lat["hi"]), timeline_seed)
    tl.dispatch(np.zeros(max(1, int(round(mix["concurrency"] * C)))), 0, -1)
    out: List[Receive] = []
    while tl.heap:
        t, _, cid, version, trigger = tl.pop()
        if t > mix["horizon"]:
            break
        out.append(Receive(t, pol.versions_after(len(out), mix) - version,
                           cid, trigger))
        tl.dispatch([t], pol.versions_after(len(out), mix), len(out) - 1)
    return out


def judged_receives(mix: dict, version: int) -> range:
    """The receives that make global update ``version`` (1-based): those
    that arrive while the global model is at ``version - 1``."""
    pol = policy(mix["policy"])
    i = 0
    while pol.versions_after(i, mix) < version - 1:
        i += 1
    j = i
    while pol.versions_after(j, mix) < version:
        j += 1
    return range(i, j)


@contextmanager
def precision(device, mode: str):
    """``"f64"``: float64 (TF32 off). ``"tf32"`` (the control): float32
    with cuBLAS and cuDNN in TF32 on a CUDA device, and on a CPU TF32
    rounding of every product's operands. Yields whether to emulate."""
    if mode not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32" and torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield mode == "tf32" and not on
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Local:
    """A client's local SGD on the benchmark's inputs, in the dtype of the
    model it starts from."""

    def __init__(self, cfg: dict, world, device, dtype, emulate_tf32=False):
        self.w_cfg = cfg["world"]
        self.model = CNN(cfg, emulate_tf32=emulate_tf32)
        self.x = torch.as_tensor(world.x_train, device=device).to(dtype)
        self.y = torch.as_tensor(world.y_train, device=device)
        self.parts, self.device = world.parts, device

    def train(self, w: torch.Tensor, client: int, receive: int,
              seed: int) -> torch.Tensor:
        """The client model after local SGD from ``w``: the ``receive``-th
        receive of the lane seeded ``seed``."""
        c = self.w_cfg
        lr32 = float(np.float32(c["lr"] * (c["lr_decay"] ** receive)))
        idx = torch.as_tensor(self.parts[client], device=self.device)
        xc, yc = self.x[idx], self.y[idx]
        for epoch in batch_schedule(len(idx), int(c["local_epochs"]),
                                    int(c["batch_size"]),
                                    seed * 100003 + receive):
            for b in torch.as_tensor(epoch, device=self.device):
                g = self.model.grad(w, xc[b], yc[b])
                with torch.no_grad():
                    w = w - lr32 * g
        return w


def simulate(cfg: dict, mix: dict, world, *, seed: int, timeline_seed: int,
             device, mode: str = "f64", versions=None) -> dict:
    """One lane, to the horizon or until ``versions`` global updates, in
    ``precision(mode)``. Returns ``receive_log`` [(t, tau, client)] (the
    whole horizon's), the ``initial`` and ``final`` global models, ``rows``
    [(update, client model, global model after, sketch)] over the receives
    it trained, in the layout of the program's record, and the policy's
    per-update ``log``."""
    dt = torch.float64 if mode == "f64" else torch.float32
    pol = policy(mix["policy"])
    sched = schedule(cfg, mix, timeline_seed)
    with precision(device, mode) as emulate:
        local = Local(cfg, world, device, dt, emulate)
        w0 = world.init_flat.to(device=device, dtype=dt).clone()
        server = pol.Server(w0, mix, pol.sketcher(local.model, world, mix,
                                                  device, dt))
        rows = []
        for i, r in enumerate(sched):
            if versions is not None and server.version >= versions:
                break
            snap = w0 if r.trigger < 0 else rows[r.trigger][2]
            w = local.train(snap, r.client, i, seed)
            sk = server.client_sketch(w)
            server.receive(w - snap, w, r.tau, sk)
            rows.append((w - snap, w, server.w, sk))
    return {"initial": w0, "final": server.w,
            "receive_log": [(r.t, r.tau, r.client) for r in sched],
            "rows": rows, "log": server.log}
