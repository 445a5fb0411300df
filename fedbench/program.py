"""The system under test: ``repro_torch``'s ``run_async`` (one lane) or
``run_sweep`` (several) on the benchmark's inputs, with the cohort engine
and the mix's member kernel.

The server each run builds is caught as it is made (a wrapper around
``repro_torch.federated.servers.make_server`` and ``make_lane_server``),
so that the rows a judged simulation keeps are told apart by lane and
each lane's per-update log can be read; ``PolicyServer.receive_many`` is
wrapped to keep, by reference (no copy, no sync), each lane's first
receives: the update, the client model, the global model after it (what a
client dispatched at that instant trains from) and the sketch. The
wrappers add no device work to the run.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


class Program:
    def __init__(self, cfg: dict, mix: dict, world, device: str):
        from repro_torch.core.psa import PSAConfig
        from repro_torch.data.loader import ClientDataset
        from repro_torch.data.synthetic import SyntheticClassification
        from repro_torch.federated import servers, simulator
        from repro_torch.kernels import ops
        from repro_torch.models.config import ModelConfig

        from fedbench.world import layout

        self.cfg, self.mix, self.device = cfg, mix, device
        self._sim, self._servers, self._ops = simulator, servers, ops
        self.model_cfg = ModelConfig(
            name=cfg["model"], family=cfg["family"],
            cnn_channels=tuple(cfg["cnn_channels"]),
            cnn_kernel=cfg["cnn_kernel"], mlp_hidden=tuple(cfg["mlp_hidden"]),
            input_hw=tuple(cfg["input_hw"]), num_classes=cfg["num_classes"])
        K = cfg["num_classes"]
        self.clients = [ClientDataset(SyntheticClassification(
            world.x_train[ix], world.y_train[ix], K)) for ix in world.parts]
        self.test = SyntheticClassification(world.x_test, world.y_test, K)
        # copies: what the program might write stays out of the
        # reference's inputs
        self.calib = {"x": world.calib_x.copy(), "y": world.calib_y.copy()}
        parts = torch.split(world.init_flat.clone(),
                            [int(np.prod(s)) for _, s in layout(cfg)])
        self.init = {}
        for (path, shape), p in zip(layout(cfg), parts):
            mod, leaf = path.split("/")
            self.init.setdefault(mod, {})[leaf] = p.view(shape)
        self.psa_cfg = PSAConfig(**mix["psa"]) if mix["psa"] else None
        self._made: List[object] = []
        self._originals = (servers.make_server, servers.make_lane_server)

        def catch(make):
            def made(*a, **kw):
                self._made.append(make(*a, **kw))
                return self._made[-1]
            return made

        servers.make_server = catch(servers.make_server)
        servers.make_lane_server = catch(servers.make_lane_server)

        # the first ``_keep`` receives of each server, kept by reference
        self._keep = 0
        self._kept = {}
        self._receive_many = servers.PolicyServer.receive_many
        receive_many = self._receive_many

        def keep(srv, deltas, client_params, client_ids, data_sizes,
                 v_dispatch, sketches=None):
            out = receive_many(srv, deltas, client_params, client_ids,
                               data_sizes, v_dispatch, sketches)
            if self._keep:
                rows = self._kept.setdefault(id(srv), [])
                for i in range(min(len(out[2]), self._keep - len(rows))):
                    rows.append((deltas[i], client_params[i], out[2][i],
                                 None if sketches is None else sketches[i]))
            return out
        servers.PolicyServer.receive_many = keep

    def close(self) -> None:
        self._servers.make_server, self._servers.make_lane_server = \
            self._originals
        self._servers.PolicyServer.receive_many = self._receive_many

    def sim_config(self, horizon: float, seed: int, timeline_seed: int):
        w, mix = self.cfg["world"], self.mix
        return self._sim.SimConfig(
            num_clients=int(w["clients"]), concurrency=mix["concurrency"],
            local_epochs=int(w["local_epochs"]),
            batch_size=int(w["batch_size"]), lr=w["lr"],
            lr_decay=w["lr_decay"], horizon=float(horizon),
            eval_every=mix["eval_every"], latency_kind=mix["latency"]["kind"],
            latency_lo=mix["latency"]["lo"], latency_hi=mix["latency"]["hi"],
            seed=int(seed), timeline_seed=int(timeline_seed),
            eval_batches=int(w["eval_batches"]),
            eval_batch_size=int(w["eval_batch_size"]), engine=mix["engine"],
            member_kernel=mix["member_kernel"], device=self.device)

    def run(self, horizon: float, lane_seeds, timeline_seed: int,
            keep: int = 0) -> dict:
        """One simulation; returns its counters, receive log and each lane's
        per-update log, and with ``keep`` each lane's ``rows``: (update,
        client model, global model after, sketch) of its first ``keep``
        receives."""
        self._keep, self._kept = int(keep), {}
        sim = self.sim_config(horizon, lane_seeds[0], timeline_seed)
        kw = dict(psa_cfg=self.psa_cfg, calib_batch=self.calib,
                  server_kwargs=self.mix["server_kwargs"] or None)
        before = self._ops.launch_counts()
        if len(lane_seeds) == 1:
            res = self._sim.run_async(self.mix["policy"], self.model_cfg,
                                      self.init, self.clients, self.test,
                                      sim, **kw)
            lanes = [self._made.pop()]
            logs = [res.server_log]
        else:
            res = self._sim.run_sweep(
                self.mix["policy"], self.model_cfg, self.init, self.clients,
                self.test, sim,
                self._sim.SweepConfig(data_seeds=list(lane_seeds)), **kw)
            lanes = self._made.pop().lanes
            logs = [lane.host_log() for lane in lanes]
        after = self._ops.launch_counts()
        rows = ([self._kept.pop(id(s), []) for s in lanes] if keep
                else None)
        self._keep, self._kept = 0, {}
        return {"lanes": len(lane_seeds), "lane_seeds": list(lane_seeds),
                "timeline_seed": int(timeline_seed),
                "dispatches": res.dispatches, "cohorts": res.cohorts,
                "versions": res.versions, "local_steps": res.local_steps,
                "receive_log": [(e["t"], e["tau"], e["client"])
                                for e in res.receive_log],
                "launches": {k: after[k] - before[k] for k in after},
                "logs": logs, "rows": rows}
