"""FedPSA (Algorithm 1): a ring of L updates with their sketch cosines
kappa to the global sketch, a queue of the last ``queue_len`` update
magnitudes; on a full ring, softmax(kappa / Temp) weights (uniform until
the queue first fills), Temp = (mean of the queue / its mean when first
full) x gamma + delta, Eq. 20's apply, and the new global model's
sketch."""
from __future__ import annotations

import math

import numpy as np
import torch

from fedbench.reference.numbers import cosine, norm_gaps
from fedbench.reference.sketch import Sketcher

NUMBERS = ("sketch_gap", "kappa_gap", "late_kappa_gap", "temp_gap",
           "weight_gap", "apply_gap")


def versions_after(n: int, mix: dict) -> int:
    return n // int(mix["psa"]["buffer_size"])


def sketcher(model, world, mix, device, dtype):
    p = mix["psa"]
    return Sketcher(model,
                    torch.as_tensor(world.calib_x, device=device).to(dtype),
                    torch.as_tensor(world.calib_y, device=device).long(),
                    p["sketch_seed"], p["sketch_k"], p["fisher_microbatches"])


def temperature(magnitudes, p: dict):
    """Eq. 16-18 over every magnitude pushed so far: ``(temp, full)``,
    ``temp`` None until the queue first fills."""
    Lq = int(p["queue_len"])
    if len(magnitudes) < Lq:
        return None, False
    m0 = sum(magnitudes[:Lq]) / Lq
    cur = sum(magnitudes[-Lq:]) / Lq
    return cur / max(m0, 1e-30) * p["gamma"] + p["delta"], True


def weights(kappas: torch.Tensor, temp, L: int) -> torch.Tensor:
    if temp is None:
        return torch.full((L,), 1.0 / L, dtype=kappas.dtype,
                          device=kappas.device)
    return torch.softmax(kappas / max(float(temp), 1e-6), dim=0)


def apply(w, weights_: torch.Tensor, updates, server_lr: float):
    lr = float(np.float32(server_lr))
    for wl, dw in zip(weights_, updates):
        w = torch.addcmul(w, wl * lr, dw)
    return w


class Server:
    def __init__(self, w0, mix: dict, sketcher):
        self.w, self.version, self.p, self.sketch = w0, 0, mix["psa"], \
            sketcher
        self.ring, self.kappas, self.magnitudes = [], [], []
        self.gsk = sketcher(w0)
        self.log = []

    def client_sketch(self, w):
        return self.sketch(w)

    def receive(self, dw, w_client, tau: int, sketch) -> None:
        self.kappas.append(cosine(sketch, self.gsk))
        self.ring.append(dw)
        self.magnitudes.append(torch.sum(torch.square(dw)))
        L = int(self.p["buffer_size"])
        if len(self.ring) < L:
            return
        temp, _ = temperature(self.magnitudes, self.p)
        kappas = torch.stack(self.kappas)
        wts = weights(kappas, temp, L)
        self.w = apply(self.w, wts, self.ring, self.p["server_lr"])
        self.version += 1
        self.ring, self.kappas = [], []
        self.gsk = self.sketch(self.w)
        self.log.append({"weights": wts, "kappas": kappas, "temp": temp})


def judge(ctx, version: int, receives, out: dict, prefix: str = "") -> None:
    """From the record's own state, for the update made by ``receives``:

    - ``sketch_gap``: each client sketch against this sketch of the
      record's client model, over its norm;
    - ``kappa_gap``: each kappa against the cosine of that sketch and this
      sketch of the record's global model before the update (the sketch
      the record refreshed after its last update; ``late_kappa_gap`` in the
      later ranges, where that sketch is a refreshed one);
    - ``temp_gap``: the temperature against Eq. 16-18 over the magnitudes
      of every update the record received so far, relatively;
    - ``weight_gap``: the weights against softmax(the record's kappas /
      that temperature), or uniform before the queue fills;
    - ``apply_gap``: the global model's change against Eq. 20 with those
      weights over the record's updates, by the worst leaf."""
    p, rows, entry = ctx.mix["psa"], ctx.rows, ctx.log[version - 1]
    a, b = receives[0], receives[-1]
    base = ctx.global_after(a - 1)
    gsk = ctx.sketcher(base)
    for slot, i in enumerate(receives):
        want = ctx.sketcher(ctx.on(rows[i][1]))
        gap = torch.linalg.vector_norm(ctx.on(rows[i][3]) - want) \
            / torch.clamp(torch.linalg.vector_norm(want), min=1e-300)
        out["sketch_gap"] = max(out["sketch_gap"], float(gap))
        out[prefix + "kappa_gap"] = max(out[prefix + "kappa_gap"], abs(
            float(entry["kappas"][slot]) - float(cosine(want, gsk))))
    mags = [float(torch.sum(torch.square(ctx.on(rows[j][0]))))
            for j in range(b + 1)]
    temp, full = temperature(mags, p)
    if (entry["temp"] is not None) != full:
        out["temp_gap"] = math.inf
    elif full:
        out["temp_gap"] = max(out["temp_gap"],
                              abs(float(entry["temp"]) - temp) / temp)
    kappas = torch.as_tensor(np.asarray(entry["kappas"], np.float64),
                             device=base.device)
    want_w = weights(kappas, temp, len(receives))
    got_w = torch.as_tensor(np.asarray(entry["weights"], np.float64),
                            device=base.device)
    out["weight_gap"] = max(out["weight_gap"],
                            float(torch.max(torch.abs(got_w - want_w))))
    want = apply(base, want_w, [ctx.on(rows[i][0]) for i in receives],
                 p["server_lr"])
    gaps = norm_gaps(ctx.global_after(b) - base, want - base, ctx.sizes)
    out["apply_gap"] = max(out["apply_gap"], float(gaps.max()))
