"""FedAsync: every receive mixes the client model into the global one,
w <- (1 - s) w + s w_i with s = alpha (1 + tau)^-a in float32."""
from __future__ import annotations

import numpy as np

from fedbench.reference.numbers import norm_gaps

NUMBERS = ("apply_gap",)


def versions_after(n: int, mix: dict) -> int:
    return n


def sketcher(model, world, mix, device, dtype):
    return None


def scale(tau: int, alpha: float, a: float) -> float:
    return float(np.float32(alpha)
                 * np.power(np.float32(1.0 + tau), np.float32(-a)))


def mix_in(w, w_client, tau: int, alpha: float, a: float):
    s = scale(tau, alpha, a)
    return float(np.float32(1.0) - np.float32(s)) * w + s * w_client, s


class Server:
    def __init__(self, w0, mix: dict, sketcher=None):
        self.w, self.version = w0, 0
        self.alpha, self.a = mix["server_kwargs"]["alpha"], \
            mix["server_kwargs"]["a"]
        self.log = []

    def client_sketch(self, w):
        return None

    def receive(self, dw, w_client, tau: int, sketch=None) -> None:
        self.w, s = mix_in(self.w, w_client, tau, self.alpha, self.a)
        self.version += 1
        self.log.append({"weight": s})


def judge(ctx, version: int, receives, out: dict, prefix: str = "") -> None:
    """``apply_gap``: the global model's change at this receive against
    the mix of the record's client model into the record's global model
    before it, by the worst leaf."""
    kw = ctx.mix["server_kwargs"]
    for i in receives:
        base = ctx.global_after(i - 1)
        want, _ = mix_in(base, ctx.on(ctx.rows[i][1]), ctx.taus[i],
                         kw["alpha"], kw["a"])
        gaps = norm_gaps(ctx.global_after(i) - base, want - base, ctx.sizes)
        out["apply_gap"] = max(out["apply_gap"], float(gaps.max()))
