"""Training thermometer (paper Eq. 16-18).

A fixed-size queue Q of recent update magnitudes m_i = ||dw_i||_2^2 and

    Temp = (M_cur / M_0) * gamma + delta

with M_cur the current queue mean and M_0 the mean when the queue first
filled. The push count is a host ``int`` (the reference traces it), so the
"is the queue full" branch costs no device sync; the queue and the means
stay on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ThermometerState:
    queue: torch.Tensor   # (L_q,) f32 ring buffer
    count: int            # total number of pushes
    m0: torch.Tensor      # queue mean when first full (0 until then)

    @property
    def capacity(self) -> int:
        return self.queue.shape[0]


def init_thermometer(queue_len: int = 50, device="cpu") -> ThermometerState:
    return ThermometerState(
        queue=torch.zeros((queue_len,), dtype=torch.float32, device=device),
        count=0,
        m0=torch.zeros((), dtype=torch.float32, device=device))


def push(state: ThermometerState, m: torch.Tensor) -> ThermometerState:
    """Push one magnitude in place; the oldest entry is overwritten once
    full. Captures M_0 on the push that fills the queue the first time."""
    L = state.capacity
    state.queue[state.count % L] = m
    state.count += 1
    if state.count == L:
        state.m0 = torch.sum(state.queue) / L
    return state


def is_full(state: ThermometerState) -> bool:
    return state.count >= state.capacity


def current_mean(state: ThermometerState) -> torch.Tensor:
    """M_cur: mean over valid entries (whole ring once full)."""
    n = min(state.count, state.capacity)
    return torch.sum(state.queue) / float(max(n, 1))


def temperature(state: ThermometerState, gamma: float = 5.0,
                delta: float = 0.5) -> torch.Tensor:
    """Eq. 18. Only meaningful once the queue is full (the caller weights
    uniformly before that — Algorithm 1)."""
    ratio = current_mean(state) / torch.clamp(state.m0, min=1e-30)
    return ratio * gamma + delta
