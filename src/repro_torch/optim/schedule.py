"""Learning-rate schedules: callables host step -> lr, a host float holding
the float32 value the reference's jnp schedule gives (so a step reads no
device value)."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant_lr(lr: float):
    return lambda step: float(_F(lr))


def _integer_pow(x: _F, n: int) -> _F:
    """x ** n for a host int n >= 0 by binary exponentiation in float32,
    the products in the order of XLA's ``integer_pow``, which the
    reference's ``jnp.power`` takes for an integer exponent."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else _F(acc * x)
        n >>= 1
        if n > 0:
            x = _F(x * x)
    return _F(1.0) if acc is None else acc


def exponential_decay(lr: float, decay: float = 0.999):
    """The paper's per-round decay: lr * decay^round."""
    return lambda step: float(_F(lr) * _integer_pow(_F(decay), int(step)))


def _cosine(lr: float, total_steps: int, final_frac: float, step) -> _F:
    p = np.clip(_F(step) / _F(total_steps), _F(0.0), _F(1.0))
    cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * p))
    return _F(lr) * (_F(final_frac) + _F(1.0 - final_frac) * cos)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    return lambda step: float(_cosine(lr, total_steps, final_frac, step))


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup over ``warmup`` steps, then ``cosine_decay`` over the
    rest."""
    total = max(total_steps - warmup, 1)

    def fn(step):
        if step < warmup:
            w = np.clip(_F(step) / _F(max(warmup, 1)), _F(0.0), _F(1.0))
            return float(_F(lr) * w)
        return float(_cosine(lr, total, final_frac, step - warmup))
    return fn
