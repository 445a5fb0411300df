"""Member-math routing: one seam for every dense layer a cohort member runs.

The port of the reference's ``repro.models.member_math``. The cohort engine
trains a wave of B members at once; model code calls ``member_dot`` for
every dense contraction, and the active routing mode decides how a
member-batched product executes:

* ``"vmap"`` (default): the plain product, ``torch.matmul`` — what XLA
  computes for the reference's vmapped ``dot_general``.
* ``"grouped"``: when both operands carry the member axis, the
  ``GroupedMatmul`` autograd function — the ``grouped_matmul`` kernel in
  the forward and again for both gradients (``dx = g @ w^T``,
  ``dw = x^T @ g``, the reference's bilinear transpose rules).

The reference gets the member axis from ``jax.vmap`` and its batching
rules. Here the axis is explicit: a member-batched operand carries a
leading ``B`` (``x_members`` / ``w_members``), and that ``B`` is the
kernel's group axis. A weight shared by all members (``w_members=False``)
is one ``(B*M, K) @ (K, N)`` matmul in either mode, as in the reference,
and operands without the member axis are a plain 2-D product.

The mode is a context (``routing``) entered around the code that builds
the products; it is held in a ``ContextVar``, so threads do not see each
other's mode.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from repro_torch.kernels.grouped_matmul import grouped_matmul

MODES = ("vmap", "grouped")
_MODE = contextvars.ContextVar("member_kernel", default="vmap")


@contextlib.contextmanager
def routing(mode: str):
    """Member-math mode for the products built inside the block."""
    if mode not in MODES:
        raise ValueError(f"member_kernel must be one of {MODES}, got {mode!r}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def current_mode() -> str:
    return _MODE.get()


class GroupedMatmul(torch.autograd.Function):
    """``(G, M, K) @ (G, K, N)`` through the grouped kernel, both ways."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul(g, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul(x.transpose(1, 2), g)
        return dx, dw


def member_dot(x: torch.Tensor, w: torch.Tensor, ncon: int = 1, *,
               x_members: bool = False, w_members: bool = False
               ) -> torch.Tensor:
    """Contract the last ``ncon`` axes of ``x`` with the first ``ncon`` of
    ``w`` (after their member axes): output = [B] ++ x-free axes ++ w-free
    axes. ``x_members`` / ``w_members`` say which operands carry a leading
    member axis B; a member-batched ``w`` needs a member-batched ``x``.
    Routes by the active member-math mode."""
    if w_members and not x_members:
        raise ValueError("member_dot: w carries the member axis but x does "
                         "not")
    if x.dtype != w.dtype:
        common = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(common), w.to(common)
    xa = 1 if x_members else 0
    wa = 1 if w_members else 0
    free = x.shape[xa:x.dim() - ncon]
    m = math.prod(free)
    k = math.prod(x.shape[x.dim() - ncon:])
    n = math.prod(w.shape[wa + ncon:])
    wshape = w.shape[wa + ncon:]
    if not w_members:
        # shared (or no) member axis on w: one big (B*M, K) @ (K, N)
        lead = x.shape[:xa]
        out = torch.matmul(x.reshape(-1, k), w.reshape(k, n))
        return out.reshape(lead + free + wshape)
    B = w.shape[0]
    x3 = x.reshape(B, m, k)
    w3 = w.reshape(B, k, n)
    if _MODE.get() == "grouped":
        out = GroupedMatmul.apply(x3, w3)
    else:
        out = torch.matmul(x3, w3)
    return out.reshape((B,) + free + wshape)
