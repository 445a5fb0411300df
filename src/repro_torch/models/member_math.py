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

The CNN's convolutions go through ``member_conv2d``: the members' channel
groups side by side in one grouped convolution (one group when the
operands carry no member axis). Its forward and input gradient are
cuDNN's; its weight gradient is the product of the output gradient with
the unfolded input, per member, routed like a member-batched dense
product (see ``MemberConv2d``).

The mode is a context (``routing``) entered around the code that builds
the products; it is held in a ``ContextVar``, so threads do not see each
other's mode. Under sharding rules (``common.sharding.logical_rules``: the
dry run's DTensors) a product without the member axis runs on each
device's shards (``models/sharded.dot``), laid out as GSPMD lays the
reference's ``dot_general``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models import sharded

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
    if not w_members and sharding.current_rules() is not None:
        return sharded.dot(x, w, ncon, member_dot)
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


class MemberConv2d(torch.autograd.Function):
    """Stride-1 grouped convolution: ``x (n, G*C_in, H, W)``, ``w (G*C_out,
    C_in, kh, kw)``, ``groups = G``.

    The forward and the input gradient are cuDNN's on the card (the
    forward is ATen's native convolution on the CPU). The weight gradient is
    not: under ``cudnn.deterministic`` (which resume and lane parity need)
    cuDNN's float32 weight-gradient algorithms for the CNN's shapes miss a
    float64 reference by up to thousands of ``u = 2**-24`` of the sum of
    the terms' magnitudes, where the forward and the input gradient stay
    within a few (``chip_smoke.py``'s ``[lane-ops]`` probe). So it is
    ``dW_g = gy_g (C_out, n*L) @ unfold(x)_g (n*L, C_in*kh*kw)`` for each
    member g: through ``grouped_matmul`` in the ``"grouped"`` mode, whose
    split depends on one member's shape alone, so a member's gradient is
    the same bits in a wave of any width; through ``torch.matmul``
    otherwise."""

    @staticmethod
    def forward(ctx, x, w, groups: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.groups, ctx.padding = groups, padding
        ctx.grouped = _MODE.get() == "grouped"
        if x.device.type != "cpu":
            return F.conv2d(x, w, padding=padding, groups=groups)
        # On the CPU, ATen's own im2col-and-GEMM convolution, not oneDNN's:
        # through oneDNN's float32 sums the CIFAR-100 logits sat at 0.92 of
        # the reference parity limit from float64, the reference's at 0.37
        # (tests/test_torch_model_f64.py prints both). A member's bits do
        # not depend on the group count here. The flag is process-wide,
        # and only this thread runs convolutions.
        mkldnn = torch.backends.mkldnn
        was = mkldnn.enabled
        mkldnn.enabled = False
        try:
            return F.conv2d(x, w, padding=padding, groups=groups)
        finally:
            mkldnn.enabled = was

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        G, p = ctx.groups, ctx.padding
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, gy, padding=p,
                                            groups=G)
        if ctx.needs_input_grad[1]:
            n = x.shape[0]
            c_in, kh, kw = w.shape[1:]
            # the input's kh x kw windows as a strided view (n, G, c_in,
            # Ho, Wo, kh, kw), gathered into (G, n*Ho*Wo, c_in*kh*kw) by one
            # copy (F.unfold launches an im2col kernel per image)
            win = F.pad(x, (p, p, p, p)).unfold(2, kh, 1).unfold(3, kw, 1)
            Ho, Wo = win.shape[2:4]
            rhs = win.reshape(n, G, c_in, Ho, Wo, kh, kw) \
                .permute(1, 0, 3, 4, 2, 5, 6).reshape(G, n * Ho * Wo, -1)
            lhs = gy.reshape(n, G, -1, Ho * Wo).permute(1, 2, 0, 3) \
                .reshape(G, -1, n * Ho * Wo)
            mm = grouped_matmul if ctx.grouped else torch.matmul
            dw = mm(lhs, rhs).reshape(w.shape)
        return dx, dw, None, None


def member_conv2d(x: torch.Tensor, w: torch.Tensor, groups: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """``F.conv2d(x, w, padding=padding, groups=groups)`` (stride 1) with
    ``MemberConv2d``'s weight gradient."""
    return MemberConv2d.apply(x, w, groups, padding)
