"""Mixture-of-Experts feed-forward with token-choice top-k capacity routing.

The port of the reference's ``repro.models.moe``: GShard-style dispatch.
Each token picks its top-k experts; a cumulative-sum position gives every
(token, expert) choice a slot in a capacity buffer ``(E, C, D)``, and the
choices that overflow are dropped. The tokens split into
``cfg.dispatch_groups`` groups that each route within their own capacity
``C = moe_capacity(cfg, T // G)``, so the group count decides which tokens
drop. ``moe_forward_dense`` is the dropless oracle.

The variants the reference supports: qwen2-moe (60 routed top-4 with the
selected probabilities renormalised, plus shared experts), jamba (16 routed
top-2 on alternating layers) and arctic (128 routed top-2 beside a dense
FFN, the ``"moe+dense"`` kind of ``models/model.py``).

Top-k is ``jax.lax.top_k``'s order: probabilities descending, the lower
expert first on a tie (a stable descending sort), so both sides give every
choice the same expert and slot. Dispatch and combine move rows without
float atomics: each slot receives at most one choice, so dispatch is a
gather through the inverse map (slot -> choice) and combine a gather
through the forward map (choice -> slot) followed by a sum over the k
choices of each token in a fixed order; each gather's gradient is the
gather through the other map (``_MapGather``), and a token's gradient adds
its k choices' in the expand's sum. With ``members=True`` the parameters
and x carry a leading member axis, and each member routes its own tokens.
Under the context's rules (``common.sharding.logical_rules``) the group
axis carries the batch sharding and the buffers the expert sharding, at the
reference's constraint sites; the dispatch plan and the gathers then run
on each device's groups (``models/sharded.group_local``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.sharding import constrain
from repro_torch.models import layers, sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.member_math import member_dot


def init_moe(gen, cfg: ModelConfig, device, lead=()) -> dict:
    pd = layers.param_dtype_of(cfg)
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": layers.dense_init(gen, (D, E), pd, device, scale=0.02,
                                    lead=lead),
        # the reference's law: fan-in taken from the first axis, E
        "w_in": layers.dense_init(gen, (E, D, Fd), pd, device, lead=lead),
        "w_gate": layers.dense_init(gen, (E, D, Fd), pd, device, lead=lead),
        "w_out": layers.dense_init(gen, (E, Fd, D), pd, device,
                                   scale=1.0 / math.sqrt(Fd), lead=lead),
    }
    if cfg.num_shared_experts > 0:
        sf = cfg.shared_d_ff or cfg.num_shared_experts * Fd
        p["shared"] = layers.init_ffn(gen, cfg, device, lead, d_ff=sf)
    return p


MOE_AXES = {
    "router": ("embed", None),
    "w_in": ("expert", "embed", "expert_mlp"),
    "w_gate": ("expert", "embed", "expert_mlp"),
    "w_out": ("expert", "expert_mlp", "embed"),
    "shared": layers.FFN_AXES,
}


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * num_tokens * cfg.capacity_factor
                      / cfg.num_experts))
    return max(c, 1)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt, cfg: ModelConfig, members: bool):
    """Router probabilities (f32) and each token's top-k (probability,
    expert), qwen's renormalised by name as in the reference."""
    logits = member_dot(xt, params["router"].to(xt.dtype), x_members=members,
                        w_members=members).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.top_k)
    if cfg.name.startswith("qwen2-moe"):
        top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True),
                                    min=1e-9)
    return probs, top_p, top_e


def _one_hot(idx, n: int):
    """(..., n) booleans, ``idx`` one-hot (a comparison: ``F.one_hot``
    reads the indices back to the host to check them)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _aux(probs, top_e, cfg: ModelConfig, token_dims):
    """Switch load-balance loss ``coef * E * sum_e f_e * P_e`` over the
    token axes (per member with a member axis)."""
    E = cfg.num_experts
    me = torch.mean(probs, dim=token_dims)
    fe = torch.mean(torch.sum(_one_hot(top_e, E).float(), dim=-2),
                    dim=token_dims)
    return cfg.router_aux_coef * E * torch.sum(fe * me, dim=-1)


class _MapGather(torch.autograd.Function):
    """``out[..., j, :] = src[..., idx[..., j], :]`` along axis -2, where
    index ``len(src)`` reads a zero row, and ``inv`` is ``idx``'s inverse
    (``inv[idx[j]] = j`` wherever ``idx[j]`` is a real row; the rest of
    ``inv`` points at the zero row): every row of src is read at most once,
    so the gradient is the gather of the output gradient through ``inv``,
    with no scatter-add."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _gather_rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _gather_rows(g, inv), None, None


def _gather_rows(src, idx):
    ext = torch.cat([src, src.new_zeros(src.shape[:-2] + (1, src.shape[-1]))],
                    dim=-2)
    return torch.gather(ext, -2, idx[..., None].expand(
        idx.shape + (src.shape[-1],)))


def _experts(params, buf, members: bool, g_ax=None):
    """SwiGLU experts over the capacity buffer (..., G, E, C, D). A plain
    batched product over (member,) expert: the reference keeps these on
    XLA's einsum, not ``member_dot``. Under the context's rules, on each
    device's shards (``models/sharded.experts``)."""
    if not members and sharding.current_rules() is not None:
        return sharded.experts(params, buf, g_ax,
                               lambda p, b: _experts(p, b, False))
    dt = buf.dtype
    pre = "bgecd,bedf->bgecf" if members else "gecd,edf->gecf"
    post = "bgecf,befd->bgecd" if members else "gecf,efd->gecd"
    h_in = torch.einsum(pre, buf, params["w_in"].to(dt))
    h_gate = torch.einsum(pre, buf, params["w_gate"].to(dt))
    h = F.silu(h_gate) * h_in
    return torch.einsum(post, h, params["w_out"].to(dt))


_PLAN_KEYS = ("expert", "pos", "keep", "w", "fwd", "inv")


def _plan(top_p, top_e, cfg: ModelConfig, C: int, g_ax):
    """``dispatch_plan``, group-local under rules."""
    if sharding.current_rules() is None:
        return dispatch_plan(top_p, top_e, cfg, C)
    outs = sharded.group_local(
        lambda p, e: tuple(dispatch_plan(p, e, cfg, C)[k]
                           for k in _PLAN_KEYS),
        (top_p, top_e), (2,) * len(_PLAN_KEYS), g_ax)
    return dict(zip(_PLAN_KEYS, outs))


def _groups(cfg: ModelConfig, T: int):
    """(G, Tg, C): the dispatch groups (one when they do not divide the T
    tokens), the tokens a group and its capacity."""
    G = max(cfg.dispatch_groups, 1)
    if T % G:
        G = 1
    return G, T // G, moe_capacity(cfg, T // G)


def dispatch_plan(top_p, top_e, cfg: ModelConfig, C: int) -> dict:
    """Each group's choices (token-major, (..., G, Tg * K)) with their
    expert, their position in that expert's queue (a cumulative sum over
    the group's choice list), whether it fits the capacity C, and its
    combine weight (0 when dropped); ``fwd`` maps a choice to its slot
    ``e * C + pos`` (``E * C`` when dropped) and ``inv`` a slot to its
    choice (``Tg * K`` when empty)."""
    E = cfg.num_experts
    lead = top_e.shape[:-1]
    TK = lead[-1] * top_e.shape[-1]
    choice_e = top_e.reshape(lead[:-1] + (TK,))
    choice_p = top_p.reshape(lead[:-1] + (TK,))
    pos = torch.cumsum(_one_hot(choice_e, E).long(), dim=-2) - 1
    pos_in_e = torch.gather(pos, -1, choice_e[..., None])[..., 0]
    keep = pos_in_e < C
    w = torch.where(keep, choice_p, torch.zeros_like(choice_p)).float()
    fwd = torch.where(keep, choice_e * C + pos_in_e,
                      torch.full_like(choice_e, E * C))
    # only dropped choices share an index, the sentinel column, cut off
    inv = torch.full(lead[:-1] + (E * C + 1,), TK, dtype=torch.long,
                     device=top_e.device)
    inv.scatter_(-1, fwd, torch.arange(TK, device=top_e.device)
                 .expand_as(fwd))
    return {"expert": choice_e, "pos": pos_in_e, "keep": keep, "w": w,
            "fwd": fwd, "inv": inv[..., :E * C]}


def moe_forward(params, x, cfg: ModelConfig, members: bool = False):
    """x: (..., S, D) ((B, n, S, D) with ``members``) -> (y, aux); aux a
    scalar ((B,) per member)."""
    lead = x.shape[:1] if members else ()
    D = x.shape[-1]
    E, K = cfg.num_experts, cfg.top_k
    G, Tg, C = _groups(cfg, math.prod(x.shape[len(lead):-1]))
    g_ax = "batch" if G > 1 else None   # never shard a size-1 group axis
    tok_ax = (g_ax, "tokens" if G == 1 else None, "embed_act")
    rules = sharding.current_rules()
    if rules is not None and G > 1:
        fitted = sharded.fit_groups(rules, G, x.device_mesh)
        if fitted is not rules:     # back to the caller's batch layout
            with sharding.logical_rules(fitted):
                y, aux = moe_forward(params, x, cfg, members)
            return constrain(y, ("batch", None, "embed_act")), aux
        x = constrain(x, ("batch", None, "embed_act"))
    xt = constrain(x.reshape(lead + (G, Tg, D)), tok_ax)
    probs, top_p, top_e = _route(params, xt, cfg, members)    # (.., G, Tg, K)
    aux = _aux(probs, top_e, cfg, (-3, -2))
    plan = _plan(top_p, top_e, cfg, C, g_ax)
    fwd, inv = plan["fwd"], plan["inv"]
    # each choice's row, token-major
    xk = xt[..., None, :].expand(lead + (G, Tg, K, D)).reshape(
        lead + (G, Tg * K, D))
    # the buffers' (expert, slot) axes fold into one row axis for the maps;
    # under rules each device does so on its own groups
    if rules is None:
        buf = _MapGather.apply(xk, inv, fwd).reshape(lead + (G, E, C, D))
    else:
        buf = sharded.group_local(lambda a, i, j: _MapGather.apply(
            a, i, j).reshape(-1, E, C, D), (xk, inv, fwd), 4, g_ax)
    buf = constrain(buf, (g_ax, "expert", "expert_capacity", "embed_act"))
    out_buf = constrain(_experts(params, buf, members, g_ax),
                        (g_ax, "expert", "expert_capacity", "embed_act"))
    if rules is None:
        gathered = _MapGather.apply(out_buf.reshape(lead + (G, E * C, D)),
                                    fwd, inv)
    else:
        gathered = sharded.group_local(lambda a, i, j: _MapGather.apply(
            a.reshape(-1, E * C, D), i, j), (out_buf, fwd, inv), 3, g_ax)
    gathered = gathered.float() * plan["w"][..., None]
    y = torch.sum(gathered.reshape(lead + (G, Tg, K, D)), dim=-2).to(x.dtype)
    if "shared" in params:
        y = y + layers.ffn_forward(params["shared"], x, cfg, members).reshape(
            y.shape)
    return constrain(y, tok_ax).reshape(x.shape), aux


def moe_forward_dense(params, x, cfg: ModelConfig, members: bool = False):
    """The dropless oracle: every expert sees every token (E times the
    dispatch's expert FLOPs; for tests and tiny configs)."""
    lead = x.shape[:1] if members else ()
    D = x.shape[-1]
    xt = x.reshape(lead + (-1, D))
    probs, top_p, top_e = _route(params, xt, cfg, members)
    gate = torch.zeros_like(probs).scatter(-1, top_e, top_p)
    dt = x.dtype
    b = "b" if members else ""
    h_in = torch.einsum(f"{b}td,{b}edf->{b}etf", xt, params["w_in"].to(dt))
    h_gate = torch.einsum(f"{b}td,{b}edf->{b}etf", xt,
                          params["w_gate"].to(dt))
    h = F.silu(h_gate) * h_in
    out = torch.einsum(f"{b}etf,{b}efd->{b}etd", h, params["w_out"].to(dt))
    y = torch.einsum(f"{b}etd,{b}te->{b}td", out.float(), gate).to(dt)
    aux = _aux(probs, top_e, cfg, (-2,))
    if "shared" in params:
        y = y + layers.ffn_forward(params["shared"], x, cfg, members).reshape(
            y.shape)
    return y.reshape(x.shape), aux
