"""Recurrent sequence mixers: Mamba (S6), mLSTM and sLSTM (xLSTM).

The port of the reference's ``repro.models.ssm``. Each mixer keeps its
contract:

    init_<kind>(gen, cfg, device, lead=())        -> params
    <kind>_forward(params, x, cfg, members)       -> y          (train/prefill)
    init_<kind>_state(cfg, batch, device, lead=()) -> state     (decode cache)
    <kind>_decode(params, state, x, cfg, members) -> (state, y) (one token)
    <kind>_fill_state(params, x, cfg, members)    -> (state, y) (prefill+cache)

with the reference's layouts (``(in, out)`` projections, ``(E, N)``
``a_log``, ``(D, 4, H, hd)`` sLSTM input weights) and its float32 states.
Where the reference runs ``lax.scan`` over time, the port runs an eager
loop over the time steps with the same carry and the same per-step
arithmetic; the products that do not read the carry (the projections, and
mamba's gates and mLSTM's log forget gate) are taken for the whole sequence
before the loop. On the card every op of a step is a launch, so a prefill
costs launches in proportion to its length (PERF.md §7).

With ``members=True`` (the cohort engine's wave) every parameter carries a
leading member axis B and so does x, ``(B, n, S, D)``: the reference's
``member_dot`` sites go through ``member_dot(..., x_members=True,
w_members=True)`` (the grouped kernel under ``"grouped"``), and its plain
einsums become batched torch products over the member axis.

Under the context's rules (``common.sharding.logical_rules``) the
reference's constraint sites lay the projections out. Under the op
counter on meta tensors (the dry run), a time loop is counted from two
steps (``launch/op_cost.fold``, ``_time_loop``); every other run takes the
loop as it is. The ``*_AXES`` tables are the reference's logical
axes of each mixer's parameters and states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.sharding import constrain
from repro_torch.launch import op_cost
from repro_torch.models import sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of, param_dtype_of
from repro_torch.models.member_math import member_dot

NEG_INIT = -1e30    # the stabiliser state's start, float32 as the reference


def _dot(x, w, members: bool, ncon: int = 1):
    return member_dot(x, w, ncon, x_members=members, w_members=members)


def _bc(p: torch.Tensor, like: torch.Tensor, members: bool) -> torch.Tensor:
    """A parameter broadcast against an activation: with ``members`` the
    member axis of ``p`` lines up with ``like``'s first axis and its other
    axes with ``like``'s last ones."""
    if not members:
        return p
    return p.reshape(p.shape[:1] + (1,) * (like.dim() - p.dim()) + p.shape[1:])


def _time_loop(step, carry, per_step, S: int, dim: int):
    """``carry, out = step(carry, per_step(t))`` for t = 0 .. S-1 -> (the
    last carry, the outs stacked along ``dim``); under the op counter on
    meta tensors, counted from two steps (``op_cost.fold``)."""
    if op_cost.folding(carry):
        return op_cost.fold(step, carry, per_step, S, dim)
    outs = []
    for t in range(S):
        carry, out = step(carry, per_step(t))
        outs.append(out)
    return carry, torch.stack(outs, dim=dim)


def _log_sigmoid(x):
    """``-softplus(-x)``, the reference's form of log sigmoid."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# Mamba (S6) — selective state-space model
# ---------------------------------------------------------------------------

def init_mamba(gen, cfg: ModelConfig, device, lead=()) -> dict:
    pd = param_dtype_of(cfg)
    D, E, N, K = cfg.d_model, cfg.ssm_inner, cfg.ssm_state_dim, cfg.conv_kernel
    R = cfg.dt_rank_actual
    lead = tuple(lead)
    meta = torch.device(device).type == "meta"
    # S4D-real initialization for A
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                      ).expand(lead + (E, N)).to(device)
    if meta:
        dt_b = torch.empty(lead + (E,), dtype=pd, device="meta")
    else:
        # softplus^-1 of dt, log-uniform in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(lead + (E,), generator=gen, device=gen.device)
        dt_b = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))
                         ).to(device=device, dtype=pd)
    return {
        "in_proj": dense_init(gen, (D, 2 * E), pd, device, lead=lead),
        "conv_w": dense_init(gen, (K, E), pd, device,
                             scale=1.0 / math.sqrt(K), lead=lead),
        "conv_b": torch.zeros(lead + (E,), dtype=pd, device=device),
        "x_proj": dense_init(gen, (E, R + 2 * N), pd, device, lead=lead),
        "dt_proj_w": dense_init(gen, (R, E), pd, device, scale=R ** -0.5,
                                lead=lead),
        "dt_proj_b": dt_b,
        "a_log": a_log.contiguous(),
        "d_skip": torch.ones(lead + (E,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (E, D), pd, device, lead=lead),
    }


MAMBA_AXES = {
    "in_proj": ("embed", "ssm_inner"),
    "conv_w": ("conv_kernel", "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "x_proj": ("ssm_inner", None),
    "dt_proj_w": (None, "ssm_inner"),
    "dt_proj_b": ("ssm_inner",),
    "a_log": ("ssm_inner", "ssm_state"),
    "d_skip": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed"),
}

MAMBA_STATE_AXES = {
    "h": ("batch", "ssm_inner", "ssm_state"),
    "conv": ("batch", None, "ssm_inner"),
}


def _mm(x: torch.Tensor, w: torch.Tensor, members: bool) -> torch.Tensor:
    """x (..., in) @ w (in, out), a plain torch product where the reference
    has a plain einsum; with ``members``, x (B, ..., in) and w (B, in,
    out), one batched product over the member axis."""
    if not members and sharding.current_rules() is not None:
        return member_dot(x, w)         # laid out on the shards
    if not members:
        return torch.matmul(x, w)
    out = torch.matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + w.shape[-1:])


def _mamba_gates(params, xc, cfg: ModelConfig, members: bool):
    """xc: (..., E) post-conv activations (any number of steps) -> (dt,
    Bmat, Cmat), f32."""
    N, R = cfg.ssm_state_dim, cfg.dt_rank_actual
    proj = _mm(xc, params["x_proj"].to(xc.dtype), members)
    dt_r, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = F.softplus(
        _mm(dt_r, params["dt_proj_w"].to(xc.dtype), members).float()
        + _bc(params["dt_proj_b"].float(), dt_r, members))
    return dt, Bm.float(), Cm.float()


def _mamba_step(h, xc, gates, A, d_skip):
    """h: (..., E, N) f32 state; xc: (..., E) conv-activated input of one
    step; gates its (dt, Bm, Cm); A = -exp(a_log) and d_skip broadcast
    against h and xc."""
    dt, Bm, Cm = gates
    dA = torch.exp(dt[..., None] * A)                           # (..., E, N)
    dBx = dt[..., None] * Bm[..., None, :] * xc.float()[..., None]
    h = h * dA + dBx
    y = torch.matmul(h, Cm[..., :, None])[..., 0] + d_skip * xc.float()
    return h, y


def _mamba_consts(params, h, xc, members: bool):
    """(A, d_skip) broadcast against the state h and the input xc."""
    return (_bc(-torch.exp(params["a_log"]), h, members),
            _bc(params["d_skip"], xc, members))


def _mamba_scan(params, x, cfg: ModelConfig, members: bool):
    S = x.shape[-2]
    E, N, K = cfg.ssm_inner, cfg.ssm_state_dim, cfg.conv_kernel
    xz = _dot(x, params["in_proj"].to(x.dtype), members)
    xz = constrain(xz, ("batch", "seq", "ssm_inner"))
    xi, z = torch.split(xz, E, dim=-1)
    # depthwise causal conv over time: K shifted products, in the order
    # i = 0 .. K-1
    if sharding.current_rules() is None:
        xpad = F.pad(xi, (0, 0, K - 1, 0))
    else:       # DTensor's pad is missing or broken on some versions
        xpad = torch.cat([xi.new_zeros(xi.shape[:-2] + (K - 1, E)), xi],
                         dim=-2)
    conv_w = params["conv_w"].to(x.dtype)
    conv = 0
    for i in range(K):
        conv = conv + xpad[..., i:i + S, :] * _bc(conv_w[..., i, :], xi,
                                                   members)
    conv = conv + _bc(params["conv_b"].to(x.dtype), xi, members)
    xc = F.silu(conv)                                           # (..., S, E)
    dt, Bm, Cm = _mamba_gates(params, xc, cfg, members)
    h = torch.zeros(x.shape[:-2] + (E, N), dtype=torch.float32,
                    device=x.device)
    A, d_skip = _mamba_consts(params, h, xc[..., 0, :], members)
    xc, dt, Bm, Cm = sharded.settled(xc, dt, Bm, Cm)
    h, y = _time_loop(
        lambda h_, g: _mamba_step(h_, g[0], g[1:], A, d_skip), h,
        lambda t: (xc[..., t, :], dt[..., t, :], Bm[..., t, :],
                   Cm[..., t, :]), S, -2)
    y = y.to(x.dtype) * F.silu(z)
    out = constrain(_dot(y, params["out_proj"].to(x.dtype), members),
                    ("batch", "seq", "embed_act"))
    # final conv state = the last K-1 raw (pre-conv) inner activations
    return {"h": h, "conv": xpad[..., S:, :]}, out


def mamba_forward(params, x, cfg: ModelConfig, members: bool = False):
    return _mamba_scan(params, x, cfg, members)[1]


def mamba_fill_state(params, x, cfg: ModelConfig, members: bool = False):
    return _mamba_scan(params, x, cfg, members)


def init_mamba_state(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    E, N, K = cfg.ssm_inner, cfg.ssm_state_dim, cfg.conv_kernel
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, E, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, K - 1, E), dtype=dtype_of(cfg),
                                device=device)}


def mamba_decode(params, state, x, cfg: ModelConfig, members: bool = False):
    """x: (..., 1, D) -> (new state, y (..., 1, D))."""
    E = cfg.ssm_inner
    xz = _dot(x, params["in_proj"].to(x.dtype), members)[..., 0, :]
    xi, z = torch.split(xz, E, dim=-1)                          # (..., E)
    hist = torch.cat([state["conv"], xi[..., None, :]], dim=-2)  # (..., K, E)
    conv = torch.sum(hist * _bc(params["conv_w"].to(x.dtype), hist, members),
                     dim=-2) + _bc(params["conv_b"].to(x.dtype), xi, members)
    xc = F.silu(conv)
    gates = _mamba_gates(params, xc[..., None, :], cfg, members)
    h, y = _mamba_step(state["h"], xc, tuple(g[..., 0, :] for g in gates),
                       *_mamba_consts(params, state["h"], xc, members))
    y = y.to(x.dtype) * F.silu(z)
    out = _dot(y[..., None, :], params["out_proj"].to(x.dtype), members)
    return {"h": h, "conv": hist[..., 1:, :]}, out


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    H = cfg.num_heads
    return inner, H, inner // H


MLSTM_AXES = {
    "up_proj": ("embed", "ssm_inner"),
    "wq": ("ssm_inner", "heads", "head_dim"),
    "wk": ("ssm_inner", "heads", "head_dim"),
    "wv": ("ssm_inner", "heads", "head_dim"),
    "w_if": ("ssm_inner", "heads"),
    "b_if": ("heads",),
    "gn_scale": ("heads", "head_dim"),
    "down_proj": ("ssm_inner", "embed"),
}

MLSTM_STATE_AXES = {
    "C": ("batch", "heads", "head_dim", None),
    "n": ("batch", "heads", "head_dim"),
    "m": ("batch", "heads"),
}


def init_mlstm(gen, cfg: ModelConfig, device, lead=()) -> dict:
    pd = param_dtype_of(cfg)
    D = cfg.d_model
    inner, H, hd = _mlstm_dims(cfg)
    lead = tuple(lead)
    # forget-gate bias init high (keep memory)
    b_if = torch.cat([torch.zeros(H), torch.full((H,), 3.0)])
    return {
        "up_proj": dense_init(gen, (D, 2 * inner), pd, device, lead=lead),
        "wq": dense_init(gen, (inner, H, hd), pd, device, lead=lead),
        "wk": dense_init(gen, (inner, H, hd), pd, device, lead=lead),
        "wv": dense_init(gen, (inner, H, hd), pd, device, lead=lead),
        "w_if": dense_init(gen, (inner, 2 * H), pd, device, scale=0.02,
                           lead=lead),
        "b_if": b_if.expand(lead + (2 * H,)).to(device=device, dtype=pd)
        .contiguous(),
        "gn_scale": torch.ones(lead + (H, hd), dtype=pd, device=device),
        "down_proj": dense_init(gen, (inner, D), pd, device, lead=lead),
    }


def _mlstm_step(state, qkvif, eps: float = 1e-6):
    """One mLSTM cell step with exponential-gate stabilization.

    state: C (..., H, hd, hd), n (..., H, hd), m (..., H); qkvif: q, k, v
    (..., H, hd), i_pre and log_f (..., H) (log_f = log sigmoid(f_pre),
    taken before the loop)."""
    C, n, m = state
    q, k, v, i_pre, log_f = qkvif
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    C = f_g[..., None, None] * C \
        + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    nq = torch.matmul(n[..., None, :], q[..., :, None])[..., 0, 0]
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new)) + eps
    h = torch.matmul(C, q[..., :, None])[..., 0] / denom[..., None]
    return (C, n, m_new), h


def _mlstm_qkvif(params, xs, cfg: ModelConfig, members: bool):
    """xs: (..., S, inner) -> q, k, v (..., S, H, hd), i_pre and log_f
    (..., S, H), all f32."""
    inner, H, hd = _mlstm_dims(cfg)
    scale = hd ** -0.5
    q = _dot(xs, params["wq"].to(xs.dtype), members).float()
    k = _dot(xs, params["wk"].to(xs.dtype), members).float() * scale
    v = _dot(xs, params["wv"].to(xs.dtype), members).float()
    gates = _dot(xs, params["w_if"].to(xs.dtype), members).float()
    gates = gates + _bc(params["b_if"].float(), gates, members)
    i_pre, f_pre = torch.split(gates, H, dim=-1)
    return q, k, v, i_pre, _log_sigmoid(f_pre)


def _groupnorm(params, h, members: bool, eps: float = 1e-5):
    """Per-head RMS norm of the cell output. h: (..., H, hd)."""
    var = torch.mean(torch.square(h), dim=-1, keepdim=True)
    return h * torch.rsqrt(var + eps) \
        * _bc(params["gn_scale"].to(h.dtype), h, members)


def _mlstm_scan(params, x, cfg: ModelConfig, members: bool):
    S = x.shape[-2]
    lead = x.shape[:-2]
    inner, H, hd = _mlstm_dims(cfg)
    up = _dot(x, params["up_proj"].to(x.dtype), members)
    up = constrain(up, ("batch", "seq", "ssm_inner"))
    xs, z = torch.split(up, inner, dim=-1)
    q, k, v, i_pre, log_f = sharded.settled(
        *_mlstm_qkvif(params, xs, cfg, members))
    state = (torch.zeros(lead + (H, hd, hd), dtype=torch.float32,
                         device=x.device),
             torch.zeros(lead + (H, hd), dtype=torch.float32, device=x.device),
             torch.full(lead + (H,), NEG_INIT, dtype=torch.float32,
                        device=x.device))
    state, h = _time_loop(                                 # (..., S, H, hd)
        _mlstm_step, state,
        lambda t: (q[..., t, :, :], k[..., t, :, :], v[..., t, :, :],
                   i_pre[..., t, :], log_f[..., t, :]), S, -3)
    h = sharded.merge_ready(_groupnorm(params, h, members), -2)
    h = h.reshape(lead + (S, inner)).to(x.dtype)
    y = h * F.silu(z)
    out = constrain(_dot(y, params["down_proj"].to(x.dtype), members),
                    ("batch", "seq", "embed_act"))
    return {"C": state[0], "n": state[1], "m": state[2]}, out


def mlstm_forward(params, x, cfg: ModelConfig, members: bool = False):
    return _mlstm_scan(params, x, cfg, members)[1]


def mlstm_fill_state(params, x, cfg: ModelConfig, members: bool = False):
    return _mlstm_scan(params, x, cfg, members)


def init_mlstm_state(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    inner, H, hd = _mlstm_dims(cfg)
    lead = tuple(lead) + (batch,)
    return {"C": torch.zeros(lead + (H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros(lead + (H, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full(lead + (H,), NEG_INIT, dtype=torch.float32,
                            device=device)}


def mlstm_decode(params, state, x, cfg: ModelConfig, members: bool = False):
    """x: (..., 1, D) -> (new state, y (..., 1, D))."""
    lead = x.shape[:-2]
    inner, H, hd = _mlstm_dims(cfg)
    up = _dot(x, params["up_proj"].to(x.dtype), members)
    xs, z = torch.split(up, inner, dim=-1)
    q, k, v, i_pre, log_f = _mlstm_qkvif(params, xs, cfg, members)
    st, h = _mlstm_step((state["C"], state["n"], state["m"]),
                        (q[..., 0, :, :], k[..., 0, :, :], v[..., 0, :, :],
                         i_pre[..., 0, :], log_f[..., 0, :]))
    h = sharded.merge_ready(_groupnorm(params, h, members), -2)
    h = h.reshape(lead + (1, inner)).to(x.dtype)
    y = h * F.silu(z)
    out = _dot(y, params["down_proj"].to(x.dtype), members)
    return {"C": st[0], "n": st[1], "m": st[2]}, out


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell with exponential gating)
# ---------------------------------------------------------------------------

SLSTM_AXES = {
    "w_x": ("embed", None, "heads", "head_dim"),
    # the second head_dim stays unsharded: a spec names a mesh axis once
    "w_h": (None, "heads", "head_dim", None),
    "bias": (None, "heads", "head_dim"),
    "gn_scale": ("heads", "head_dim"),
    "ffn_in": ("embed", "mlp"),
    "ffn_out": ("mlp", "embed"),
}

SLSTM_STATE_AXES = {
    "c": ("batch", "heads", "head_dim"),
    "n": ("batch", "heads", "head_dim"),
    "m": ("batch", "heads", "head_dim"),
    "h": ("batch", "heads", "head_dim"),
}


def init_slstm(gen, cfg: ModelConfig, device, lead=()) -> dict:
    pd = param_dtype_of(cfg)
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    Fd = cfg.slstm_ffn_dim
    lead = tuple(lead)
    return {
        # input projections for the z, i, f, o gates
        "w_x": dense_init(gen, (D, 4, H, hd), pd, device, lead=lead),
        # block-diagonal (per-head) recurrent projections
        "w_h": dense_init(gen, (4, H, hd, hd), pd, device, scale=hd ** -0.5,
                          lead=lead),
        "bias": torch.zeros(lead + (4, H, hd), dtype=pd, device=device),
        "gn_scale": torch.ones(lead + (H, hd), dtype=pd, device=device),
        # post-cell gated FFN (factor 4/3)
        "ffn_in": dense_init(gen, (D, 2 * Fd), pd, device, lead=lead),
        "ffn_out": dense_init(gen, (Fd, D), pd, device, lead=lead),
    }


def _slstm_step(params, state, x_t, members: bool):
    """state: c, n, m, h each (..., H, hd); x_t: (..., 4, H, hd)
    pre-projected."""
    c, n, m, h_prev = state
    w_h = params["w_h"].float()
    eq = "bnhd,bghde->bnghe" if members else "...hd,ghde->...ghe"
    if members and h_prev.dim() != 4:
        raise ValueError(f"sLSTM member state must be (B, n, H, hd), got "
                         f"{tuple(h_prev.shape)}")
    rec = torch.einsum(eq, h_prev, w_h)
    pre = x_t.float() + rec + _bc(params["bias"].float(), x_t, members)
    z_pre, i_pre, f_pre, o_pre = torch.unbind(sharded.whole(pre, -3), dim=-3)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_out(params, h, x, cfg: ModelConfig, members: bool):
    """The normed cell output h (..., S, H, hd) through the gated FFN."""
    var = torch.mean(torch.square(h), dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + 1e-5) * _bc(params["gn_scale"].float(), h,
                                          members)
    y = sharded.merge_ready(h, -2)
    y = y.reshape(h.shape[:-2] + (cfg.d_model,)).to(x.dtype)
    ff = _dot(y, params["ffn_in"].to(x.dtype), members)
    a, g = torch.split(ff, cfg.slstm_ffn_dim, dim=-1)
    ff = a * torch.sigmoid(g)       # GeGLU-style gate
    return _dot(ff, params["ffn_out"].to(x.dtype), members)


def _slstm_apply(params, x, cfg: ModelConfig, members: bool):
    S = x.shape[-2]
    H = cfg.num_heads
    hd = cfg.d_model // H
    # (..., S, 4, H, hd)
    xp, = sharded.settled(_dot(x, params["w_x"].to(x.dtype), members))
    zeros = torch.zeros(x.shape[:-2] + (H, hd), dtype=torch.float32,
                        device=x.device)
    state = (zeros, zeros, torch.full_like(zeros, NEG_INIT), zeros)
    state, h = _time_loop(
        lambda st, x_t: _slstm_step(params, st, x_t, members), state,
        lambda t: xp[..., t, :, :, :], S, -3)
    return state, constrain(_slstm_out(params, h, x, cfg, members),
                            ("batch", "seq", "embed_act"))


def slstm_forward(params, x, cfg: ModelConfig, members: bool = False):
    return _slstm_apply(params, x, cfg, members)[1]


def slstm_fill_state(params, x, cfg: ModelConfig, members: bool = False):
    state, y = _slstm_apply(params, x, cfg, members)
    return {"c": state[0], "n": state[1], "m": state[2], "h": state[3]}, y


def init_slstm_state(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    H = cfg.num_heads
    shape = tuple(lead) + (batch, H, cfg.d_model // H)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.full(shape, NEG_INIT, dtype=torch.float32,
                            device=device),
            "h": torch.zeros(shape, dtype=torch.float32, device=device)}


def slstm_decode(params, state, x, cfg: ModelConfig, members: bool = False):
    """x: (..., 1, D) -> (new state, y (..., 1, D))."""
    st = (state["c"], state["n"], state["m"], state["h"])
    xp = _dot(x, params["w_x"].to(x.dtype), members)
    st, h = _slstm_step(params, st, xp[..., 0, :, :, :], members)
    y = _slstm_out(params, h[..., None, :, :], x, cfg, members)
    return {"c": st[0], "n": st[1], "m": st[2], "h": st[3]}, y
