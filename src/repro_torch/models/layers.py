"""Shared LM layers: norms (rmsnorm, and layernorm for the audio encoder),
RoPE, GQA attention with its KV cache, FFNs, embeddings. The port of the
reference's ``repro.models.layers`` for the LMs' training, prefill and
decode.

Every layer is a pair ``init_*(gen, cfg, ...) -> params`` and
``apply(params, x, ...) -> y`` over plain dicts of tensors, with the
reference's layouts: ``wq (D, H, hd)``, ``wk``/``wv (D, Hkv, hd)``,
``wo (H, hd, D)``, ``(in, out)`` FFN weights, vocab tables padded to
``cfg.vocab_padded``. Full-sequence attention (training, evaluation,
prefill) goes through the ``flash_attention`` kernel, which computes the
reference's ``chunked_attention`` at query offset 0 within
``cfg.sliding_window``, and its backward kernel when autograd needs the
gradient; given a cache, ``attention_forward`` also fills it, where the
reference has a separate ``attention_fill_cache``. With a window the cache
is a ring of ``min(window, max_len)`` slots: prefill leaves the prompt's
trailing window there, and decode writes token ``pos`` to slot ``pos %
C``. With ``members=True`` (the cohort engine's wave) the parameters carry
a leading member axis B and so does x, ``(B, n, S, D)``: the products go
through ``member_dot(..., x_members=True, w_members=True)`` and attention,
which has no parameters, takes the members' rows folded into its batch
axis. Decode attention is plain torch in f32, as the reference computes it
in jnp outside any kernel. The reference's ``rules`` argument is a context
(``common.sharding.logical_rules``): its ``with_logical_constraint`` sites
call ``sharding.constrain``, which returns the tensor itself without
rules; under rules the attention kernel, decode attention, the cache
writes and the token lookup run on each device's shards
(``models/sharded.py``). The ``*_AXES`` tables are the reference's
logical axes of each layer's parameters and caches.

Initial weights come from a ``torch.Generator``: the reference's law
(truncated normal at +-2 std, fan-in scale), not its threefry draws
(convert the reference's tree for parity).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.sharding import constrain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.member_math import member_dot

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               scale: Optional[float] = None, lead=()) -> torch.Tensor:
    """Truncated-normal (+-2 std) fan-in init of one ``shape`` leaf, drawn
    in f32 on ``gen``'s device and cast to ``dtype`` on ``device``. ``lead``
    prepends stacked axes (the superblock axis) that share the leaf's scale.
    On the ``meta`` device nothing is drawn (``gen`` may be None)."""
    full = tuple(lead) + tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(full, dtype=dtype, device="meta")
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    t = torch.empty(full, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device, lead=()) -> dict:
    shape = tuple(lead) + (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """f32 layernorm with the population variance (``jnp.var``, so
    ``correction=0``), cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs 0::2 / 1::2)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention: prefill through the flash kernel, decode against the cache
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device, lead=()) -> dict:
    pd = param_dtype_of(cfg)
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (D, H, hd), pd, device, lead=lead),
        "wk": dense_init(gen, (D, Hkv, hd), pd, device, lead=lead),
        "wv": dense_init(gen, (D, Hkv, hd), pd, device, lead=lead),
        "wo": dense_init(gen, (H, hd, D), pd, device,
                         scale=1.0 / math.sqrt(H * hd), lead=lead),
    }


ATTN_AXES = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
}

# decode KV caches shard over their own sequence axis when the kv heads
# cannot (launch.mesh.rules_for)
ATTN_CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
}


def _dot(members: bool):
    """member_dot with both operands member-batched, or neither."""
    return functools.partial(member_dot, x_members=members,
                             w_members=members)


def attention_forward(params, x, cfg: ModelConfig, positions=None,
                      cache=None, members: bool = False):
    """Full-sequence attention over x (B, S, D) through the flash kernel,
    within ``cfg.sliding_window``; with ``members``, over x (B, n, S, D)
    with (B, ...) parameters. With ``cache`` (prefill) of C slots, the
    roped k and v are also written into it in place, as the reference's
    ``attention_fill_cache`` lays them out: when C >= S token ``i`` goes to
    slot ``i`` and the tail slots stay zero until decode; when C < S (a
    sliding-window ring) the last C tokens go to ring slots
    ``(S - C + i) % C``, where decode expects them."""
    S = x.shape[-2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    dot = _dot(members)
    q = dot(x, params["wq"].to(x.dtype))
    k = dot(x, params["wk"].to(x.dtype))
    v = dot(x, params["wv"].to(x.dtype))
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        C = cache["k"].shape[1]
        if C >= S and sharding.current_rules() is not None:
            sharded.write(cache["k"], 0, k)
            sharded.write(cache["v"], 0, v)
        elif C >= S:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        else:       # the trailing window, token S - C + i at its ring slot
            shift = (S - C) % C
            cache["k"][:] = torch.roll(k[:, S - C:], shift, dims=1)
            cache["v"][:] = torch.roll(v[:, S - C:], shift, dims=1)
    window = cfg.sliding_window
    if members:     # the members' rows side by side on the kernel's batch
        lead = q.shape[:2]
        out = flash_attention(q.flatten(0, 1), k.flatten(0, 1),
                              v.flatten(0, 1), causal=cfg.causal,
                              window=window)
        out = out.unflatten(0, lead)
    elif sharding.current_rules() is None:
        out = flash_attention(q, k, v, causal=cfg.causal, window=window)
    else:
        out = sharded.flash(q, k, v, cfg.causal, window)
    out = constrain(out, ("batch", "seq", "heads", "head_dim"))
    y = dot(out, params["wo"].to(x.dtype), ncon=2)
    return constrain(y, ("batch", "seq", "embed_act"))


def attention_cache_size(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         device, lead=()) -> dict:
    C = attention_cache_size(cfg, max_len)
    shape = tuple(lead) + (batch, C, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(q, k_cache, v_cache, valid: int):
    """One query token against a (ring-buffer) KV cache, f32 math.
    q (B, 1, H, hd); caches (B, C, Hkv, hd); the first ``valid`` slots are
    real tokens (softmax is permutation-invariant, so slot order does not
    matter)."""
    if sharding.current_rules() is not None:
        return sharded.decode_attention(q, k_cache, v_cache, valid,
                                        ATTN_CACHE_AXES["k"])
    B, C, Hkv, hd = k_cache.shape
    H = q.shape[2]
    qr = q.reshape(B, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) / math.sqrt(hd)
    live = torch.arange(C, device=q.device) < valid
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_decode(params, cache, x, pos: int, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D); ``pos`` the token's position (a host
    int, the same for the batch). Writes k and v into ring slot
    ``pos % C`` of ``cache`` in place (the reference returns an updated
    copy) and attends over the ``min(pos + 1, C)`` slots written so far:
    with a window of C, the tokens ``pos - C + 1 .. pos``. Returns (cache,
    y)."""
    C = cache["k"].shape[1]
    posb = torch.full((x.shape[0], 1), pos, device=x.device)
    q = member_dot(x, params["wq"].to(x.dtype))
    k = member_dot(x, params["wk"].to(x.dtype))
    v = member_dot(x, params["wv"].to(x.dtype))
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % C
    if sharding.current_rules() is None:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
    else:
        sharded.write(cache["k"], slot, k)
        sharded.write(cache["v"], slot, v)
    out = decode_attention(q, cache["k"], cache["v"], min(pos + 1, C))
    return cache, member_dot(out, params["wo"].to(x.dtype), ncon=2)


# ---------------------------------------------------------------------------
# Dense feed-forward (SwiGLU / GELU / ReLU / squared ReLU)
# ---------------------------------------------------------------------------

def init_ffn(gen, cfg: ModelConfig, device, lead=(),
             d_ff: Optional[int] = None) -> dict:
    """The dense FFN; ``d_ff`` overrides ``cfg.d_ff`` (the MoE's shared
    experts)."""
    pd = param_dtype_of(cfg)
    D, Fd = cfg.d_model, (d_ff if d_ff is not None else cfg.d_ff)
    p = {"w_in": dense_init(gen, (D, Fd), pd, device, lead=lead),
         "w_out": dense_init(gen, (Fd, D), pd, device, lead=lead)}
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = dense_init(gen, (D, Fd), pd, device, lead=lead)
    return p


def ffn_forward(params, x, cfg: ModelConfig, members: bool = False):
    dot = _dot(members)
    h = dot(x, params["w_in"].to(x.dtype))
    if cfg.ffn_act == "swiglu":
        h = F.silu(dot(x, params["w_gate"].to(x.dtype))) * h
    elif cfg.ffn_act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    elif cfg.ffn_act == "relu2":            # squared ReLU
        h = torch.square(torch.relu(h))
    else:
        h = torch.relu(h)
    h = constrain(h, ("batch", "seq", "mlp"))
    y = dot(h, params["w_out"].to(x.dtype))
    return constrain(y, ("batch", "seq", "embed_act"))


FFN_AXES = {
    "w_in": ("embed", "mlp"),
    "w_out": ("mlp", "embed"),
    "w_gate": ("embed", "mlp"),
}


# ---------------------------------------------------------------------------
# Embedding / unembedding (tables padded to cfg.vocab_padded)
# ---------------------------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, device) -> dict:
    """Pad rows (columns of ``unembed``) stay zero: never indexed, and their
    logits are masked (``mask_vocab_pad``). With ``tie_embeddings`` there is
    no ``unembed``: the logits read ``tok``'s transpose."""
    pd = param_dtype_of(cfg)
    V, Vp, D = cfg.vocab_size, cfg.vocab_padded, cfg.d_model
    p = {"tok": F.pad(dense_init(gen, (V, D), pd, device, scale=1.0),
                      (0, 0, 0, Vp - V))}
    if not cfg.tie_embeddings:
        p["unembed"] = F.pad(dense_init(gen, (D, V), pd, device),
                             (0, Vp - V))
    return p


# The lookup table keeps its vocab dim replicated ("vocab_lookup"); the
# unembedding stays vocab-sharded.
EMBED_AXES = {"tok": ("vocab_lookup", "embed"), "unembed": ("embed", "vocab")}


def mask_vocab_pad(logits, cfg: ModelConfig):
    """-1e30 in the padded vocab columns."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < cfg.vocab_size, logits,
                       torch.full((), NEG_INF, dtype=logits.dtype,
                                  device=logits.device))


def embed_tokens(params, tokens, cfg: ModelConfig, members: bool = False):
    """Rows of the table cast to the compute dtype (cast, then gathered, as
    the reference: the gradient adds repeated tokens in that dtype); with
    ``members``, member b's tokens (B, ...) index its own table (B, Vp, D)."""
    tok = params["tok"].to(dtype_of(cfg))
    if members:
        rows = torch.arange(tok.shape[0], device=tokens.device)
        return tok[rows.view((-1,) + (1,) * (tokens.dim() - 1)), tokens]
    if sharding.current_rules() is None:
        return tok[tokens]
    return constrain(sharded.lookup(tok, tokens),
                     ("batch", "seq", "embed_act"))


def unembed_weight(params):
    """The (D, Vp) unembedding ((B, D, Vp) for member-batched tables):
    ``unembed``, or ``tok``'s transpose when the embeddings are tied."""
    if "unembed" in params:
        return params["unembed"]
    return params["tok"].transpose(-1, -2)


def unembed(params, x, cfg: ModelConfig):
    logits = member_dot(x, unembed_weight(params).to(x.dtype))
    return constrain(mask_vocab_pad(logits, cfg), ("batch", "seq", "vocab"))
