"""The paper's models: CNN (MNIST / CIFAR) and linear / MLP (FMNIST).

Parameters keep the reference's layouts — HWIO conv kernels, ``(in, out)``
dense weights — so a tree converted from the reference
(``repro_torch.convert.params_from_numpy``) runs unchanged. The forward
permutes for torch's NCHW convolution and permutes back to NHWC before
flattening, because ``fc0.w`` was laid out against the reference's NHWC
flatten order.

The cohort engine trains a wave of B members at once through the
member-batched forwards (``members=True``): every parameter carries a
leading member axis, ``(B, *shape)``, and so does the data, ``(B, n,
...)``. The dense layers go through ``member_math.member_dot``, which
routes a member-batched product to the grouped kernel or to a plain
matmul; per-member convolutions are one grouped convolution
(``member_math.member_conv2d``, ``groups = B``) over the members' channels
side by side, ``(n, B*C, H, W)``, and a single model's is its one-group
case.

The token LMs (families ``dense``, ``moe``, ``ssm`` and ``hybrid``) keep
the reference's stacked-superblock layout: position ``p{i}`` of a
superblock has a sequence mixer (``attn | mamba | mlstm | slstm``, from
``models/layers.py`` and ``models/ssm.py``) and an FFN kind (``dense | moe
| moe+dense | none``, ``models/moe.py``), from the config's patterns; ``params["blocks"]["p{i}"]`` leaves carry a
leading ``num_superblocks`` axis, and a Python loop over superblocks
indexes them as views (no per-layer copies), where the reference scans;
``cfg.remat == "full"`` checkpoints each superblock
(``torch.utils.checkpoint``, recomputed in the backward) where the
reference wraps its scan body in ``jax.checkpoint``, and with
``cfg.scan_groups = G > 1`` (``num_superblocks % G == 0``) also each group
of ``num_superblocks / G`` superblocks around those: the reference's
two-level sqrt-remat, which saves G carries. ``cfg.remat == "dots"``
checkpoints the same regions selectively, under JAX's
``dots_with_no_batch_dims_saveable`` rule (``_dots_policy``): the outputs
of products without a batch axis are kept and the rest is recomputed.
Two layer loops share the parameters: the full-sequence one (``backbone_forward``: ``loss_fn``,
the next-token cross-entropy in sequence chunks of 1,024, plus the MoE
layers' Switch aux losses; ``forward_logits``, every position's logits;
``prefill``, which also fills the cache and returns the last position's)
and ``decode_step`` (one token against the cache). The cache is stacked
like the blocks: ``(nsb, B, C, Hkv, hd)`` KV caches beside the recurrent
layers' float32 states, each written in place. With ``members=True`` (the cohort
engine) every LM leaf carries the member axis before the superblock axis,
``(B, nsb, ...)``, and the tokens ``(B, n, S)``. A ``sliding_window``
reaches every attention layer: the flash kernels' band, and a ring KV cache
of ``min(window, max_len)`` slots.

The frontends share that stack (``embed_inputs``). Vision (family
``vlm``): a batch's ``patches`` (B, P, D) go through ``proj`` and sit in
front of the token embeddings, RoPE and the causal mask run over all P + S
positions, the loss gives the patch positions no label, and decode goes on
from position P + S. Audio (family ``audio``, ``causal=False``): frame
embeddings ``features`` (B, S, D) through ``in_proj``, layernorm in every
norm, bidirectional attention and per-frame logits through ``cls``
(``encode``); it is encoder-only, so ``init_cache``, ``prefill`` and
``decode_step`` raise. The member-batched path is for the families the
simulator registers, and the frontends are not among them.

The reference's ``rules`` argument is a context here
(``common.sharding.logical_rules``), read at its constraint sites
(``sharding.constrain``: the tensor itself without rules), and
``_checkpoint``'s recompute re-enters it. ``param_axes`` and
``cache_axes`` give the reference's logical axes of every parameter and
cache leaf, key for key with ``init_params`` and ``init_cache``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.common import sharding
from repro_torch.common.sharding import constrain
from repro_torch.common.tree import tree_map
from repro_torch.models import layers, member_math, moe, sharded, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.member_math import member_conv2d, member_dot


def _dense_init(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, the reference's
    ``layers.dense_init`` law. Values come from ``gen``: they are not the
    reference's threefry draws (convert the reference's tree for parity)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device)


def init_cnn(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> dict:
    H, W, C = cfg.input_hw
    params = {}
    in_c, h, w = C, H, W
    k = cfg.cnn_kernel
    for i, ch in enumerate(cfg.cnn_channels):
        params[f"conv{i}"] = {
            "w": _dense_init(gen, (k, k, in_c, ch), 1.0 / math.sqrt(k * k * in_c),
                             device),
            "b": torch.zeros((ch,), dtype=torch.float32, device=device),
        }
        in_c = ch
        h, w = h // 2, w // 2  # 2x2 maxpool each conv
    dims = (h * w * in_c,) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    for i in range(len(dims) - 1):
        params[f"fc{i}"] = {
            "w": _dense_init(gen, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), device),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
    return params


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> dict:
    dims = (cfg.input_hw[0],) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    return {
        f"fc{i}": {
            "w": _dense_init(gen, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), device),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
        for i in range(len(dims) - 1)
    }


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device="cpu") -> dict:
    """Initial weights from ``gen``. The LM draws on ``gen``'s device (a
    CUDA generator keeps a full-width init on the card) and needs no
    generator on the ``meta`` device."""
    if cfg.family == "cnn":
        return init_cnn(gen, cfg, device)
    if cfg.family == "mlp":
        return init_mlp(gen, cfg, device)
    check_lm(cfg)
    return init_lm(gen, cfg, device)


def _dense_stack(params, x, n: int, members: bool = False):
    for i in range(n):
        p = params[f"fc{i}"]
        if members:
            x = member_dot(x, p["w"], x_members=True, w_members=True) \
                + p["b"][:, None, :]
        else:
            x = member_dot(x, p["w"]) + p["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def cnn_forward(params, x, cfg: ModelConfig, members: bool = False):
    """x: (n, H, W, C) f32 -> logits (n, num_classes); with ``members``,
    params (B, *shape) and x (B, n, H, W, C) -> (B, n, num_classes).
    'SAME' convolution (odd kernel: padding k // 2), VALID 2x2 max-pool,
    NHWC flatten (per member)."""
    if members:
        return _cnn_forward_members(params, x, cfg)
    x = x.permute(0, 3, 1, 2)
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        x = member_conv2d(x, p["w"].permute(3, 2, 0, 1),
                          padding=cfg.cnn_kernel // 2)
        x = torch.relu(x + p["b"][:, None, None])
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _dense_stack(params, x, len(cfg.mlp_hidden) + 1)


def _cnn_forward_members(params, x, cfg: ModelConfig):
    B, n = x.shape[:2]
    # members' images side by side as channel groups: (n, B*C, H, W)
    x = x.permute(1, 0, 4, 2, 3).reshape(n, -1, x.shape[2], x.shape[3])
    k = cfg.cnn_kernel
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        _, _, _, c_in, c_out = p["w"].shape
        w = p["w"].permute(0, 4, 3, 1, 2).reshape(B * c_out, c_in, k, k)
        x = member_conv2d(x, w, groups=B, padding=k // 2)
        x = torch.relu(x + p["b"].reshape(-1)[:, None, None])
        x = F.max_pool2d(x, 2, 2)
    h, w_ = x.shape[2], x.shape[3]
    x = x.reshape(n, B, -1, h, w_).permute(1, 0, 3, 4, 2).reshape(B, n, -1)
    return _dense_stack(params, x, len(cfg.mlp_hidden) + 1, members=True)


def mlp_forward(params, x, cfg: ModelConfig, members: bool = False):
    return _dense_stack(params, x, len(cfg.mlp_hidden) + 1, members)


def _mean_xent(logits, y):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def cnn_loss(params, batch, cfg: ModelConfig):
    return _mean_xent(cnn_forward(params, batch["x"], cfg), batch["y"])


def mlp_loss(params, batch, cfg: ModelConfig):
    return _mean_xent(mlp_forward(params, batch["x"], cfg), batch["y"])


def forward(params, x, cfg: ModelConfig, members: bool = False):
    if cfg.family == "cnn":
        return cnn_forward(params, x, cfg, members)
    if cfg.family == "mlp":
        return mlp_forward(params, x, cfg, members)
    raise NotImplementedError(
        f"forward() is the image models' entry; family {cfg.family!r} runs "
        f"through forward_logits (the token families) or encode (audio)")


def loss_fn(params, batch, cfg: ModelConfig, members: bool = False):
    """The training loss: mean cross-entropy of the image models on
    ``{"x", "y"}``; for the LM, the mean next-token cross-entropy on
    ``{"tokens", "labels"}`` (labels < 0 carry no target; position t
    predicts token t + 1), over the labels that count; with a vision
    frontend the batch's ``patches`` come first and carry no label; for the
    audio encoder (``causal=False``) the per-frame cross-entropy on
    ``{"features", "labels"}``, without a shift. With ``members``
    (the LM), the (B,) per-member losses. The MoE families add their
    layers' Switch aux losses, as the reference's ``ce + aux``."""
    if cfg.family in ("cnn", "mlp"):
        return _mean_xent(forward(params, batch["x"], cfg), batch["y"])
    x = embed_inputs(params, batch, cfg, members)
    hidden, aux = backbone_forward(params, x, cfg, members=members)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        # the patch positions carry no labels
        pad = labels.new_full(labels.shape[:1] + batch["patches"].shape[1:2],
                              -1)
        labels = torch.cat([pad, labels], dim=1)
    if cfg.causal:
        hidden, labels = hidden[..., :-1, :], labels[..., 1:]
    ce = chunked_cross_entropy(hidden, _unembed_weight(params, cfg), labels,
                               cfg, members=members)
    return ce if aux is None else ce + aux


def _xent_from_logits(logits, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., N, V) of any dtype, pad vocab columns masked; labels
    (..., N), < 0 masked. (sum of the rows' nll, count of rows) over N, f32
    math. Under sharding rules the logits' vocab axis may be sharded
    (``models/sharded.lse_gold``)."""
    logits = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    if sharding.current_rules() is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe.long()[..., None])[..., 0]
    else:
        lse, gold = sharded.lse_gold(logits, safe)
    return torch.sum((lse - gold) * mask, dim=-1), \
        torch.sum(mask, dim=-1, dtype=torch.float32)


def chunked_cross_entropy(hidden, unembed_w, labels, cfg: ModelConfig,
                          chunk: int = 1024, members: bool = False):
    """Mean cross-entropy of hidden (B, S, D) through unembed_w (D, Vp)
    against labels (B, S), in sequence chunks of ``chunk`` so that the f32
    logits of only one chunk exist at a time; the reference's scan, as a
    loop. With ``members``: hidden (B, n, S, D), unembed_w (B, D, Vp),
    labels (B, n, S) -> the (B,) per-member means."""
    S, D = hidden.shape[-2], hidden.shape[-1]
    chunk = min(chunk, S)
    n = -(-S // chunk)
    if n * chunk != S and sharding.current_rules() is None:
        # (DTensors go unpadded: their last chunk is the shorter one)
        hidden = F.pad(hidden, (0, 0, 0, n * chunk - S))
        labels = F.pad(labels, (0, n * chunk - S), value=-1)
    lead = hidden.shape[:1] if members else ()
    w = unembed_w.to(hidden.dtype)
    tot = cnt = 0.0
    for c in range(n):
        h = hidden[..., c * chunk:(c + 1) * chunk, :].reshape(lead + (-1, D))
        logits = layers.mask_vocab_pad(
            member_dot(h, w, x_members=members, w_members=members), cfg)
        logits = constrain(logits, ("tokens", "vocab"))
        t, k = _xent_from_logits(
            logits, labels[..., c * chunk:(c + 1) * chunk].reshape(lead + (-1,)))
        tot, cnt = tot + t, cnt + k
    return tot / torch.clamp(cnt, min=1.0)


def token_accuracy(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Masked next-token accuracy (the token families' test metric)."""
    logits = forward_logits(params, batch, cfg)
    labels = batch["labels"]
    if cfg.causal:   # position t predicts token t + 1, as in the loss
        logits, labels = logits[:, :-1], labels[:, 1:]
    mask = (labels >= 0).float()
    hit = (torch.argmax(logits, dim=-1) == labels).float()
    return torch.sum(hit * mask) / torch.clamp(torch.sum(mask), min=1.0)


def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts; ``active`` discounts the routed
    experts to top_k / E, by the reference's rule (a leaf under a
    ``w_in``/``w_gate``/``w_out`` key with E among its first two axes), and
    equals ``total`` without experts."""
    if cfg.family in ("cnn", "mlp"):
        params = init_params(torch.Generator().manual_seed(0), cfg)
    else:
        params = init_params(None, cfg, "meta")
    total = expert = 0

    def walk(node, keys):
        nonlocal total, expert
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
            return
        n = node.numel()
        total += n
        if (cfg.num_experts > 0 and {"w_in", "w_gate", "w_out"} & set(keys)
                and node.dim() >= 3 and cfg.num_experts in node.shape[:2]):
            expert += n

    walk(params, ())
    if cfg.num_experts > 0 and cfg.top_k > 0:
        return total, total - expert + expert * cfg.top_k // cfg.num_experts
    return total, total


def predict(params, x, cfg: ModelConfig):
    return torch.argmax(forward(params, x, cfg), dim=-1)


def accuracy(params, batch, cfg: ModelConfig) -> torch.Tensor:
    return torch.mean((predict(params, batch["x"], cfg) == batch["y"]).float())


# ---------------------------------------------------------------------------
# The dense decoder LM: init, full-sequence forward, prefill, decode
# ---------------------------------------------------------------------------

REMATS = ("none", "full", "dots")
TOKEN_FAMILIES = ("dense", "moe", "ssm", "hybrid")
FRONTEND_FAMILIES = ("vlm", "audio")
FRONTENDS = (None, "vision", "audio")
MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "moe+dense", "none")


def check_lm(cfg: ModelConfig) -> None:
    """Raise for an LM configuration the port does not know: a family that
    is none of ``TOKEN_FAMILIES`` or ``FRONTEND_FAMILIES``, a frontend that
    is none of ``FRONTENDS``, a ``remat`` that is none of ``REMATS`` or a
    superblock position of an unknown kind."""
    if cfg.family not in TOKEN_FAMILIES + FRONTEND_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of "
            f"{TOKEN_FAMILIES + FRONTEND_FAMILIES}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend must be one of {FRONTENDS}, "
                         f"got {cfg.frontend!r}")
    if cfg.remat not in REMATS:
        raise ValueError(f"{cfg.name}: remat must be one of {REMATS}, got "
                         f"{cfg.remat!r}")
    for mix, ffn in zip(cfg.block_pattern, cfg.ffn_pattern):
        if mix not in MIXERS or ffn not in FFNS:
            raise ValueError(f"{cfg.name}: superblock position ({mix!r}, "
                             f"{ffn!r}) is not one of {MIXERS} x {FFNS}")
        if "moe" in ffn and not (cfg.num_experts > 0 and cfg.top_k > 0):
            raise ValueError(f"{cfg.name}: an MoE FFN needs num_experts and "
                             f"top_k")


_MIXER_INIT = {"attn": layers.init_attention, "mamba": ssm.init_mamba,
               "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}
_MIXER_AXES = {"attn": layers.ATTN_AXES, "mamba": ssm.MAMBA_AXES,
               "mlstm": ssm.MLSTM_AXES, "slstm": ssm.SLSTM_AXES}
_POS_CACHE_AXES = {"attn": layers.ATTN_CACHE_AXES,
                   "mamba": ssm.MAMBA_STATE_AXES,
                   "mlstm": ssm.MLSTM_STATE_AXES,
                   "slstm": ssm.SLSTM_STATE_AXES}
_NORM_AXES = {"scale": ("embed_act",)}
_NORM_AXES_LN = {"scale": ("embed_act",), "bias": ("embed_act",)}
_MIXER_STATE = {"mamba": ssm.init_mamba_state, "mlstm": ssm.init_mlstm_state,
                "slstm": ssm.init_slstm_state}


def _norm_init(cfg: ModelConfig):
    """The norms' init: layernorm for the audio family, else rmsnorm."""
    if cfg.family == "audio":
        return layers.init_layernorm
    return layers.init_rmsnorm


def init_lm(gen, cfg: ModelConfig, device="cpu") -> dict:
    """Stacked superblocks: position ``p{i}`` holds its mixer and, unless
    its FFN kind is ``"none"``, ``norm2`` and the FFN (``dense``, ``moe``,
    or ``{"moe", "dense"}`` side by side). Then the inputs' and outputs'
    leaves: ``embed`` (tokens), with ``proj`` (D, D) beside it for a vision
    frontend; for the audio frontend ``in_proj`` (D, D) and the ``cls``
    head (D, vocab_padded), its pad columns zero."""
    pd = layers.param_dtype_of(cfg)
    D, lead = cfg.d_model, (cfg.num_superblocks,)
    norm_init = _norm_init(cfg)
    blocks = {}
    for i, (mix, ffn) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        pos = {"norm1": norm_init(D, pd, device, lead),
               "mixer": _MIXER_INIT[mix](gen, cfg, device, lead)}
        if ffn != "none":
            pos["norm2"] = norm_init(D, pd, device, lead)
            if ffn == "dense":
                pos["ffn"] = layers.init_ffn(gen, cfg, device, lead)
            elif ffn == "moe":
                pos["ffn"] = moe.init_moe(gen, cfg, device, lead)
            else:
                pos["ffn"] = {"moe": moe.init_moe(gen, cfg, device, lead),
                              "dense": layers.init_ffn(gen, cfg, device,
                                                       lead)}
        blocks[f"p{i}"] = pos
    params = {"blocks": blocks, "final_norm": norm_init(D, pd, device)}
    if cfg.frontend == "audio":
        params["in_proj"] = layers.dense_init(gen, (D, D), pd, device)
        params["cls"] = F.pad(layers.dense_init(gen, (D, cfg.vocab_size), pd,
                                                device),
                              (0, cfg.vocab_padded - cfg.vocab_size))
    else:
        params["embed"] = layers.init_embed(gen, cfg, device)
        if cfg.frontend == "vision":
            params["proj"] = layers.dense_init(gen, (D, D), pd, device)
    return params


def superblock_axes(cfg: ModelConfig) -> dict:
    """One superblock's logical axes, position by position."""
    naxes = _NORM_AXES_LN if cfg.family == "audio" else _NORM_AXES
    out = {}
    for i, (mix, ffn) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        pos = {"norm1": naxes, "mixer": dict(_MIXER_AXES[mix])}
        if ffn != "none":
            pos["norm2"] = naxes
            if ffn == "dense":
                pos["ffn"] = dict(layers.FFN_AXES)
            elif ffn == "moe":
                pos["ffn"] = _moe_axes(cfg)
            else:
                pos["ffn"] = {"moe": _moe_axes(cfg),
                              "dense": dict(layers.FFN_AXES)}
        out[f"p{i}"] = pos
    return out


def _moe_axes(cfg: ModelConfig) -> dict:
    ax = dict(moe.MOE_AXES)
    if cfg.num_shared_experts == 0:
        ax.pop("shared", None)
    return ax


def _prune_axes(axes, params):
    """Drop axis entries whose key is absent from params (e.g. swiglu's
    gate)."""
    if isinstance(params, dict):
        return {k: _prune_axes(axes[k], v) for k, v in params.items()}
    return axes


def param_axes(cfg: ModelConfig, params: Optional[dict] = None) -> dict:
    """Tree of logical-axis tuples matching ``init_params``'s, key for key
    (``params``, default ``init_params`` on the ``meta`` device). Stacked
    superblock leaves get a leading ``layers`` axis; the image models'
    leaves are replicated."""
    if params is None:
        params = init_params(torch.Generator().manual_seed(0)
                             if cfg.family in ("cnn", "mlp") else None,
                             cfg, "cpu" if cfg.family in ("cnn", "mlp")
                             else "meta")
    if cfg.family in ("cnn", "mlp"):
        return tree_map(lambda x: (None,) * x.dim(), params)
    sb = sharding.map_axes(lambda ax: ("layers",) + ax, superblock_axes(cfg))
    naxes = _NORM_AXES_LN if cfg.family == "audio" else _NORM_AXES
    axes = {"blocks": sb, "final_norm": naxes}
    if cfg.frontend == "audio":
        axes["in_proj"] = ("embed", "embed_act")
        axes["cls"] = ("embed", "vocab")
    else:
        axes["embed"] = dict(layers.EMBED_AXES)
        if cfg.tie_embeddings:
            axes["embed"].pop("unembed")
        if cfg.frontend == "vision":
            axes["proj"] = ("embed", "embed_act")
    return _prune_axes(axes, params)


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_cache``'s tree, with the stacked
    superblock axis (``layers``) first."""
    one = {f"p{i}": dict(_POS_CACHE_AXES[mix])
           for i, mix in enumerate(cfg.block_pattern)}
    return sharding.map_axes(lambda ax: ("layers",) + ax, one)


def embed_inputs(params, batch: dict, cfg: ModelConfig,
                 members: bool = False):
    """The backbone's input x (B, S, D): the token embeddings; with a
    vision frontend and ``patches`` (B, P, D) in the batch, the projected
    patches in front of them, (B, P + S, D); for the audio frontend the
    projected ``features`` (B, S, D). ``members`` is for the token
    families only."""
    if members and (cfg.frontend is not None
                    or cfg.family in FRONTEND_FAMILIES):
        raise ValueError(f"{cfg.name}: the member-batched path has no "
                         f"frontend (the simulator registers no "
                         f"{cfg.family!r} family)")
    if cfg.frontend == "audio":
        x = batch["features"].to(layers.dtype_of(cfg))
        x = member_dot(x, params["in_proj"].to(x.dtype))
        return constrain(x, ("batch", "seq", "embed_act"))
    tok = layers.embed_tokens(params["embed"], batch["tokens"], cfg, members)
    if cfg.frontend == "vision" and "patches" in batch:
        p = member_dot(batch["patches"].to(tok.dtype),
                       params["proj"].to(tok.dtype))
        tok = torch.cat([p, tok], dim=1)
    return constrain(tok, ("batch", "seq", "embed_act"))


def _unembed_weight(params, cfg: ModelConfig):
    """The (D, Vp) output head: ``cls`` for the audio frontend, else the
    token table's (``layers.unembed_weight``)."""
    if cfg.frontend == "audio":
        return params["cls"]
    return layers.unembed_weight(params["embed"])


def _unembed(params, x, cfg: ModelConfig):
    logits = member_dot(x, _unembed_weight(params, cfg).to(x.dtype))
    logits = layers.mask_vocab_pad(logits, cfg)
    return constrain(logits, ("batch", "vocab") if logits.dim() == 2
                     else ("batch", "seq", "vocab"))


def _superblock(stacked, i: int):
    """Superblock ``i`` of a stacked tree (params or cache): views."""
    return tree_map(lambda a: a[i], stacked)


def _norm(p, x, cfg: ModelConfig, members: bool = False):
    """rmsnorm (layernorm for the audio family); with ``members`` each
    member's (D,) leaves on its rows."""
    if members:
        p = tree_map(lambda a: a.reshape(a.shape[:1] + (1,) * (x.dim() - 2)
                                         + a.shape[-1:]), p)
    if cfg.family == "audio":
        return layers.layernorm(p, x, cfg.norm_eps)
    return layers.rmsnorm(p, x, cfg.norm_eps)


def _add_aux(total, aux):
    """The MoE aux losses summed in layer order (None: no MoE layer)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _ffn_apply(pp, kind: str, x, cfg: ModelConfig, members: bool = False):
    """A position's FFN -> (y, aux or None)."""
    if kind == "dense":
        return layers.ffn_forward(pp["ffn"], x, cfg, members), None
    if kind == "moe":
        return moe.moe_forward(pp["ffn"], x, cfg, members)
    y, aux = moe.moe_forward(pp["ffn"]["moe"], x, cfg, members)
    return y + layers.ffn_forward(pp["ffn"]["dense"], x, cfg, members), aux


def _mixer_forward(mix: str, p, h, cfg: ModelConfig, positions, cache,
                   members: bool):
    """A position's sequence mixer; with ``cache`` (this position's views
    of the stacked cache) it also fills it in place."""
    if mix == "attn":
        return layers.attention_forward(p, h, cfg, positions, cache,
                                        members=members)
    if cache is None:
        return getattr(ssm, f"{mix}_forward")(p, h, cfg, members)
    state, y = getattr(ssm, f"{mix}_fill_state")(p, h, cfg, members)
    for k, v in state.items():
        cache[k].copy_(v)
    return y


def _residual_constraint(x, cfg: ModelConfig):
    """The residual stream's layout between blocks: its sequence over
    ``seq_act`` under ``cfg.seq_shard`` (Megatron-SP)."""
    if cfg.seq_shard:
        return constrain(x, ("batch", "seq_act", "embed_act"))
    return constrain(x, ("batch", None, "embed_act"))


def superblock_forward(params, x, cfg: ModelConfig, positions, cache=None,
                       members: bool = False):
    """One superblock over x (B, S, D) ((B, n, S, D) with ``members``) ->
    (x, the sum of its MoE aux losses or None). With ``cache`` (this
    superblock's views of the stacked cache), each mixer also fills it: the
    KV cache of an attention layer, the final state of a recurrent one; the
    residual stream is then left as it is, as in the reference's
    prefill."""
    aux = None
    res = ((lambda t: t) if cache is not None
           else functools.partial(_residual_constraint, cfg=cfg))
    for i, (mix, ffn) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        pp = params[f"p{i}"]
        h = _norm(pp["norm1"], x, cfg, members)
        x = res(x + _mixer_forward(mix, pp["mixer"], h, cfg, positions,
                                   None if cache is None else cache[f"p{i}"],
                                   members))
        if ffn != "none":
            h = _norm(pp["norm2"], x, cfg, members)
            y, a = _ffn_apply(pp, ffn, h, cfg, members)
            x = res(x + y)
            aux = _add_aux(aux, a)
    return x, aux


# JAX's ``dots_with_no_batch_dims_saveable``: a product whose operands
# share no batch axis. ``member_dot``'s shared-weight product and the
# projections dispatch to these two; a member-batched product (``bmm``, the
# ``grouped_matmul`` launches) has the member axis as a batch axis, as
# ``vmap`` gives the reference's ``dot_general`` one, and is recomputed.
# (On the CPU the grouped kernel's plain version is one ``mm`` a group, and
# those are kept: what is stored differs there, not the values.)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the output of a product without a batch axis; recompute the
    rest (the attention kernels' launches, which the dispatcher does not
    see, run again in the recompute)."""
    CP = torch.utils.checkpoint.CheckpointPolicy
    return CP.MUST_SAVE if op in _SAVED_DOTS else CP.PREFER_RECOMPUTE


def _checkpoint(fn, *args, cfg: ModelConfig):
    """``fn(*args)`` under ``torch.utils.checkpoint``: everything
    recomputed under ``remat == "full"``, the products of ``_dots_policy``
    kept under ``"dots"``. The recompute runs in the forward's member-math
    mode and under its sharding rules: it runs inside the backward, which
    autograd runs on its own thread for a CUDA device, where the caller's
    ``routing`` and ``logical_rules`` contexts are not set (the products
    would go to ``torch.matmul`` instead of ``grouped_matmul``, and the
    constraint sites would see no rules)."""
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    mode = member_math.current_mode()
    rules = sharding.current_rules()

    def run(*a):
        with member_math.routing(mode), sharding.logical_rules(rules):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             **kw)


def _checkpointed(sb, x, cfg: ModelConfig, positions, members: bool):
    """One superblock under ``_checkpoint``."""
    return _checkpoint(superblock_forward, sb, x, cfg, positions, None,
                       members, cfg=cfg)


def _group_forward(sbs, x, cfg: ModelConfig, positions, members: bool):
    """The superblocks of one scan group, each checkpointed: the inner
    level of the two-level remat. Returns (x, aux or None)."""
    aux = None
    for sb in sbs:
        x, a = _checkpointed(sb, x, cfg, positions, members)
        aux = _add_aux(aux, a)
    return x, aux


def backbone_forward(params, x, cfg: ModelConfig, cache=None,
                     members: bool = False):
    """All superblocks and the final norm over x (B, S, D) ((B, n, S, D)
    with ``members``) at positions 0..S-1 -> (hidden, the MoE aux losses
    summed over the layers, or None without an MoE layer); with ``cache``
    (from ``init_cache``) fills it. Under ``cfg.remat == "full"`` or
    ``"dots"``, when autograd records, each superblock is checkpointed: its
    activations are recomputed in the backward, apart from ``"dots"``'s
    saved products; with ``cfg.scan_groups = G > 1`` dividing the
    superblocks, each group of them is checkpointed too (the reference's
    two-level remat). Every setting gives the same values."""
    check_lm(cfg)
    positions = torch.arange(x.shape[-2], device=x.device)[None, :]
    remat = (cfg.remat != "none" and cache is None
             and torch.is_grad_enabled())
    if cache is None:
        x = _residual_constraint(x, cfg)
    # one unbind a leaf, not a select a superblock: the backward of nsb
    # selects would write and add nsb zero-filled copies of every stacked
    # leaf; unbind's stacks the superblocks' gradients once
    blocks = tree_map(lambda a: a.unbind(1 if members else 0),
                      params["blocks"])
    nsb, G = cfg.num_superblocks, cfg.scan_groups
    sbs = [tree_map(lambda views: views[s], blocks) for s in range(nsb)]
    aux = None
    if remat and G > 1 and nsb % G == 0:
        n = nsb // G
        for g in range(G):
            x, a = _checkpoint(_group_forward, sbs[g * n:(g + 1) * n], x,
                               cfg, positions, members, cfg=cfg)
            aux = _add_aux(aux, a)
    else:
        for s, sb in enumerate(sbs):
            if remat:
                x, a = _checkpointed(sb, x, cfg, positions, members)
            else:
                x, a = superblock_forward(
                    sb, x, cfg, positions,
                    None if cache is None else _superblock(cache, s), members)
            aux = _add_aux(aux, a)
    return _norm(params["final_norm"], x, cfg, members), aux


def forward_logits(params, batch: dict, cfg: ModelConfig):
    """Full logits (B, S, vocab_padded), pad columns masked ((B, P + S,
    ...) with patches)."""
    x = embed_inputs(params, batch, cfg)
    hidden, _ = backbone_forward(params, x, cfg)
    return _unembed(params, hidden, cfg)


def encode(params, batch: dict, cfg: ModelConfig):
    """The encoder-only forward (hubert): per-frame logits (B, S,
    vocab_padded), the reference's ``encode``."""
    return forward_logits(params, batch, cfg)


def _check_decode(cfg: ModelConfig) -> None:
    check_lm(cfg)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu") -> dict:
    """Zeroed decode caches, stacked ``(nsb, B, ...)`` per position: the KV
    cache ``(nsb, B, C, Hkv, hd)`` of an attention layer, the recurrent
    state of a mamba, mLSTM or sLSTM layer (f32, ``m`` at -1e30). An
    encoder-only config raises ``ValueError``."""
    _check_decode(cfg)
    lead = (cfg.num_superblocks,)
    return {f"p{i}": (layers.init_attention_cache(cfg, batch, max_len,
                                                  device, lead=lead)
                      if mix == "attn" else
                      _MIXER_STATE[mix](cfg, batch, device, lead=lead))
            for i, mix in enumerate(cfg.block_pattern)}


def prefill(params, batch: dict, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Full-sequence prefill: the forward of ``forward_logits`` filling the
    cache. Returns (cache, last-position logits (B, V)), the KV caches sized
    for ``max_len`` (>= S; defaults to S). With ``patches`` (B, P, D) the
    sequence is the P patches and then the S tokens, at positions 0 .. P +
    S - 1, so decode goes on from position P + S."""
    _check_decode(cfg)
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, max(max_len or S, S), x.device)
    rules = sharding.current_rules()
    if rules is not None:       # laid out by cache_axes, as decode reads it
        cache = sharding.distribute(
            cache, sharding.shard_pytree_spec(rules, cache_axes(cfg)),
            x.device_mesh)
    hidden, _ = backbone_forward(params, x, cfg, cache)
    return cache, _unembed(params, hidden[:, -1], cfg)


def superblock_decode(params, cache, x, pos: int, cfg: ModelConfig):
    """One superblock for one token; writes its ``cache`` views."""
    for i, (mix, ffn) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        pp = params[f"p{i}"]
        c = cache[f"p{i}"]
        h = _norm(pp["norm1"], x, cfg)
        if mix == "attn":
            _, y = layers.attention_decode(pp["mixer"], c, h, pos, cfg)
        else:
            state, y = getattr(ssm, f"{mix}_decode")(pp["mixer"], c, h, cfg)
            for k, v in state.items():
                c[k].copy_(v)
        x = x + y
        if ffn != "none":
            h = _norm(pp["norm2"], x, cfg)
            x = x + _ffn_apply(pp, ffn, h, cfg)[0]
    return cache, x


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One-token decode. tokens: (B, 1); ``pos`` the tokens' position.
    Updates ``cache`` in place; returns (cache, logits (B, 1, V))."""
    _check_decode(cfg)
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    for s in range(cfg.num_superblocks):
        _, x = superblock_decode(_superblock(params["blocks"], s),
                                 _superblock(cache, s), x, pos, cfg)
    x = _norm(params["final_norm"], x, cfg)
    return cache, _unembed(params, x, cfg)
