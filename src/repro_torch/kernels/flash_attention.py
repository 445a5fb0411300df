"""Flash attention: online-softmax GQA attention, causal or not, with an
optional sliding window, and its gradient.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``). The port's
``models/layers.attention_forward`` routes every full-sequence attention
through it: prefill, evaluation and, with a gradient, training. On a CUDA
tensor the wrapper launches the hand-written kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward); on a CPU tensor it runs the plain versions below; on a
``meta`` tensor it returns empty results and computes nothing. It never
falls back from one to the other. On the card and on meta each launch
reports its cost (``cost``, ``bwd_cost``: the band's pairs, 4 hd flops a
pair and head forward, 2.5 times that backward) to the op counter in use
(``launch/op_cost.py``).

Contract (the reference's ``repro/models/layers.py`` ``chunked_attention``
at query offset 0, and with a gradient JAX's autodiff of it; with no window
also the oracle ``repro/kernels/ref.py`` ``flash_attention_ref``): q (B, Sq,
H, hd), k and v (B, Sk, Hkv, hd) with H % Hkv == 0, query head h reading kv
head h // (H / Hkv); causal masking is top-left (key j is seen by query i
iff j <= i) or absent; a ``window`` W >= 1 also masks key j for query i
unless j > i - W (with ``causal=False`` the band has this lower edge
only); scores scaled by 1 / sqrt(hd), masked to -1e30, softmax and PV in
f32; output (B, Sq, H, hd) in q's dtype, float32 or bfloat16. A row whose
band holds no key (i >= Sk + W - 1, which needs Sq > Sk + W - 1) is a
softmax over Sk scores that are all -1e30: the mean of v over the Sk keys,
as in the reference when Sk is a multiple of its ``kv_chunk`` (its chunks'
zero padding would otherwise join the mean). Its gradient is the
reference's autodiff of that constant: p = 1/Sk on every key and dS = 0,
so nothing reaches dQ or dK and every key's dV gets do_i / Sk (the row's
lse cannot say so: in f32 -1e30 + log Sk rounds to -1e30, which would give
p = 1, so both backward versions treat these rows on their own).

``flash_attention`` runs the forward kernel alone when no input needs a
gradient (the serve path: one launch, nothing saved). When autograd needs
one, it goes through ``FlashAttention``: the forward kernel also writes
the row log-sum-exp, f32 (B, H, Sq), and the backward is
``flash_attention_bwd`` (dq, dk, dv from q, k, v, o, do and that lse).
``flash_attention.launches`` counts forward launches,
``flash_attention_bwd.launches`` backward ones (two kernels, three with
rows that see no key; one count, on either route).

On a CUDA tensor the forward kernel is chosen by dtype (a dispatch, not a
fallback; neither ever catches the other's failure):

* bfloat16 (the serve path): the tensor-core kernel. QK^T and PV are bf16
  ``wgmma`` products with f32 accumulation, and p is rounded to bf16
  before PV (as the reference's TPU kernel did at the MXU's default
  precision, and as ``chunked_attention`` does), while l sums the f32 p.
  Against the plain version, which keeps p in f32, each output element is
  within ``2^-7 |plain| + 2^-8 max|v| + 1e-4`` (``bf16_limit``).
* float32 (the parity mode): the IEEE fp32 CUDA-core kernel, within
  ``2e-5 max(1, max|plain|)`` of the plain version.

The backward is chosen by dtype and head dim (``bwd_route``; a
documented dispatch, not a fallback: neither entry point ever catches the
other's failure):

* bfloat16 with hd <= 128 (the full-width training path; hd buckets 64
  and 128, zero-filled past hd): the tensor-core kernels
  (``flash_attention_bwd_tc``). S = QK^T and dP = dO V^T are bf16
  ``wgmma`` products with f32 accumulation; P and dS = P (dP - D) are
  f32 and are each rounded once to bf16 before the products that read
  them (dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K), as the
  reference's autodiff reads its bf16 p; each output is rounded once.
  Limit, elementwise against the same backward in float64 on the same
  inputs (``bwd_bf16_tc_limit``): ``2^-8 |ref| + (2^-8 + (n + 2 hd + 16)
  u) A``, with A the sum of the output's terms over absolute values.
* float32 (the parity mode the fed-lm golden rests on) and bfloat16 with
  hd > 128: the CUDA-core kernels (``flash_attention_bwd``), all
  arithmetic in f32, each output rounded once. Limits: float32 within
  ``2e-5 max(1, max|plain|)`` of ``flash_attention_bwd_plain`` (summation
  order only); bfloat16 against float64 (``bwd_bf16_limit``): ``2^-8
  |ref|`` for the one rounding of the output to bf16 (half an ulp), plus
  ``(n + 2 hd + 16) u A`` with u = 2^-24, n the terms of the output's sum
  (G Sq for dk and dv, Sk for dq): the standard bound of an f32 sum of n
  products, each of them a few f32 roundings deep (the score's hd-term
  dot, exp, the lse subtraction).

All kernels read their inputs through their strides with no copy. With a
window, every kernel walks only the tiles that hold a pair of the band and
masks the tiles that straddle its lower edge, as it masks the diagonal.

Bounds on the H100: the forward at the serve shape is bf16 operations at
the tensor-core peak (0.2086 ms; the f32 kernel's CUDA-core pipe caps it at
about 3.1 ms), and at the long-context shape (1, 16384, 24/8, 128) with
window 8192 the band's 100.7 M pairs a head (134.2 M for full causal) take
1.25 ms there; the backward's five products at the full-width training
shape (2, 2048, 24/8, 128) take 0.13 ms at the bf16 tensor-core peak (the
tensor-core kernels) and 1.9 ms at the fp32 CUDA-core peak (the CUDA-core
kernels). See the sources for the designs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.launch import op_cost

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            *([_L] * 12), _I, _I, ctypes.c_float, _I, _P,
                            _P],
        "flash_attention_tc_attributes": [_I, ctypes.POINTER(_I)]}
_BWD_SIG = {"flash_attention_bwd": [_P] * 11 + [_I] * 6
            + [ctypes.POINTER(_L), _I, _I, ctypes.c_float, _I, _P],
            "flash_attention_bwd_tc": [_P] * 11 + [_I] * 6
            + [ctypes.POINTER(_L), _I, _I, ctypes.c_float, _P],
            "flash_attention_bwd_tc_attributes": [_I, ctypes.POINTER(_I)]}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_BWD_MAX_HEAD_DIM = 128   # bf16 backward on the tensor cores up to here
NEG_INF = -1e30
BF16_LIMIT = "2^-7 |plain| + 2^-8 max|v| + 1e-4"   # bf16_limit, elementwise


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not match "
                         f"(B, Sq, H, hd), (B, Sk, Hkv, hd)")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention: empty input q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")


def _window(window) -> Optional[int]:
    """The window as an int >= 1, or None; raise for anything else."""
    if window is None:
        return None
    if isinstance(window, bool) or int(window) != window or window < 1:
        raise ValueError(f"flash_attention: window must be an integer >= 1 "
                         f"or None, got {window!r}")
    return int(window)


def band_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
              device=None) -> Optional[torch.Tensor]:
    """(Sq, Sk) bool: the pairs (query i, key j) that attend (j <= i under
    ``causal``, j > i - ``window`` with a window), or None when all do."""
    if not causal and window is None:
        return None
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    mask = j <= i if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                             device=device)
    if window is not None:
        mask = mask & (j > i - window)
    return mask


@functools.lru_cache(maxsize=256)
def band_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs inside the band (``band_mask``'s True entries)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int, causal: bool,
         window: Optional[int], itemsize: int, with_lse: bool) -> dict:
    """One forward launch's work, the bound of PERF.md's kernel table: 4 hd
    flops (QK^T and PV) and one exp a pair of the band and head; q, k, v
    read and the output (and the f32 lse) written once."""
    pairs = B * H * band_pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd)
    return {"flops": 4.0 * hd * pairs, "transcendentals": float(pairs),
            "nbytes": float(nbytes + (4 * B * H * Sq if with_lse else 0))}


def bwd_cost(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
             causal: bool, window: Optional[int], itemsize: int) -> dict:
    """One backward launch's work: five products of 2 hd flops a pair and
    head (2.5 times the forward's), the exp recomputed; q, o, dO and k, v
    read, dq, dk, dv written and the lse read once."""
    pairs = B * H * band_pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (4 * B * Sq * H * hd + 4 * B * Sk * Hkv * hd)
    return {"flops": 10.0 * hd * pairs, "transcendentals": float(pairs),
            "nbytes": float(nbytes + 4 * B * H * Sq)}


def has_empty_rows(Sq: int, Sk: int, window: Optional[int]) -> bool:
    """Whether some query's band holds no key: i >= Sk + window - 1."""
    return window is not None and Sq >= Sk + window


def _empty_rows(Sq: int, Sk: int, window: Optional[int],
                device=None) -> Optional[torch.Tensor]:
    """(Sq, 1) bool marking the queries whose band holds no key, or None
    when there are none."""
    if not has_empty_rows(Sq, Sk, window):
        return None
    return (torch.arange(Sq, device=device) >= Sk + window - 1)[:, None]


def _scores(q, k, causal: bool, dtype=torch.float32, window=None):
    """Scaled scores (B, H, Sq, Sk) in ``dtype``, masked to -1e30 outside
    the band (``band_mask``), and k's heads repeated for the query heads'
    groups."""
    hd, group = q.shape[3], q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k.to(dtype), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), kf) / math.sqrt(hd)
    mask = band_mask(q.shape[1], k.shape[1], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=dtype,
                                            device=q.device))
    return s


def _plain_forward(q, k, v, causal: bool, window=None):
    """(out in q's dtype, lse f32 (B, H, Sq)) in eager torch."""
    s = _scores(q, k, causal, window=window)
    vf = torch.repeat_interleave(v.float(), q.shape[2] // k.shape[2], dim=2)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The function in eager torch, as ``flash_attention_ref``: materialised
    f32 scores, -1e30 masking, f32 softmax, output in q's dtype."""
    return _plain_forward(q, k, v, causal, _window(window))[0]


def flash_attention_bwd_plain(q, k, v, o, do, lse, causal: bool = True,
                              dtype=torch.float32, absolute: bool = False,
                              window: Optional[int] = None):
    """The backward in eager torch: (dq, dk, dv) of the attention at q, k, v
    with output o, output gradient do and the forward's row log-sum-exp
    lse (B, H, Sq), computed in ``dtype`` (float32; float64 for the
    kernel's bf16 check) and returned in the inputs' dtype (in ``dtype``
    when ``dtype`` is float64). With ``absolute`` every product takes
    absolute values: the sums of |terms| that ``bwd_bf16_limit`` reads.
    Pairs outside the band get p = 0; a row whose band holds no key
    (``has_empty_rows``) gets p = 1/Sk on every key and dS = 0, the
    reference's gradient of a softmax over Sk constant scores."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    window = _window(window)
    f = (lambda t: t.to(dtype).abs()) if absolute else (lambda t: t.to(dtype))
    s = _scores(q, k, causal, dtype, window)
    p = torch.exp(s - lse.to(dtype)[..., None])      # masked pairs: 0
    empty = _empty_rows(Sq, Sk, window, q.device)
    if empty is not None:
        p = torch.where(empty, torch.full((), 1.0 / Sk, dtype=dtype,
                                          device=q.device), p)
    rep = lambda t: torch.repeat_interleave(f(t), group, dim=2)  # noqa: E731
    dof, qf = f(do), f(q)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, rep(v))
    dsum = torch.einsum("bqhd,bqhd->bhq", dof, f(o))
    ds = p * (dp + dsum[..., None] if absolute else dp - dsum[..., None])
    if empty is not None:
        ds = torch.where(empty, torch.zeros((), dtype=dtype, device=q.device),
                         ds)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, rep(k)) * scale
    # the group's query heads add into their kv head
    dk = dk.reshape(B, -1, Hkv, group, hd).sum(3)
    dv = dv.reshape(B, -1, Hkv, group, hd).sum(3)
    out = q.dtype if dtype != torch.float64 else dtype
    return dq.to(out), dk.to(out), dv.to(out)


def bwd_bf16_limit(ref, absref, n_terms: int, hd: int) -> torch.Tensor:
    """Elementwise limit on |kernel - ref| for a bf16 backward output, from
    its float64 backward ``ref`` and the sum of absolute terms ``absref``
    (``flash_attention_bwd_plain(..., float64, absolute=True)``): half a
    bf16 ulp of the output, plus the f32 error bound of a sum of
    ``n_terms`` products each a few roundings deep."""
    u = 2.0 ** -24
    return 2.0 ** -8 * ref.abs() + (n_terms + 2 * hd + 16) * u * absref


def bwd_bf16_tc_limit(ref, absref, n_terms: int, hd: int) -> torch.Tensor:
    """Elementwise limit on |kernel - ref| for an output of the bf16
    tensor-core backward, from its float64 backward ``ref`` and the sum of
    absolute terms ``absref`` (as ``bwd_bf16_limit``). Each output y (dV_jd,
    dK_jd, dQ_id) is m fl32(sum_t a_t b_t) rounded to bf16, with b_t an
    exact bf16 input (dO, Q or K), a_t the bf16 rounding of an f32 P or dS,
    and m the scale (1 for dV). Term by term, with u = 2^-24:

    * the output's rounding to bf16, which keeps 8 significant bits: at
      most 2^-8 |y|, i.e. 2^-8 |ref| to first order;
    * the operand's rounding, once per term: |bf16(a) - a| <= 2^-8 |a|.
      For dV that moves term i by at most 2^-8 P_ij |dO_id|; for dK and dQ
      by at most 2^-8 |dS_ij| |Q_id| (|K_jd|), with |dS_ij| <= P_ij
      (|dP_ij| + |D_i|), all times m. Summed, each is at most 2^-8 absref,
      which holds exactly these absolute terms;
    * the f32 work before the rounding, as in ``bwd_bf16_limit``: the
      hd-term dots of S, dP and D (bf16 products are exact, the sums f32),
      exp and the lse subtraction, at most (2 hd + 16) u absref; and the
      f32 sum of the n terms, at most n u absref.

    In all: ``2^-8 |ref| + (2^-8 + (n + 2 hd + 16) u) absref``. The 2^-8 a
    rounding is bf16's unit roundoff, as ``bf16_limit`` charges p's
    rounding in the forward."""
    u = 2.0 ** -24
    return 2.0 ** -8 * ref.abs() + (2.0 ** -8 + (n_terms + 2 * hd + 16) * u) \
        * absref


def bf16_limit(plain: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise limit on |kernel - plain| for bf16 inputs, from the
    plain output (B, Sq, H, hd) and v (B, Sk, Hkv, hd): bf16 keeps 8
    significant bits, so rounding p_j to bf16 moves it by at most 2^-8 p_j,
    and the f32 output sum_j p_j v_j / l (l the f32 sum of the unrounded
    p, sum_j p_j / l = 1) by at most 2^-8 max|v| (max over the (b, kv-head)
    slice the query head reads); both sides then round to bf16 once (at
    most one ulp, 2^-7 |plain|); 1e-4 covers f32 summation order near
    zero."""
    B, _, H, _ = plain.shape
    vmax = v.float().abs().amax(dim=(1, 3))                # (B, Hkv)
    vmax = torch.repeat_interleave(vmax, H // v.shape[2], dim=1)
    return (2.0 ** -7 * plain.float().abs()
            + 2.0 ** -8 * vmax[:, None, :, None] + 1e-4)


def tc_attributes(hd: int) -> dict:
    """The CUDA runtime's attributes of the bf16 tensor-core kernel that
    head dim ``hd`` launches: registers and local (spill) bytes a thread,
    static and maximum dynamic shared memory a block, the latter as the
    first launch of that hd bucket set it. Needs a card."""
    vals = (_I * 4)()
    lib = _build.load("flash_attention", _SIG)
    _build.check(lib.flash_attention_tc_attributes(hd, vals),
                 "flash_attention_tc_attributes")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "max_dynamic_smem_bytes"), vals))


def bwd_tc_attributes(hd: int) -> dict:
    """The CUDA runtime's attributes of the two bf16 tensor-core backward
    kernels that head dim ``hd`` launches, ``{"dq": {...}, "dkdv": {...}}``
    with the keys of ``tc_attributes``. Needs a card."""
    vals = (_I * 8)()
    lib = _build.load("flash_attention_bwd", _BWD_SIG)
    _build.check(lib.flash_attention_bwd_tc_attributes(hd, vals),
                 "flash_attention_bwd_tc_attributes")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "max_dynamic_smem_bytes")
    return {name: dict(zip(keys, vals[4 * i:4 * i + 4]))
            for i, name in enumerate(("dq", "dkdv"))}


def _device(q: torch.Tensor, what: str) -> str:
    """"cpu", "cuda" or "meta" (the plain version, the kernel or its cost
    alone); raise otherwise, and for shapes beyond the kernels' grids."""
    dev = q.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {dev}")
    B, _, H, hd = q.shape
    if dev.type == "cuda" and (hd > MAX_HEAD_DIM or H > 65535 or B > 65535):
        raise ValueError(f"{what}: hd={hd} (at most {MAX_HEAD_DIM}), H={H} "
                         f"or B={B} exceeds the grid")
    return dev.type


def _c_window(window: Optional[int], Sq: int, Sk: int) -> int:
    """The kernels' window argument: 0 for none; a window past Sq + Sk
    (where it masks nothing) is passed as Sq + Sk, inside int32."""
    return 0 if window is None else min(window, Sq + Sk)


def _forward(q, k, v, causal: bool, with_lse: bool, window=None):
    """(out, lse or None): the plain version on the CPU, one forward launch
    on the card (writing the lse only if asked). ``window`` is an int >= 1
    or None, checked by the public entry."""
    if _device(q, "flash_attention") == "cpu":
        out, lse = _plain_forward(q, k, v, causal, window)
        return out, (lse if with_lse else None)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), device=q.device, dtype=q.dtype)
    lse = (torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    op_cost.report("flash_attention", **cost(
        B, Sq, Sk, H, Hkv, hd, causal, window, q.element_size(), with_lse))
    if q.device.type == "meta":
        return out, lse
    lib = _build.load("flash_attention", _SIG)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, hd, *q.stride(), *k.stride(), *v.stride(),
        int(causal), _c_window(window, Sq, Sk), 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16),
        None if lse is None else lse.data_ptr(), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a CUDA tensor of ``dtype`` and head dim ``hd``
    goes to: ``"tc"`` (bf16, hd <= 128: the tensor-core kernels) or
    ``"cuda_core"`` (f32, and bf16 above hd 128)."""
    return ("tc" if dtype == torch.bfloat16 and hd <= TC_BWD_MAX_HEAD_DIM
            else "cuda_core")


# the C entry point of each route
BWD_ENTRY = {"tc": "flash_attention_bwd_tc", "cuda_core": "flash_attention_bwd"}


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool = True,
                        window: Optional[int] = None):
    """(dq, dk, dv), fresh contiguous tensors in q's dtype, of the attention
    at q, k, v (whose output was o and row log-sum-exp lse) for the output
    gradient do: ``flash_attention_bwd_plain`` on the CPU, on the card the
    kernels ``bwd_route`` names."""
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: o and do must be {q.dtype} "
                        f"and lse float32; got {o.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    if _device(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal,
                                         window=window)
    return _bwd_cuda(q, k, v, o, do, lse, causal,
                     bwd_route(q.dtype, q.shape[3]), _window(window))


def _bwd_cuda(q, k, v, o, do, lse, causal: bool, route: str, window=None):
    """One launch of the route's backward kernels (two kernels, three when
    rows see no key: one count); ``window`` as ``_forward``'s."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, hd), device=q.device, dtype=q.dtype)
    dk = torch.empty((B, Sk, Hkv, hd), device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
    empty_dv = (torch.empty((B, Hkv, hd), device=q.device,
                            dtype=torch.float32)
                if has_empty_rows(Sq, Sk, window) else None)
    op_cost.report("flash_attention_bwd", **bwd_cost(
        B, Sq, Sk, H, Hkv, hd, causal, window, q.element_size()))
    if q.device.type == "meta":
        return dq, dk, dv
    strides = (_L * 20)(*q.stride(), *k.stride(), *v.stride(), *o.stride(),
                        *do.stride())
    lib = _build.load("flash_attention_bwd", _BWD_SIG)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            None if empty_dv is None else empty_dv.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hkv, hd, strides,
            int(causal), _c_window(window, Sq, Sk), 1.0 / math.sqrt(hd)]
    if route == "cuda_core":
        args.append(int(q.dtype == torch.bfloat16))
    err = getattr(lib, BWD_ENTRY[route])(*args, stream)
    _build.check(err, BWD_ENTRY[route])
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel (with its lse) and the
    backward kernel (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = _forward(q, k, v, causal, True, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, Hkv, hd) -> fresh
    contiguous (B, Sq, H, hd) in q's dtype, within a sliding ``window``
    when one is given; differentiable through ``FlashAttention`` when
    autograd needs a gradient of an input."""
    _check(q, k, v)
    window = _window(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, False, window)[0]


flash_attention.launches = 0
