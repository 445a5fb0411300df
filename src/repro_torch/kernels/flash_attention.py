"""Flash attention forward: online-softmax GQA attention, causal or not.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``). The port's
``models/layers.attention_forward`` routes every prefill attention layer
through it. On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/flash_attention.cu``; on a CPU tensor it runs the plain version
below. It never falls back from one to the other.

Contract (the reference's, oracle ``repro/kernels/ref.py``
``flash_attention_ref``): q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd) with
H % Hkv == 0, query head h reading kv head h // (H / Hkv); causal masking
is top-left (key j is seen by query i iff j <= i) or absent; scores scaled
by 1 / sqrt(hd), masked to -1e30, softmax and PV in f32; output
(B, Sq, H, hd) in q's dtype, float32 or bfloat16. Forward only: the
wrapper raises if autograd would need its gradient (the training path's
attention backward is a later slice, ROADMAP.md).

On a CUDA tensor the kernel is chosen by dtype (a dispatch, not a
fallback; neither ever catches the other's failure):

* bfloat16 (the serve path): the tensor-core kernel. QK^T and PV are bf16
  ``wgmma`` products with f32 accumulation, and p is rounded to bf16
  before PV (as the reference's TPU kernel did at the MXU's default
  precision), while l sums the f32 p. Against the plain version, which
  keeps p in f32, each output element is within
  ``2^-7 |plain| + 2^-9 max|v| + 1e-4`` (``bf16_limit``).
* float32 (the parity mode): the IEEE fp32 CUDA-core kernel, within
  ``2e-5 max(1, max|plain|)`` of the plain version.

Both read q, k and v through their strides with no copy: the bf16 kernel
copies tiles with 16-byte ``cp.async`` where hd has unit stride and rows
are 16-byte aligned, and loads element by element otherwise.

Bound on the H100 at the serve shape: bf16 operations at the tensor-core
peak (0.2086 ms); the f32 kernel's CUDA-core pipe caps it at about 3.1
ms. See the source for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            *([_L] * 12), _I, ctypes.c_float, _I, _P],
        "flash_attention_tc_attributes": [_I, ctypes.POINTER(_I)]}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
NEG_INF = -1e30
BF16_LIMIT = "2^-7 |plain| + 2^-9 max|v| + 1e-4"   # bf16_limit, elementwise


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention is forward-only: an input "
                           "requires grad (the attention backward is a later "
                           "slice, ROADMAP.md)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The function in eager torch, as ``flash_attention_ref``: materialised
    f32 scores, -1e30 masking, f32 softmax, output in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def bf16_limit(plain: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise limit on |kernel - plain| for bf16 inputs, from the
    plain output (B, Sq, H, hd) and v (B, Sk, Hkv, hd): rounding p_j to
    bf16 moves it by at most 2^-9 p_j, so the f32 output by at most 2^-9
    max|v| (max over the (b, kv-head) slice the query head reads); both
    sides then round to bf16 once (at most one ulp, 2^-7 |plain|); 1e-4
    covers f32 summation order near zero."""
    B, _, H, _ = plain.shape
    vmax = v.float().abs().amax(dim=(1, 3))                # (B, Hkv)
    vmax = torch.repeat_interleave(vmax, H // v.shape[2], dim=1)
    return (2.0 ** -7 * plain.float().abs()
            + 2.0 ** -9 * vmax[:, None, :, None] + 1e-4)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, Hkv, hd) -> fresh
    contiguous (B, Sq, H, hd) in q's dtype."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or H > 65535 or B > 65535:
        raise ValueError(f"flash_attention: hd={hd} (at most "
                         f"{MAX_HEAD_DIM}), H={H} or B={B} exceeds the grid")
    out = torch.empty((B, Sq, H, hd), device=dev, dtype=q.dtype)
    lib = _build.load("flash_attention", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, hd, *q.stride(), *k.stride(), *v.stride(),
        int(causal), 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
