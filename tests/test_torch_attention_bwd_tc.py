"""The bf16 tensor-core attention backward's arithmetic and limit, its
dispatch and its build, on the CPU.

The tensor-core kernels (``csrc/flash_attention_bwd.cu``, ``bwd_dq_tc`` and
``bwd_dkdv_tc``) run only on a card. Their arithmetic is emulated here in
torch: S and dP as f32 sums of bf16 products, P = exp(S scale - lse) and
dS = P (dP - D) in f32, P and dS each rounded once to bf16 before the
products that read them (dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K),
f32 sums, each output rounded once to bf16. The emulation must fall within
``bwd_bf16_tc_limit`` of the float64 backward on the same inputs, at every
shape below (GQA and MHA, causal and not, Sq != Sk, hd 16/64/128, and the
full width's heads at S = 300), and must differ from the f32 backward, so
the check is not vacuous. Two defects must break the limit at each shape:
one key tile's contribution dropped, and D left out of dS. The dispatch
picks the kernels by (dtype, hd) and launches nothing on the CPU; the
build's library names cover the headers the sources share.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [                                  # B, Sq, Sk, H, Hkv, hd, causal
    (2, 64, 64, 4, 2, 16, True),            # GQA, one key tile
    (1, 128, 128, 4, 4, 64, False),         # MHA, bidirectional
    (2, 40, 72, 6, 2, 64, True),            # Sq < Sk, top-left causal
    (1, 100, 70, 4, 2, 128, False),         # Sq > Sk, ragged tiles
    (1, 130, 130, 2, 2, 128, True),         # MHA, causal, ragged
    (2, 300, 300, 24, 8, 128, True),        # the full width's heads
]
KEY_TILE = 64


def _inputs(B, Sq, Sk, H, Hkv, hd, causal, seed):
    """bf16 q, k, v, dO from numpy, and the forward's o (bf16) and lse."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hkv, hd)).astype(
        np.float32)).bfloat16() for _ in range(2))
    o, lse = tfa._plain_forward(q, k, v, causal)
    return q, k, v, o, do, lse


def _tc_emulation(q, k, v, o, do, lse, causal, defect=None):
    """(dq, dk, dv) in bf16 by the tensor-core kernels' arithmetic, or with
    a ``defect``: ``"drop_tile"`` leaves out the last 64-key tile that a
    query sees, ``"no_D"`` forms dS = P dP."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / hd ** 0.5
    rep = lambda t: torch.repeat_interleave(t.float(), G, dim=2)  # noqa: E731
    s = tfa._scores(q, k, causal)                 # f32, scaled, masked
    p = torch.exp(s - lse[..., None])             # masked pairs: 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), rep(v))
    dsum = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # (B, H, Sq)
    ds = p * dp if defect == "no_D" else p * (dp - dsum[..., None])
    if defect == "drop_tile":
        seen = min(Sk, Sq) if causal else Sk     # keys some query sees
        k0 = (seen - 1) // KEY_TILE * KEY_TILE
        p[..., k0:k0 + KEY_TILE] = 0.0
        ds[..., k0:k0 + KEY_TILE] = 0.0
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, rep(k)) * scale
    dk = dk.reshape(B, Sk, Hkv, G, hd).sum(3)
    dv = dv.reshape(B, Sk, Hkv, G, hd).sum(3)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _shares(got, q, k, v, o, do, lse, causal):
    """Each output's worst element as a share of ``bwd_bf16_tc_limit`` (an
    exact element counts 0, also where the limit is 0: a key no query
    sees)."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal,
                                        dtype=torch.float64)
    absref = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal,
                                           dtype=torch.float64, absolute=True)
    out = []
    for g, r, a, n in zip(got, ref, absref, (Sk, G * Sq, G * Sq)):
        err = (g.double() - r).abs()
        share = err / tfa.bwd_bf16_tc_limit(r, a, n, hd)
        out.append(float(torch.where(err == 0, 0.0, share).max()))
    return out


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", SHAPES)
def test_bwd_tc_limit_admits_tensor_core_rounding(B, Sq, Sk, H, Hkv, hd,
                                                  causal):
    """The emulated tensor-core backward within ``bwd_bf16_tc_limit`` of
    float64, and not equal to the f32 backward."""
    x = _inputs(B, Sq, Sk, H, Hkv, hd, causal, seed=Sq + hd + H)
    got = _tc_emulation(*x, causal)
    shares = _shares(got, *x, causal)
    assert max(shares) <= 1.0, shares
    plain = tfa.flash_attention_bwd_plain(*x, causal)
    assert all(g.dtype == torch.bfloat16 and g.shape == p.shape
               for g, p in zip(got, plain))
    assert max(float((g.float() - p.float()).abs().max())
               for g, p in zip(got, plain)) > 0


@pytest.mark.parametrize("defect", ["drop_tile", "no_D"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", SHAPES)
def test_bwd_tc_limit_rejects_defects(B, Sq, Sk, H, Hkv, hd, causal, defect):
    """A dropped key tile and a missing D each break the limit."""
    x = _inputs(B, Sq, Sk, H, Hkv, hd, causal, seed=Sq + hd + H)
    shares = _shares(_tc_emulation(*x, causal, defect), *x, causal)
    assert max(shares) > 1.0, shares


def test_bwd_tc_limit_is_the_stated_bound():
    """The limit's terms: half an ulp of |ref| plus 2^-8 and the f32 sums'
    (n + 2 hd + 16) u of the absolute terms; the CUDA-core limit lacks
    only the operand rounding's 2^-8."""
    ref = torch.tensor([1.0, -2.0, 0.0], dtype=torch.float64)
    absref = torch.tensor([3.0, 2.0, 5.0], dtype=torch.float64)
    u, n, hd = 2.0 ** -24, 40, 16
    want = 2.0 ** -8 * ref.abs() + (2.0 ** -8 + (n + 2 * hd + 16) * u) * absref
    torch.testing.assert_close(tfa.bwd_bf16_tc_limit(ref, absref, n, hd),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(
        tfa.bwd_bf16_tc_limit(ref, absref, n, hd)
        - tfa.bwd_bf16_limit(ref, absref, n, hd),
        2.0 ** -8 * absref, rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 129, "cuda_core"), (torch.bfloat16, 256, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 256, "cuda_core")])
def test_bwd_dispatch_by_dtype_and_head_dim(dtype, hd, route):
    """The route the wrapper takes on a card, its C entry point, and on the
    CPU the plain backward with no launch."""
    assert tfa.bwd_route(dtype, hd) == route
    assert tfa.BWD_ENTRY[route] in tfa._BWD_SIG
    B, S, H, Hkv = 1, 9, 4, 2
    rng = np.random.default_rng(hd)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, hd)).astype(
        np.float32)).to(dtype) for _ in range(2))
    o, lse = tfa._plain_forward(q, k, v, True)
    ops.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, do, lse, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_build_target_covers_shared_headers(tmp_path, monkeypatch):
    """An edit to a header under csrc/ renames every library; an edit to
    one source renames that source's library alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["wgmma_bf16.cuh"]
    before = {n: _build._target(n) for n in _build.SOURCES}
    assert {n: _build._target(n) for n in _build.SOURCES} == before
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    src = csrc / "flash_attention_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if again[n] != after[n]] == \
        ["flash_attention_bwd"]
