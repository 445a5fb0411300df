"""The port's ``flash_attention`` against the reference's, on the CPU.

The plain version (what the wrapper runs for CPU tensors) is held against
the reference's Pallas kernel, run in interpret mode as the reference's own
tests run it, and against its oracle ``flash_attention_ref``, on the shapes
of ``tests/test_flash_attention.py`` plus a top-left causal case with
Sq != Sk. Inputs are made with numpy from a seed. Tolerances: rtol/atol
2e-5 in f32 (the same function; online vs materialised softmax differ in
rounding only); in bf16, 1e-2 of max |ref| (one bf16 rounding of the
output, 2^-8 relative, on top of f32 math). The CUDA kernels themselves run
only on a card: the ``gpu`` test holds them against the plain version
there, in f32 within 2e-5 * max(1, max|plain|) and in bf16 (the
tensor-core kernel, which rounds p to bf16 before PV) elementwise within
``bf16_limit``: 2^-7 |plain| + 2^-9 max|v| + 1e-4 (p's rounding moves the
output by at most 2^-9 max|v|; both sides round to bf16 once, at most one
ulp). A CPU test emulates that rounding in torch and shows the limit
admits it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_flash_attention.py's shapes, then Sq != Sk (top-left causal)
SHAPES = [
    (2, 64, 64, 4, 2, 16, True),
    (1, 128, 128, 8, 8, 32, True),      # MHA
    (2, 64, 64, 4, 1, 16, False),       # MQA, bidirectional
    (1, 100, 100, 2, 2, 8, True),       # non-block-multiple seq
    (1, 33, 33, 4, 2, 64, False),
    (2, 40, 72, 6, 2, 32, True),        # Sq < Sk, causal from key 0
]


def _inputs(B, Sq, Sk, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, Sq, Sk, H, Hkv, hd,
                                                   causal, dtype):
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, hd, seed=Sq * H + hd)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want_kernel = np.asarray(r_flash(jq, jk, jv, causal=causal, block_q=32,
                                     block_k=16), np.float32)
    want_ref = np.asarray(flash_attention_ref(jq, jk, jv, causal=causal),
                          np.float32)
    tdt = getattr(torch, dtype)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (B, Sq, H, hd)
    got = got.float().numpy()
    for want in (want_kernel, want_ref):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _tensor_core_emulation(q, k, v, causal):
    """The bf16 tensor-core kernel's arithmetic in plain torch: online
    softmax over 64-key tiles in f32, p rounded to bf16 before PV, l the
    sum of the f32 p, the output rounded to bf16 once."""
    B, Sq, H, hd = q.shape
    Sk, group = k.shape[1], H // k.shape[2]
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    m = torch.full((B, H, Sq, 1), tfa.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 64):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + 64]) / hd ** 0.5
        if causal:
            keys = torch.arange(k0, min(k0 + 64, Sk))[None, :]
            s = torch.where(keys <= rows, s, torch.full((), tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd",
                                        p.bfloat16().float(), vf[:, k0:k0 + 64])
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal",
                         SHAPES + [(2, 300, 300, 24, 8, 128, True)])
def test_bf16_limit_admits_tensor_core_rounding(B, Sq, Sk, H, Hkv, hd,
                                                causal):
    """The bf16 limit holds for the documented rounding (p in bf16 before
    PV), before any card run, and is not vacuous: the emulation differs
    from the plain version."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(B, Sq, Sk, H, Hkv, hd, seed=Sq + hd))
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    got = _tensor_core_emulation(q, k, v, causal)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tfa.bf16_limit(want, v)).all()), float(diff.max())
    assert float(diff.max()) > 0


def test_cpu_calls_launch_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 4, 2, 16, 0))
    ops.reset_launch_counts()
    tfa.flash_attention(q, k, v)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_strided_inputs_and_no_grad():
    """Non-contiguous views give the contiguous inputs' result, and inputs
    that require grad are fine where autograd is off."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 16, 16, 4, 2, 8, 1))
    want = tfa.flash_attention(q, k, v)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qs.is_contiguous()
    torch.testing.assert_close(tfa.flash_attention(qs, k, v), want)
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(), k, v)
    torch.testing.assert_close(out, want)


@pytest.mark.parametrize("bad", ["heads", "device", "grad", "dtype", "shape",
                                 "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 4, 2, 16, 2))
    err = {"heads": ValueError, "device": ValueError, "grad": TypeError,
           "dtype": TypeError, "shape": ValueError, "empty": ValueError}[bad]
    with pytest.raises(err):
        if bad == "heads":                    # H % Hkv != 0
            tfa.flash_attention(q[:, :, :3], k, v)
        elif bad == "device":
            tfa.flash_attention(q, k.to("meta"), v)
        elif bad == "grad":      # the backward takes do in the inputs' dtype
            o, lse = tfa._plain_forward(q, k, v, True)
            tfa.flash_attention_bwd(q, k, v, o, o.bfloat16(), lse)
        elif bad == "dtype":
            tfa.flash_attention(q, k.bfloat16(), v)
        elif bad == "shape":
            tfa.flash_attention(q, k[..., :8], v)
        else:
            tfa.flash_attention(q[:, :0], k, v)


@pytest.mark.gpu
def test_flash_attention_cuda_matches_plain_on_card():
    """The CUDA kernels against their plain version on the card, f32 and
    bf16, at the test shapes, strided views, and a GQA 3:1 serve-like head
    layout; repeated runs bit-identical (fixed key order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    shapes = SHAPES + [(2, 300, 300, 24, 8, 128, True),
                       (1, 70, 50, 4, 4, 200, False)]
    for B, Sq, Sk, H, Hkv, hd, causal in shapes:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(x).to(dev, dt)
                       for x in _inputs(B, Sq, Sk, H, Hkv, hd, seed=hd))
            got = tfa.flash_attention(q, k, v, causal=causal)
            want = tfa.flash_attention_plain(q, k, v, causal=causal)
            assert got.dtype == dt
            diff = (got.float() - want.float()).abs()
            if dt == torch.float32:
                tol = 2e-5 * (1 + float(want.float().abs().max()))
            else:       # p rounded to bf16, then one output rounding
                tol = tfa.bf16_limit(want, v)
            assert bool((diff <= tol).all()), (B, Sq, Sk, H, Hkv, hd, causal,
                                               dt, float(diff.max()))
            assert torch.equal(got, tfa.flash_attention(q, k, v, causal=causal))
    q, k, v = (torch.from_numpy(x).to(dev) for x in _inputs(2, 64, 64, 4, 2, 32, 5))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(tfa.flash_attention(qs, k, v),
                               tfa.flash_attention_plain(q, k, v),
                               rtol=2e-5, atol=2e-5)
    # bf16 views: hd-strided (element-wise loader) and a row-strided slice
    # (cp.async) give the contiguous inputs' bits
    q, k, v = (x.bfloat16() for x in (q, k, v))
    want = tfa.flash_attention(q, k, v)
    qd = q.transpose(1, 3).contiguous().transpose(1, 3)
    wide = torch.zeros((2, 64, 4, 64), device=dev, dtype=torch.bfloat16)
    wide[..., :32] = q
    assert not qd.is_contiguous() and qd.stride(3) != 1
    assert torch.equal(tfa.flash_attention(qd, k, v), want)
    assert torch.equal(tfa.flash_attention(wide[..., :32], k, v), want)
