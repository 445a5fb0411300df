"""The port's ``flash_attention`` against the reference's, on the CPU.

The plain version (what the wrapper runs for CPU tensors) is held against
the reference's Pallas kernel, run in interpret mode as the reference's own
tests run it, and against its oracle ``flash_attention_ref``, on the shapes
of ``tests/test_flash_attention.py`` plus a top-left causal case with
Sq != Sk. Inputs are made with numpy from a seed. Tolerances: rtol/atol
2e-5 in f32 (the same function; online vs materialised softmax differ in
rounding only); in bf16, 1e-2 of max |ref| (one bf16 rounding of the
output, 2^-8 relative, on top of f32 math). The CUDA kernel itself runs
only on a card: the ``gpu`` test holds it against the plain version there,
in bf16 elementwise within one bf16 ulp (2^-7 * |plain| + 1e-4), since both
round the same f32 value once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

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
    err = {"heads": ValueError, "device": ValueError, "grad": RuntimeError,
           "dtype": TypeError, "shape": ValueError, "empty": ValueError}[bad]
    with pytest.raises(err):
        if bad == "heads":                    # H % Hkv != 0
            tfa.flash_attention(q[:, :, :3], k, v)
        elif bad == "device":
            tfa.flash_attention(q, k.to("meta"), v)
        elif bad == "grad":                   # forward-only: never drop a grad
            tfa.flash_attention(q.requires_grad_(), k, v)
        elif bad == "dtype":
            tfa.flash_attention(q, k.bfloat16(), v)
        elif bad == "shape":
            tfa.flash_attention(q, k[..., :8], v)
        else:
            tfa.flash_attention(q[:, :0], k, v)


@pytest.mark.gpu
def test_flash_attention_cuda_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, f32 and bf16,
    at the test shapes, a strided view, and a GQA 3:1 serve-like head
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
            else:       # one bf16 rounding of the same f32 value: <= 1 ulp
                tol = 2.0 ** -7 * want.float().abs() + 1e-4
            assert bool((diff <= tol).all()), (B, Sq, Sk, H, Hkv, hd, causal,
                                               dt, float(diff.max()))
            assert torch.equal(got, tfa.flash_attention(q, k, v, causal=causal))
    q, k, v = (torch.from_numpy(x).to(dev) for x in _inputs(2, 64, 64, 4, 2, 32, 5))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(tfa.flash_attention(qs, k, v),
                               tfa.flash_attention_plain(q, k, v),
                               rtol=2e-5, atol=2e-5)
