"""Sliding-window attention and the ring KV cache in the port against the JAX
reference, on the CPU.

``flash_attention(window=)`` (its plain route on the CPU) and its gradient
against the reference's ``chunked_attention(window=)`` with ``q_chunk`` and
``kv_chunk`` below S, so that the band crosses chunk edges: f32, rtol 1e-5
and atol 1e-6 (online chunked softmax against a materialised one differ in
rounding only). A window of at least S equals no window bit for bit. The
ring cache: prefill (the ring's layout included) and decode logits of
``phi4-mini-3.8b-smoke`` with ``sliding_window=8`` and S = 24, steps past
the wrap, on the same converted parameters, at rtol/atol 1e-4 (as
``tests/test_torch_lm.py``'s prefill and decode); ring decode against the
windowed forward, the port's own version of ``tests/test_arch_smoke.py``'s
``test_sliding_window_decode_matches_windowed_forward``. And the bf16
limit of the forward kernel: an emulation of the kernel's rounding stays
within ``bf16_limit`` while a window off by one key does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

SMOKE = "phi4-mini-3.8b-smoke"
RTOL, ATOL = 1e-5, 1e-6
B, S, HD = 2, 40, 16
Q_CHUNK, KV_CHUNK = 16, 8


def _inputs(H, Hkv, seed, Sq=S, Sk=S):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, HD)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hkv, HD)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _reference(q, k, v, do, causal, window):
    def f(q_, k_, v_):
        return RL.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                    q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK)
    out = f(*(jnp.asarray(a) for a in (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * do), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(q, k, v, do, causal, window):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return out.detach(), grads


# (H, Hkv, causal, window): GQA and MHA, causal and not, a window of 1, one
# below a kv chunk (8), one above it, one above a q chunk (16)
CASES = [(6, 2, True, 1), (6, 2, True, 5), (6, 2, True, 12), (4, 4, True, 20),
         (4, 4, True, 8), (6, 2, False, 1), (6, 2, False, 5),
         (4, 4, False, 12), (4, 1, False, 20)]


@pytest.mark.parametrize("H,Hkv,causal,window", CASES)
def test_window_forward_and_grad_match_chunked_attention(H, Hkv, causal,
                                                         window):
    q, k, v, do = _inputs(H, Hkv, 100 * H + 10 * window + causal)
    want, want_g = _reference(q, k, v, do, causal, window)
    got, got_g = _port(q, k, v, do, causal, window)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    # the window really bites: the output moves against no window
    free, _ = _port(q, k, v, do, causal, None)
    assert float((free - got).abs().max()) > 1e-3


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [S, S + 7, 1000 * S])
def test_window_of_at_least_S_is_no_window(causal, window):
    q, k, v, do = _inputs(6, 2, window + causal)
    got, got_g = _port(q, k, v, do, causal, window)
    want, want_g = _port(q, k, v, do, causal, None)
    assert torch.equal(got, want)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)


def test_window_with_sq_not_sk_matches_chunked_attention():
    """Sq < Sk (top-left causal), the band's edges against the reference."""
    q, k, v, do = _inputs(6, 2, 5, Sq=24, Sk=40)
    for causal in (True, False):
        want, want_g = _reference(q, k, v, do, causal, 6)
        got, got_g = _port(q, k, v, do, causal, 6)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_rows_without_a_key_average_v_and_match_the_reference_gradient():
    """causal=False with Sq > Sk + W - 1: queries from Sk + W - 1 on see no
    key; their output is the softmax of Sk scores of -1e30, the mean of v,
    as the reference's (Sk a multiple of its kv chunk, so no padding joins
    the mean). The gradient is the reference's ``jax.grad``: such a row
    sends nothing to dq and dk (its scores are constants) and do / Sk to
    every key's dv."""
    W, Sq, Sk = 4, 40, 24
    q, k, v, do = _inputs(4, 2, 11, Sq=Sq, Sk=Sk)
    assert tfa.has_empty_rows(Sq, Sk, W) and not tfa.has_empty_rows(26, Sk, W)
    want, want_g = _reference(q, k, v, do, False, W)
    got, got_g = _port(q, k, v, do, False, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    mean = np.repeat(v.mean(axis=1), 2, axis=1)          # (B, H, hd)
    np.testing.assert_allclose(got.numpy()[:, Sk + W - 1:],
                               np.broadcast_to(mean[:, None],
                                               got.shape)[:, Sk + W - 1:],
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    dq = got_g[0].numpy()
    assert np.all(dq[:, Sk + W - 1:] == 0.0)
    assert np.abs(dq[:, :Sk + W - 1]).max() > 1e-3
    # the empty rows' share of dv: the same for every key of a kv head
    full = tfa.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), got,
        torch.from_numpy(do), tfa._plain_forward(
            *(torch.from_numpy(a) for a in (q, k, v)), False, W)[1],
        causal=False, window=W)[2].numpy()
    do_cut = do.copy()
    do_cut[:, Sk + W - 1:] = 0.0
    kept = tfa.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), got,
        torch.from_numpy(do_cut), tfa._plain_forward(
            *(torch.from_numpy(a) for a in (q, k, v)), False, W)[1],
        causal=False, window=W)[2].numpy()
    share = do[:, Sk + W - 1:].reshape(B, -1, 2, 2, HD).sum(axis=(1, 3)) / Sk
    np.testing.assert_allclose(full - kept,
                               np.broadcast_to(share[:, None], full.shape),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [0, -3, 2.5, True])
def test_bad_window_raises(window):
    q, k, v, _ = _inputs(2, 2, 1)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=window)


def _emulated_kernel_bf16(q, k, v, causal, window):
    """The forward kernel's bf16 arithmetic, emulated: f32 scores and
    softmax, p rounded to bf16 before PV, l the f32 sum of the unrounded p,
    the output rounded once to bf16."""
    s = tfa._scores(q, k, causal, window=window)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_ = p.sum(-1, keepdim=True)
    vf = torch.repeat_interleave(v.float(), q.shape[2] // k.shape[2], dim=2)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf)
    return (pv / l_.permute(0, 2, 1, 3)).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_limit_admits_the_rounding_and_misses_an_off_by_one_window(
        causal):
    """``bf16_limit`` (2^-8 max|v| for p's rounding to bf16, the restated
    term) admits the kernel's documented rounding, and still fails a kernel
    whose window is off by one key, either way."""
    rng = np.random.default_rng(4 + causal)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(
        np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(
        np.float32)).bfloat16() for _ in range(2))
    W = 9
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=W)
    limit = tfa.bf16_limit(plain, v)
    good = _emulated_kernel_bf16(q, k, v, causal, W)
    share = float(((good.float() - plain.float()).abs() / limit).max())
    assert 0.0 < share <= 1.0, share
    for off in (W - 1, W + 1):
        bad = tfa.flash_attention_plain(q, k, v, causal=causal, window=off)
        assert float(((bad.float() - plain.float()).abs() / limit).max()) > 1


# ---------------------------------------------------------------------------
# the ring KV cache
# ---------------------------------------------------------------------------

def _ring_pair(window=8):
    rcfg = dataclasses.replace(rget(SMOKE), num_kv_heads=2,
                               sliding_window=window)
    tcfg = dataclasses.replace(tget(SMOKE), num_kv_heads=2,
                               sliding_window=window)
    rp = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(5), rcfg))
    return rcfg, tcfg, rp


def test_ring_prefill_and_decode_match_reference():
    """Prefill of 24 tokens into a ring of 8 slots (the roll branch: the
    trailing window at slots (S - C + i) % C), then 12 greedy decode steps,
    which wrap the ring; the cache and every step's logits against the
    reference's, with identical greedy tokens."""
    rcfg, tcfg, rp = _ring_pair()
    tp = params_from_numpy(rp)
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (2, 24))
    rcache, rlog = RM.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, R)
    tcache, tlog = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tcache["p0"]["k"].shape[2] == 8
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["p0"][key].numpy(),
                                   np.asarray(rcache["p0"][key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=1e-4,
                               atol=1e-4)
    tok = np.argmax(np.asarray(rlog), -1)[:, None]
    assert np.array_equal(tok, torch.argmax(tlog, -1)[:, None].numpy())
    for i in range(12):
        rcache, rl = RM.decode_step(rp, rcache, jnp.asarray(tok, jnp.int32),
                                    jnp.int32(24 + i), rcfg, R)
        tcache, tl = TM.decode_step(tp, tcache, torch.from_numpy(tok),
                                    24 + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.argmax(np.asarray(rl)[:, 0], -1)[:, None]
        assert np.array_equal(tok, torch.argmax(tl[:, 0], -1)[:, None].numpy())
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["p0"][key].numpy(),
                                   np.asarray(rcache["p0"][key]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S_,max_len", [(24, None), (5, 40), (8, 20)])
def test_ring_decode_matches_windowed_forward(S_, max_len):
    """Decode through the ring equals the windowed full forward at the
    decoded positions: from a prompt longer than the window (the roll), one
    shorter than it with a longer horizon (slot i, then the wrap), and one
    of exactly the window."""
    _, tcfg, rp = _ring_pair()
    tp = params_from_numpy(rp)
    n = 10
    toks = torch.from_numpy(np.random.default_rng(S_).integers(
        0, tcfg.vocab_size, (2, S_ + n)))
    cache, _ = TM.prefill(tp, {"tokens": toks[:, :S_]}, tcfg,
                          max_len=max_len)
    assert cache["p0"]["k"].shape[2] == 8
    full = TM.forward_logits(tp, {"tokens": toks}, tcfg)
    for i in range(n):
        cache, lg = TM.decode_step(tp, cache, toks[:, S_ + i:S_ + i + 1],
                                   S_ + i, tcfg)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, S_ + i].numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_serve_generate_long_context_on_cpu():
    """``serve.generate`` serves a config's sliding-window variant through
    its ring cache: the prompt is longer than the window, and the tokens
    equal a greedy decode over the windowed full forward."""
    from repro_torch.launch import serve
    cfg = dataclasses.replace(tget(SMOKE),
                              long_context_window=8).for_long_context()
    assert cfg.sliding_window == 8
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 11),
                            generator=torch.Generator().manual_seed(1))
    res = serve.generate(params, cfg, prompts, 4)
    assert res["tokens"].shape == (2, 4) and res["decode_steps"] == 3
    toks = prompts
    for i in range(4):
        lg = TM.forward_logits(params, {"tokens": toks}, cfg)[:, -1]
        nxt = torch.argmax(lg, dim=-1)[:, None]
        assert torch.equal(nxt, res["tokens"][:, i:i + 1])
        toks = torch.cat([toks, nxt], dim=1)
