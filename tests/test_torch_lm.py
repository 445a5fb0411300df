"""The port's dense-LM serve path against the JAX reference, on the CPU.

Parameters are the reference's init converted with
``convert.params_from_numpy``; inputs are made with numpy from a seed and
handed to both sides. Tolerances:

* f32 smoke (``phi4-mini-3.8b-smoke`` and its GQA variant): prefill logits
  and cache, four decode steps' logits within rtol/atol 1e-4, with identical
  greedy tokens (both sides compute the same f32 function; the gap is
  summation order);
* layers in f32 within rtol/atol 1e-5 (one or two products deep);
* bf16 smoke prefill within 5e-2 of max |ref logits|: both sides run the
  products in bf16 with their own accumulation orders, and the reference's
  model attention rounds the probabilities to bf16 before PV where the
  port's kernel keeps them in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "phi4-mini-3.8b"
SMOKE = ARCH + "-smoke"


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x):
    return x.detach().float().numpy()


def _ref_params(rcfg, seed=0):
    p = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _pair(gqa: bool = False, **over):
    rcfg, tcfg = rget(SMOKE), tget(SMOKE)
    if gqa:
        over = {"num_kv_heads": 2, **over}
    return (dataclasses.replace(rcfg, **over) if over else rcfg,
            dataclasses.replace(tcfg, **over) if over else tcfg)


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_config_fields_match_reference(arch):
    r, t = rget(arch), tget(arch)
    ported = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(r):
        if f.name in ported:
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for prop in ("num_superblocks", "vocab_padded"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.for_long_context().sliding_window == \
        r.for_long_context().sliding_window
    # the LM fields the serve path reads are all carried
    for name in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                 "d_ff", "vocab_size", "head_dim", "rope_theta", "norm_eps",
                 "dtype", "param_dtype", "ffn_act"):
        assert name in ported, name


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    dt = tree.dtype
    name = str(dt).replace("torch.", "")
    return {prefix: (tuple(tree.shape), name)}


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_init_shapes_and_dtypes_match_reference(arch):
    """At full width the port's init runs on the meta device (nothing is
    allocated); the reference's is ``jax.eval_shape``."""
    want = _shapes(jax.eval_shape(
        lambda: RM.init_params(jax.random.PRNGKey(0), rget(arch))))
    got = _shapes(TM.init_params(None, tget(arch), device="meta"))
    assert got == want
    if arch == ARCH:
        n = sum(int(np.prod(s)) for s, _ in got.values())
        assert n == 4_450_618_368


def test_init_law_and_vocab_padding():
    cfg = dataclasses.replace(tget(SMOKE), vocab_size=500)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert p["embed"]["tok"].shape == (512, cfg.d_model)
    assert bool((p["embed"]["tok"][500:] == 0).all())
    assert bool((p["embed"]["unembed"][:, 500:] == 0).all())
    w = p["blocks"]["p0"]["mixer"]["wq"]           # (nsb, D, H, hd)
    std = 1.0 / np.sqrt(cfg.d_model)
    assert w.shape == (2, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert float(w.abs().max()) <= 2 * std + 1e-7
    # a +-2 sigma truncated unit normal has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    assert not torch.equal(w[0], w[1])
    assert bool((p["blocks"]["p0"]["norm1"]["scale"] == 1).all())


def test_convert_keeps_bf16_and_f32_leaves():
    """A bf16 reference tree arrives as torch.bfloat16, bit for bit; an f32
    (image-path) tree stays float32 and round-trips unchanged."""
    rcfg = dataclasses.replace(rget(SMOKE), param_dtype="bfloat16")
    ref = _ref_params(rcfg)
    port = params_from_numpy(ref)
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(port)):
        assert a.dtype == ml_dtypes.bfloat16, path
        assert t.dtype == torch.bfloat16, path
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), path
    img = _ref_params(rget("paper-synthetic-mlp"))
    timg = params_from_numpy(img)
    for a, t in zip(jax.tree_util.tree_leaves(img),
                    jax.tree_util.tree_leaves(timg)):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), a)
    back = params_to_numpy(timg)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(img), jax.tree_util.tree_leaves(back)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)
    pos = np.arange(7)[None, :] + 5
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert TL.apply_rope(xb, torch.from_numpy(pos), 1e4).dtype == torch.bfloat16
    assert TL.rmsnorm({"scale": torch.ones(16)}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu", "relu2"])
def test_ffn_forward_matches_reference(act):
    rcfg, tcfg = _pair(ffn_act=act)
    rp = RL.init_ffn(jax.random.PRNGKey(3), rcfg)
    rp = jax.tree_util.tree_map(np.asarray, rp)
    x = np.random.default_rng(1).standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
    want = RL.ffn_forward(rp, jnp.asarray(x), rcfg, R)
    got = TL.ffn_forward(params_from_numpy(rp), torch.from_numpy(x), tcfg)
    assert ("w_gate" in rp) == (act == "swiglu")
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)


def test_embed_unembed_and_vocab_mask_match_reference():
    rcfg, tcfg = _pair(vocab_size=500)               # padded to 512
    assert tcfg.vocab_padded == 512
    rp = jax.tree_util.tree_map(np.asarray,
                                RL.init_embed(jax.random.PRNGKey(4), rcfg))
    tp = params_from_numpy(rp)
    toks = np.random.default_rng(2).integers(0, 500, (2, 6))
    want = RL.embed_tokens(rp, jnp.asarray(toks), rcfg, R)
    got = TL.embed_tokens(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_array_equal(_tn(got), _np(want))
    want_l = RL.unembed(rp, want, rcfg, R)
    got_l = TL.unembed(tp, got, tcfg)
    np.testing.assert_allclose(_tn(got_l), _np(want_l), rtol=1e-5, atol=1e-5)
    assert float(got_l[..., 500:].max()) == float(np.float32(-1e30))
    logits = np.random.default_rng(3).standard_normal((3, 512)).astype(np.float32)
    np.testing.assert_array_equal(
        _tn(TL.mask_vocab_pad(torch.from_numpy(logits), tcfg)),
        _np(RL.mask_vocab_pad(jnp.asarray(logits), rcfg)))


def test_attention_forward_gqa_matches_reference_chunked_path():
    """The port's attention (flash kernel's plain version on the CPU)
    against the reference's chunked_attention path, GQA 2:1."""
    rcfg, tcfg = _pair(gqa=True)
    rp = jax.tree_util.tree_map(np.asarray,
                                RL.init_attention(jax.random.PRNGKey(5), rcfg))
    x = np.random.default_rng(4).standard_normal((2, 40, rcfg.d_model)).astype(np.float32)
    want = RL.attention_forward(rp, jnp.asarray(x), rcfg, R)
    got = TL.attention_forward(params_from_numpy(rp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)


def test_attention_forward_fills_cache_like_reference():
    """Given a cache, attention_forward writes the reference's
    attention_fill_cache cache (token i at slot i, zero tail) in place and
    returns the same output; with a sliding window of 8 the cache is the
    reference's ring of 8 slots (the prompt's last 8 tokens at slots
    (S - 8 + i) % 8)."""
    rcfg, tcfg = _pair(gqa=True)
    rp = jax.tree_util.tree_map(np.asarray,
                                RL.init_attention(jax.random.PRNGKey(6), rcfg))
    x = np.random.default_rng(5).standard_normal((2, 13, rcfg.d_model)).astype(np.float32)
    rcache, want = RL.attention_fill_cache(rp, jnp.asarray(x), rcfg, R, max_len=20)
    cache = TL.init_attention_cache(tcfg, 2, 20, "cpu")
    got = TL.attention_forward(params_from_numpy(rp), torch.from_numpy(x), tcfg,
                               cache=cache)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)
    for kv in ("k", "v"):
        assert tuple(cache[kv].shape) == rcache[kv].shape
        np.testing.assert_allclose(_tn(cache[kv]), _np(rcache[kv]),
                                   rtol=1e-5, atol=1e-5)
    rcfg, tcfg = (dataclasses.replace(c, sliding_window=8)
                  for c in (rcfg, tcfg))
    rcache, want = RL.attention_fill_cache(rp, jnp.asarray(x), rcfg, R,
                                           max_len=20)
    cache = TL.init_attention_cache(tcfg, 2, 20, "cpu")
    assert cache["k"].shape[1] == 8 < x.shape[1]
    got = TL.attention_forward(params_from_numpy(rp), torch.from_numpy(x),
                               tcfg, cache=cache)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_tn(cache[kv]), _np(rcache[kv]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    want = RL.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.int32(6))
    got = TL.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 6)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the serve path: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gqa", [False, True], ids=["smoke", "gqa"])
def test_prefill_and_decode_match_reference(gqa):
    rcfg, tcfg = _pair(gqa=gqa)
    rp = _ref_params(rcfg, seed=1)
    tp = params_from_numpy(rp)
    B, S, steps = 2, 19, 4
    toks = np.random.default_rng(7).integers(0, rcfg.vocab_size, (B, S))
    rcache, rlog = RM.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, R,
                              max_len=S + steps + 1)
    ops.reset_launch_counts()
    tcache, tlog = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              max_len=S + steps + 1)
    assert ops.launch_counts()["flash_attention"] == 0      # CPU: plain path
    np.testing.assert_allclose(_tn(tlog), _np(rlog), rtol=1e-4, atol=1e-4)
    for kv in ("k", "v"):
        assert tuple(tcache["p0"][kv].shape) == rcache["p0"][kv].shape
        np.testing.assert_allclose(_tn(tcache["p0"][kv]), _np(rcache["p0"][kv]),
                                   rtol=1e-4, atol=1e-4)
    r_tok = jnp.argmax(rlog, -1)[:, None]
    t_tok = torch.argmax(tlog, -1)[:, None]
    for i in range(steps):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
        rcache, rl = RM.decode_step(rp, rcache, r_tok, jnp.int32(S + i), rcfg, R)
        tcache, tl = TM.decode_step(tp, tcache, t_tok, S + i, tcfg)
        np.testing.assert_allclose(_tn(tl), _np(rl), rtol=1e-4, atol=1e-4)
        r_tok = jnp.argmax(rl[:, 0], -1)[:, None]
        t_tok = torch.argmax(tl[:, 0], -1)[:, None]
    np.testing.assert_allclose(_tn(tcache["p0"]["k"]), _np(rcache["p0"]["k"]),
                               rtol=1e-4, atol=1e-4)


def test_forward_logits_matches_reference_and_prefill():
    rcfg, tcfg = _pair(gqa=True)
    rp = _ref_params(rcfg, seed=2)
    tp = params_from_numpy(rp)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size, (2, 12))
    want = RM.forward_logits(rp, {"tokens": jnp.asarray(toks)}, rcfg, R)
    got = TM.forward_logits(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-4, atol=1e-4)
    _, last = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_tn(last), _tn(got[:, -1]), rtol=1e-5, atol=1e-5)


def test_bf16_prefill_matches_reference():
    rcfg, tcfg = _pair(gqa=True, dtype="bfloat16", param_dtype="bfloat16")
    rp = _ref_params(rcfg, seed=3)
    tp = params_from_numpy(rp)
    assert tp["blocks"]["p0"]["mixer"]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(9).integers(0, rcfg.vocab_size, (2, 24))
    rcache, rlog = RM.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, R)
    tcache, tlog = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tlog.dtype == torch.bfloat16 and tcache["p0"]["k"].dtype == torch.bfloat16
    want = _np(rlog)
    err = np.abs(_tn(tlog) - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("case", ["sliding_window", "long_context", "family",
                                  "tie_embeddings", "frontend", "arch",
                                  "image_smoke"])
def test_unported_lm_configs_raise(case):
    cfg = tget(SMOKE)
    if case == "tie_embeddings":
        # ported since the LM training slice: a tied model has no unembed
        # table and reads tok's transpose (tests/test_torch_lm_train.py
        # holds its loss and logits to the reference)
        p = TM.init_params(torch.Generator().manual_seed(0),
                           dataclasses.replace(cfg, tie_embeddings=True))
        assert set(p["embed"]) == {"tok"}
        return
    if case == "sliding_window":
        # ported since the sliding-window slice: a windowed model runs, and
        # its prefill fills a ring of `window` slots
        # (tests/test_torch_window.py holds it to the reference)
        wcfg = dataclasses.replace(cfg, sliding_window=8)
        p = TM.init_params(torch.Generator().manual_seed(0), wcfg)
        toks = torch.randint(0, wcfg.vocab_size, (1, 12),
                             generator=torch.Generator().manual_seed(1))
        cache, logits = TM.prefill(p, {"tokens": toks}, wcfg)
        assert cache["p0"]["k"].shape[2] == 8
        assert bool(torch.isfinite(logits).all())
        return
    if case == "long_context":
        # the full-width long-context config initialises (meta) and sizes
        # its decode cache to the 8,192-slot ring
        lcfg = tget(ARCH).for_long_context()
        assert lcfg.sliding_window == 8192
        p = TM.init_params(None, lcfg, "meta")
        assert p["blocks"]["p0"]["mixer"]["wq"].device.type == "meta"
        cache = TM.init_cache(lcfg, 1, 16384 + 32, "meta")
        assert cache["p0"]["k"].shape == (32, 1, 8192, 8, 128)
        return
    if case in ("arch", "family"):
        # the recurrent, MoE and hybrid families are ported since the
        # families slice (tests/test_torch_families.py holds them to the
        # reference); a frontend arch or family still raises
        cfg2 = tget("xlstm-350m-smoke")
        assert cfg2.family == "ssm" and bool(torch.isfinite(TM.init_params(
            torch.Generator().manual_seed(0), cfg2)["final_norm"]["scale"]
        ).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "arch":
            tget("internvl2-1b-smoke")
        elif case == "image_smoke":             # image models have no smoke
            tget("paper-cifar10-cnn-smoke")
        else:
            over = {"family": {"family": "audio"},
                    "frontend": {"frontend": "vision"}}[case]
            cfg = dataclasses.replace(cfg, **over)
            TM.init_params(torch.Generator().manual_seed(0), cfg)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "9",
                      "--gen", "3"])
    assert res["tokens"].shape == (2, 3) and res["decode_steps"] == 2
    assert int(res["tokens"].max()) < tget(SMOKE).vocab_size
    assert "tok/s" in capsys.readouterr().out


def test_serve_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([])
