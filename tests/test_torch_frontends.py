"""The port's frontends against the JAX reference, on the CPU: vision
(``internvl2-1b``: patch embeddings through ``proj`` in front of the
tokens) and audio (``hubert-xlarge``: an encoder-only layernorm stack over
frame embeddings, per-frame logits through ``cls``).

At full size the port's init runs on the meta device and the reference's
is ``jax.eval_shape``: every leaf's shape and dtype and ``count_params``
are equal. At smoke size (f32), on the reference's init converted with
``convert.params_from_numpy`` and numpy inputs from a seed: ``loss_fn``
within rtol 1e-5 and its gradients within 1e-4 x max(1, max|ref leaf|),
``forward_logits`` and ``encode`` within rtol/atol 1e-4, a prefill with
patches and four decode steps within rtol/atol 1e-4 with equal greedy
tokens; ``layers.layernorm`` within 1e-5.
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
from repro_torch.common.tree import tree_leaves, tree_unflatten_like
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["internvl2-1b", "hubert-xlarge"]
SMOKES = [a + "-smoke" for a in ARCHS]
VLM, AUDIO = SMOKES
COUNTS = {"internvl2-1b": 630_483_840, "hubert-xlarge": 946_260_480}
TOL = dict(rtol=1e-4, atol=1e-4)


def _tn(x):
    return x.detach().float().numpy()


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _ref_init(rcfg, seed):
    p = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(cfg, B: int, S: int, seed: int, patches: bool = True) -> dict:
    """numpy inputs: tokens and labels (some masked), and the patch
    embeddings (vision) or the frame features and per-frame labels
    (audio)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[1, 2:4] = -1
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32), "labels": labels}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": labels}
    if patches:
        out["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS + SMOKES)
def test_config_fields_match_reference(arch):
    r, t = rget(arch), tget(arch)
    ported = {f.name for f in dataclasses.fields(t)}
    left_out = {"pure_data_parallel", "seq_shard", "expert_tensor_parallel"}
    for f in dataclasses.fields(r):
        if f.name in ported:
            assert getattr(t, f.name) == getattr(r, f.name), f.name
        else:
            assert f.name in left_out, f.name
    for prop in ("num_superblocks", "vocab_padded", "has_decode",
                 "is_encoder_only"):
        assert getattr(t, prop) == getattr(r, prop), prop


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_and_counts_match_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    want = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), rcfg))
    got = TM.init_params(None, tcfg, device="meta")
    assert _shapes(got) == _shapes(want)
    assert [tuple(x.shape) for x in tree_leaves(got)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(want)]
    assert TM.count_params(tcfg) == RM.count_params(rcfg) == \
        (COUNTS[arch], COUNTS[arch])


@pytest.mark.parametrize("arch", SMOKES)
def test_init_law(arch):
    """The frontend leaves: ``proj`` / ``in_proj`` at the fan-in law, the
    ``cls`` head's pad columns zero; layernorm's scale 1 and bias 0 in every
    norm of the audio stack, rmsnorm's scale alone in the vision one."""
    cfg = dataclasses.replace(tget(arch), vocab_size=500)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    D = cfg.d_model
    std = 1.0 / np.sqrt(D)
    w = p["in_proj" if cfg.frontend == "audio" else "proj"]
    assert w.shape == (D, D)
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.8796) < 0.03
    norms = [p["final_norm"], p["blocks"]["p0"]["norm1"],
             p["blocks"]["p0"]["norm2"]]
    if cfg.frontend == "audio":
        assert set(p) == {"blocks", "final_norm", "in_proj", "cls"}
        assert p["cls"].shape == (D, 512)
        assert bool((p["cls"][:, 500:] == 0).all())
        assert float(p["cls"][:, :500].abs().max()) <= 2 * std + 1e-7
        for n in norms:
            assert set(n) == {"scale", "bias"}
            assert bool((n["scale"] == 1).all()) and bool((n["bias"] == 0).all())
    else:
        assert set(p) == {"blocks", "final_norm", "embed", "proj"}
        assert all(set(n) == {"scale"} for n in norms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Population variance (``jnp.var``), f32 math, the input's dtype out;
    an offset mean keeps the mean's subtraction honest."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 2.0 + 3.0).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = RL.layernorm({"scale": jnp.asarray(scale, jdt),
                         "bias": jnp.asarray(bias, jdt)},
                        jnp.asarray(x, jdt), 1e-5)
    tdt = getattr(torch, dtype)
    got = TL.layernorm({"scale": torch.from_numpy(scale).to(tdt),
                        "bias": torch.from_numpy(bias).to(tdt)},
                       torch.from_numpy(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_tn(got), np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-5 if dtype == "float32" else 1e-2)


def _close_tree(got, want, tol=1e-4):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(_tn(g) - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("arch,patches", [(VLM, True), (VLM, False),
                                          (AUDIO, True)])
def test_loss_and_grads_match_reference(arch, patches):
    """The vision loss with patches (their positions unlabelled) and
    without; the audio loss per frame with no shift."""
    rcfg, tcfg = rget(arch), tget(arch)
    rp = _ref_init(rcfg, 1)
    batch = _batch(rcfg, 3, 10, 2, patches)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_l, want_g = jax.value_and_grad(
        lambda p: RM.loss_fn(p, jb, rcfg, R))(rp)
    p = params_from_numpy(rp)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = TM.loss_fn(p, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    if not patches:         # proj is unused: jax.grad gives it zeros
        assert [x is p["proj"] for x in leaves] == [g is None for g in grads]
    grads = tree_unflatten_like(p, [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, grads)])
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    _close_tree(grads, want_g)


@pytest.mark.parametrize("arch", SMOKES)
def test_forward_logits_and_encode_match_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    rp = _ref_init(rcfg, 3)
    tp = params_from_numpy(rp)
    batch = _batch(rcfg, 2, 9, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = TM.forward_logits(tp, tb, tcfg)
        np.testing.assert_allclose(_tn(got), np.asarray(
            RM.forward_logits(rp, jb, rcfg, R)), **TOL)
        P = rcfg.num_prefix_tokens if rcfg.frontend == "vision" else 0
        assert got.shape == (2, P + 9, rcfg.vocab_padded)
        if rcfg.frontend == "audio":
            enc = TM.encode(tp, tb, tcfg)
            np.testing.assert_allclose(_tn(enc), np.asarray(
                RM.encode(rp, jb, rcfg, R)), **TOL)
            assert torch.equal(enc, got)


def test_prefill_with_patches_and_decode_match_reference():
    """The prefill runs over P patches and S tokens at positions 0 .. P + S
    - 1; four decode steps go on from position P + S; logits and caches
    within 1e-4 at every step, the same greedy tokens."""
    rcfg, tcfg = rget(VLM), tget(VLM)
    rp = _ref_init(rcfg, 1)
    tp = params_from_numpy(rp)
    batch = _batch(rcfg, 2, 7, 6)
    P, S, n = rcfg.num_prefix_tokens, 7, 4
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    tb = {k: v for k, v in _torch_batch(batch).items() if k != "labels"}
    rcache, rlog = RM.prefill(rp, jb, rcfg, R, max_len=P + S + n)
    with torch.no_grad():
        tcache, tlog = TM.prefill(tp, tb, tcfg, max_len=P + S + n)
    assert tcache["p0"]["k"].shape[2] == P + S + n
    np.testing.assert_allclose(_tn(tlog), np.asarray(rlog), **TOL)
    for g, w in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(rcache)):
        np.testing.assert_allclose(_tn(g), np.asarray(w, np.float32), **TOL)
    rtok = jnp.argmax(rlog, -1)[:, None]
    ttok = torch.argmax(tlog, -1)[:, None]
    for i in range(n):
        assert np.array_equal(ttok.numpy(), np.asarray(rtok))
        rcache, rlog = RM.decode_step(rp, rcache, rtok, jnp.int32(P + S + i),
                                      rcfg, R)
        with torch.no_grad():
            tcache, tlog = TM.decode_step(tp, tcache, ttok, P + S + i, tcfg)
        np.testing.assert_allclose(_tn(tlog), np.asarray(rlog), **TOL)
        rtok = jnp.argmax(rlog[:, 0], -1)[:, None]
        ttok = torch.argmax(tlog[:, 0], -1)[:, None]
    assert np.array_equal(ttok.numpy(), np.asarray(rtok))


def test_serve_cli_vision_on_cpu(capsys):
    """``serve.main`` on ``internvl2-1b-smoke``: patches drawn from the
    run's generator, the cache sized for P + prompt + gen."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", VLM, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3"])
    assert res["tokens"].shape == (2, 3) and res["decode_steps"] == 2
    assert int(res["tokens"].max()) < tget(VLM).vocab_size
    assert f"[serve] {VLM} on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("what", ["init_cache", "prefill", "decode_step",
                                  "serve", "members"])
def test_encoder_only_and_member_paths_raise(what):
    """hubert is encoder-only: no cache, prefill, decode step or serve run
    (the reference asserts ``has_decode``); the member-batched path has no
    frontend."""
    cfg = tget(AUDIO)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _torch_batch(_batch(cfg, 2, 4, 0))
    if what == "members":
        vcfg = tget(VLM)
        vp = TM.init_params(torch.Generator().manual_seed(0), vcfg)
        vb = _torch_batch(_batch(vcfg, 2, 4, 0))
        mp = {k: v[None] for k, v in vb.items()}
        with pytest.raises(ValueError, match="member-batched"):
            TM.loss_fn({k: v for k, v in vp.items()}, mp, vcfg, members=True)
        return
    with pytest.raises(ValueError, match="encoder-only"):
        if what == "init_cache":
            TM.init_cache(cfg, 2, 8)
        elif what == "prefill":
            TM.prefill(p, batch, cfg)
        elif what == "decode_step":
            TM.decode_step(p, {}, torch.zeros((2, 1), dtype=torch.long), 4,
                           cfg)
        else:
            from repro_torch.launch import serve
            serve.main(["--arch", AUDIO, "--device", "cpu"])
