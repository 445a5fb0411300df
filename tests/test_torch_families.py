"""The recurrent, MoE and hybrid LMs of the port against the JAX reference,
on the CPU: configs, parameter trees and counts, prefill and decode.

``xlstm-350m`` (ssm: mLSTM and sLSTM, no FFN), ``qwen2-moe-a2.7b`` (moe:
60 routed top-4 with qwen's renormalisation and shared experts),
``jamba-v0.1-52b`` (hybrid: mamba and attention with dense and MoE FFNs)
and ``arctic-480b`` (moe+dense), and the fed-lm scenarios. At full size the
port's init runs on the meta device and the reference's is
``jax.eval_shape``: the trees' shapes and dtypes and ``count_params``
(total and active) are equal. At smoke size, on the reference's init
(converted), the prefill logits and every layer's filled cache, then four
decode steps' logits and caches, within rtol/atol 1e-4 (f32 multi-step
logits); and the port's decode against its own prefill of one more token,
as the reference's ``tests/test_arch_smoke.py`` checks. The loss and its
gradients under each remat are in ``tests/test_torch_families_grad.py``.
"""
import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.common.tree import FlatSpec, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["xlstm-350m", "qwen2-moe-a2.7b", "jamba-v0.1-52b", "arctic-480b"]
SMOKES = [a + "-smoke" for a in ARCHS]
TOL = dict(rtol=1e-4, atol=1e-4)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _tn(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCHS + SMOKES + ["fed-lm-ssm-smoke",
                                                   "fed-lm-moe-smoke"])
def test_config_fields_match_reference(arch):
    r, t = rget(arch), tget(arch)
    ported = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(r):
        if f.name in ported:
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for name in ("num_experts", "top_k", "num_shared_experts", "moe_d_ff",
                 "shared_d_ff", "capacity_factor", "router_aux_coef",
                 "dispatch_groups", "ssm_expand", "ssm_state_dim",
                 "conv_kernel", "dt_rank", "mlstm_proj_factor",
                 "slstm_ffn_factor"):
        assert name in ported, name
    for prop in ("num_superblocks", "vocab_padded", "dt_rank_actual",
                 "ssm_inner", "slstm_ffn_dim"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.for_long_context().sliding_window == \
        r.for_long_context().sliding_window


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_and_counts_match_reference(arch):
    """Shapes and dtypes of every leaf, the FlatSpec order (jax.tree_util's
    sorted keys), and (total, active) parameter counts."""
    rcfg, tcfg = rget(arch), tget(arch)
    want = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), rcfg))
    got = TM.init_params(None, tcfg, device="meta")
    assert _shapes(got) == _shapes(want)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    spec = FlatSpec(got)
    assert [tuple(leaf.shape) for leaf in tree_leaves(got)] == \
        [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(want)]
    assert len(paths) == len(spec.sizes)
    assert TM.count_params(tcfg) == RM.count_params(rcfg)


def test_every_assigned_arch_resolves_but_the_frontends():
    """``configs.get_config`` resolves every assigned architecture of the
    reference and its ``-smoke`` variant; the two frontends raise, naming
    ROADMAP.md Queue 1 item 10c."""
    from repro.configs import ASSIGNED
    frontends = {"internvl2-1b", "hubert-xlarge"}
    assert frontends < set(ASSIGNED)
    for arch in ASSIGNED:
        for a in (arch, arch + "-smoke"):
            if arch in frontends:
                with pytest.raises(NotImplementedError, match="item 10c"):
                    tget(a)
            else:
                assert tget(a) == dataclasses.replace(
                    tget(a), **{f.name: getattr(rget(a), f.name)
                                for f in dataclasses.fields(tget(a))})


def test_full_size_counts():
    """The assigned sizes (the reference's eval_shape counts)."""
    total, active = TM.count_params(tget("qwen2-moe-a2.7b"))
    assert 14.0e9 < total < 14.6e9 and 2.5e9 < active < 3.0e9
    total, _ = TM.count_params(tget("xlstm-350m"))
    assert 0.4e9 < total < 0.6e9
    total, active = TM.count_params(tget("arctic-480b"))
    assert 4.5e11 < total < 5.0e11 and active < 0.1 * total


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b-smoke", "xlstm-350m-smoke",
                                  "arctic-480b-smoke"])
def test_convert_keeps_dtypes_and_flat_order(arch):
    """A bf16 reference tree converts leaf for leaf (mamba's a_log and
    d_skip stay float32), and the port's flat vector is the reference's
    ``ravel_pytree`` order."""
    rcfg = dataclasses.replace(rget(arch), param_dtype="bfloat16")
    rp = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), rcfg))
    tp = params_from_numpy(rp)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(rp)[0],
                            tree_leaves(tp)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        np.testing.assert_array_equal(_tn(g), np.asarray(w, np.float32))
    flat, _ = jax.flatten_util.ravel_pytree(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), rp))
    np.testing.assert_array_equal(FlatSpec(tp).flatten(tp).float().numpy(),
                                  np.asarray(flat))


def _ref_init(rcfg, seed):
    p = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _close_cache(got, want):
    gl = tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_tn(g), w, **TOL)


@pytest.mark.parametrize("arch", SMOKES)
def test_prefill_and_decode_match_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    rp = _ref_init(rcfg, 1)
    tp = params_from_numpy(rp)
    B, S, n = 2, 12, 4
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size,
                                             (B, S + n)).astype(np.int32)
    rcache, rlog = RM.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, rcfg,
                              R, max_len=S + n)
    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        tcache, tlog = TM.prefill(tp, {"tokens": tt[:, :S]}, tcfg,
                                  max_len=S + n)
    np.testing.assert_allclose(_tn(tlog), np.asarray(rlog), **TOL)
    _close_cache(tcache, rcache)
    for i in range(n):
        rcache, rlog = RM.decode_step(rp, rcache, jnp.asarray(
            toks[:, S + i:S + i + 1]), jnp.int32(S + i), rcfg, R)
        with torch.no_grad():
            tcache, tlog = TM.decode_step(tp, tcache, tt[:, S + i:S + i + 1],
                                          S + i, tcfg)
        np.testing.assert_allclose(_tn(tlog), np.asarray(rlog), **TOL)
        _close_cache(tcache, rcache)
    # decode at position S + n - 1 against the last logits of a prefill of
    # S + n tokens (the reference's tests/test_arch_smoke.py check)
    with torch.no_grad():
        _, full = TM.prefill(tp, {"tokens": tt}, tcfg)
    np.testing.assert_allclose(_tn(tlog[:, 0]), _tn(full), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["xlstm-350m-smoke", "jamba-v0.1-52b-smoke"])
def test_cache_layout(arch):
    """Recurrent positions carry their float32 states, stacked over the
    superblocks; attention positions their KV caches."""
    cfg = tget(arch)
    cache = TM.init_cache(cfg, 3, 10)
    nsb = cfg.num_superblocks
    for i, mix in enumerate(cfg.block_pattern):
        c = cache[f"p{i}"]
        assert all(v.shape[:2] == (nsb, 3) for v in c.values())
        if mix == "attn":
            assert set(c) == {"k", "v"}
        else:
            keys = {"mamba": {"h", "conv"}, "mlstm": {"C", "n", "m"},
                    "slstm": {"c", "n", "m", "h"}}[mix]
            assert set(c) == keys
            assert c["h" if mix != "mlstm" else "C"].dtype == torch.float32
            assert float(c.get("m", torch.zeros(1)).max()) in (
                0.0, float(np.float32(-1e30)))


def test_serve_cli_default_is_xlstm_smoke(capsys):
    """The serve CLI's default arch is the reference's, xlstm-350m-smoke,
    end to end on the CPU."""
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
                      "--gen", "3"])
    assert res["tokens"].shape == (2, 3) and res["decode_steps"] == 2
    out = capsys.readouterr().out
    assert "[serve] xlstm-350m-smoke on cpu" in out
