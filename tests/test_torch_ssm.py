"""The port's recurrent mixers (mamba, mLSTM, sLSTM) against the JAX
reference, on the CPU.

Parameters are the reference's init converted with
``convert.params_from_numpy``; inputs are made with numpy from a seed and
handed to both sides. Widths are the smoke configs': mamba from
``jamba-v0.1-52b-smoke`` (d_model 256, inner 512, state 16), mLSTM and sLSTM
from ``xlstm-350m-smoke`` (d_model 256, 4 heads). Each mixer's
``*_forward``, ``*_fill_state`` (output and state) and four ``*_decode``
steps after a fill, over 8 to 32 steps, within rtol/atol 1e-5 (f32, the
same arithmetic in a different summation order): without a member axis,
and with one (the reference under ``jax.vmap``, the port's member axis
explicit) in both member-math modes, where under ``"grouped"`` the
reference's ``member_dot`` sites go through ``grouped_matmul``'s plain
version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import ssm as RS
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import member_math
from repro_torch.models import ssm as TS
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = {"mamba": "jamba-v0.1-52b-smoke", "mlstm": "xlstm-350m-smoke",
        "slstm": "xlstm-350m-smoke"}
# member_dot sites a forward of each mixer runs
SITES = {"mamba": 2, "mlstm": 6, "slstm": 3}


def _cfgs(kind):
    return rget(ARCH[kind]), tget(ARCH[kind])


def _np(x):
    return np.asarray(x, np.float32)


def _tn(x):
    return x.detach().float().numpy()


def _ref_params(kind, rcfg, seed, members=0):
    init = getattr(RS, f"init_{kind}")
    if members:
        keys = jax.random.split(jax.random.PRNGKey(seed), members)
        p = jax.vmap(lambda k: init(k, rcfg))(keys)
    else:
        p = init(jax.random.PRNGKey(seed), rcfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    if kind == "slstm":     # a nonzero bias reaches the gates
        p["bias"] = np.random.default_rng(seed).normal(
            0, 0.5, p["bias"].shape).astype(np.float32)
    return p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(_tn(got), _np(want), err_msg=what, **TOL)


def _close_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], k)


def test_config_properties_match_reference():
    for arch in ("xlstm-350m", "jamba-v0.1-52b", "fed-lm-ssm-smoke",
                 "xlstm-350m-smoke", "jamba-v0.1-52b-smoke"):
        r, t = rget(arch), tget(arch)
        for prop in ("dt_rank_actual", "ssm_inner", "slstm_ffn_dim"):
            assert getattr(t, prop) == getattr(r, prop), (arch, prop)
    assert tget("xlstm-350m").slstm_ffn_dim == 1408      # 1365 -> 11 x 128


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_shapes_and_law_match_reference(kind):
    rcfg, tcfg = _cfgs(kind)
    want = jax.eval_shape(
        lambda: getattr(RS, f"init_{kind}")(jax.random.PRNGKey(0), rcfg))
    got = getattr(TS, f"init_{kind}")(torch.Generator().manual_seed(0), tcfg,
                                      "cpu", lead=(3,))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == (3,) + tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    ref = _ref_params(kind, rcfg, 0)
    if kind == "mamba":
        # log(1..N) per row (torch's log and XLA's may differ by an ulp)
        np.testing.assert_allclose(_tn(got["a_log"][1]), ref["a_log"],
                                   rtol=1e-6, atol=0)
        dt = np.log1p(np.exp(_tn(got["dt_proj_b"])))    # softplus
        assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    if kind == "mlstm":
        np.testing.assert_array_equal(_tn(got["b_if"][2]), ref["b_if"])
    meta = getattr(TS, f"init_{kind}")(None, tcfg, "meta", lead=(2,))
    assert all(v.device.type == "meta" for v in meta.values())


def _ref_fns(kind, rcfg):
    fwd = lambda p, x: getattr(RS, f"{kind}_forward")(p, x, rcfg, R)
    fill = lambda p, x: getattr(RS, f"{kind}_fill_state")(p, x, rcfg, R)
    dec = lambda p, s, x: getattr(RS, f"{kind}_decode")(p, s, x, rcfg)
    return fwd, fill, dec


@pytest.mark.parametrize("kind,S", [("mamba", 24), ("mlstm", 16),
                                    ("slstm", 12)])
def test_mixer_matches_reference(kind, S):
    rcfg, tcfg = _cfgs(kind)
    rp = _ref_params(kind, rcfg, seed=1)
    tp = params_from_numpy(rp)
    x = _x((2, S, rcfg.d_model), seed=2)
    fwd, fill, dec = _ref_fns(kind, rcfg)
    _close(getattr(TS, f"{kind}_forward")(tp, torch.from_numpy(x), tcfg),
           fwd(rp, jnp.asarray(x)), "forward")
    rstate, ry = fill(rp, jnp.asarray(x))
    tstate, ty = getattr(TS, f"{kind}_fill_state")(tp, torch.from_numpy(x),
                                                   tcfg)
    _close(ty, ry, "fill output")
    _close_tree(tstate, rstate)
    # four decode steps after the fill
    for i in range(4):
        xt = _x((2, 1, rcfg.d_model), seed=10 + i)
        rstate, ry = dec(rp, rstate, jnp.asarray(xt))
        tstate, ty = getattr(TS, f"{kind}_decode")(tp, tstate,
                                                   torch.from_numpy(xt), tcfg)
        _close(ty, ry, f"decode {i}")
        _close_tree(tstate, rstate)


@pytest.mark.parametrize("mode", ["vmap", "grouped"])
@pytest.mark.parametrize("kind,S", [("mamba", 8), ("mlstm", 10),
                                    ("slstm", 8)])
def test_mixer_with_member_axis_matches_reference(kind, S, mode,
                                                 monkeypatch):
    """Three members, each with its own parameters and its own rows (the
    reference under ``jax.vmap``); under ``"grouped"`` every member_dot site
    is one ``grouped_matmul`` call (counted here: on the CPU the wrapper
    runs its plain version and counts no launch)."""
    calls = []
    plain = member_math.grouped_matmul
    monkeypatch.setattr(member_math, "grouped_matmul",
                        lambda *a: calls.append(1) or plain(*a))
    rcfg, tcfg = _cfgs(kind)
    B = 3
    rp = _ref_params(kind, rcfg, seed=3, members=B)
    tp = params_from_numpy(rp)
    x = _x((B, 2, S, rcfg.d_model), seed=4)
    fwd, fill, dec = _ref_fns(kind, rcfg)
    rstate, ry = jax.vmap(fill)(rp, jnp.asarray(x))
    with member_math.routing(mode):
        ty = getattr(TS, f"{kind}_forward")(tp, torch.from_numpy(x), tcfg,
                                            members=True)
        tstate, ty2 = getattr(TS, f"{kind}_fill_state")(
            tp, torch.from_numpy(x), tcfg, members=True)
    want = 2 * SITES[kind] if mode == "grouped" else 0
    assert len(calls) == want
    _close(ty, ry, "forward")
    _close(ty2, ry, "fill output")
    _close_tree(tstate, rstate)
    for i in range(4):
        xt = _x((B, 2, 1, rcfg.d_model), seed=20 + i)
        rstate, ry = jax.vmap(dec)(rp, rstate, jnp.asarray(xt))
        with member_math.routing(mode):
            tstate, ty = getattr(TS, f"{kind}_decode")(
                tp, tstate, torch.from_numpy(xt), tcfg, members=True)
        _close(ty, ry, f"decode {i}")
        _close_tree(tstate, rstate)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_gradient_matches_reference(kind):
    """d(sum of the output times a fixed cotangent) / d(params, x)."""
    rcfg, tcfg = _cfgs(kind)
    rp = _ref_params(kind, rcfg, seed=5)
    x = _x((2, 8, rcfg.d_model), seed=6)
    ct = _x((2, 8, rcfg.d_model), seed=7)
    fwd, _, _ = _ref_fns(kind, rcfg)
    rg = jax.grad(lambda p, xx: jnp.sum(fwd(p, xx) * ct), argnums=(0, 1))(
        rp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(rp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = getattr(TS, f"{kind}_forward")(tp, tx, tcfg)
    names = sorted(tp)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)),
                                [tp[k] for k in names] + [tx])
    for k, g in zip(names, grads[:-1]):
        scale = max(1.0, float(np.abs(rg[0][k]).max()))
        np.testing.assert_allclose(_tn(g), _np(rg[0][k]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    np.testing.assert_allclose(_tn(grads[-1]), _np(rg[1]), rtol=1e-4,
                               atol=1e-5)


def test_slstm_state_is_per_element_and_m0_is_float32():
    _, tcfg = _cfgs("slstm")
    st = TS.init_slstm_state(tcfg, 2, "cpu")
    H, hd = tcfg.num_heads, tcfg.d_model // tcfg.num_heads
    assert all(v.shape == (2, H, hd) and v.dtype == torch.float32
               for v in st.values())
    assert float(st["m"].max()) == float(np.float32(-1e30))
    mst = TS.init_mlstm_state(dataclasses.replace(tcfg), 2, "cpu", lead=(3,))
    assert mst["m"].shape == (3, 2, H) and mst["m"].dtype == torch.float32
    assert mst["C"].shape[-2:] == (2 * tcfg.d_model // H,) * 2
