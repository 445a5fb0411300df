"""The port's mixture-of-experts layer against the JAX reference, on the CPU.

``moe_forward`` (group-local capacity dispatch) and ``moe_forward_dense``
(the dropless oracle) on the reference's init (converted with
``convert.params_from_numpy``) and numpy inputs from a seed: at lossless
and shipped capacity and at one that drops most choices, with
``dispatch_groups`` 1 and > 1, with and without shared experts, with
qwen's renormalisation (by name) and without; outputs and the Switch aux
loss within rtol/atol 1e-5 (f32), gradients within rtol 1e-4. Every
choice gets the same expert, queue position and keep bit on both sides,
ties of the router probabilities included (``jax.lax.top_k`` puts the lower
expert first; so does the port's stable sort). With a member axis (the
reference under ``jax.vmap``) in both member-math modes. The reference's
own invariants (``tests/test_moe.py``) hold on the port: dispatch equals
the oracle at lossless capacity, dropping lowers the output energy, the aux
loss's bounds and the assigned configs' capacities.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import moe as RMoE
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import member_math
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ModelConfig as TConfig
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(E=4, K=2, cf=10.0, shared=0, name="test-moe", groups=1):
    kw = dict(name=name, family="moe", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=4, d_ff=0, vocab_size=64, block_pattern=("attn",),
              ffn_pattern=("moe",), num_experts=E, top_k=K, moe_d_ff=16,
              capacity_factor=cf, num_shared_experts=shared,
              shared_d_ff=48 if shared else 0, dispatch_groups=groups,
              dtype="float32", param_dtype="float32", remat="none")
    return RConfig(**kw), TConfig(**kw)


def _params(rcfg, seed, members=0):
    if members:
        keys = jax.random.split(jax.random.PRNGKey(seed), members)
        p = jax.vmap(lambda k: RMoE.init_moe(k, rcfg))(keys)
    else:
        p = RMoE.init_moe(jax.random.PRNGKey(seed), rcfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    # a router with the init's 0.02 scale barely separates the experts
    p["router"] = p["router"] * 50.0
    return p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _tn(x):
    return x.detach().float().numpy()


def _ref_plan(params, x, cfg):
    """The reference's routing, in its own ops (``moe.py:60-102``): each
    choice's expert, queue position and keep bit, per group."""
    B, S, D = x.shape
    E, K, T = cfg.num_experts, cfg.top_k, B * S
    G = max(cfg.dispatch_groups, 1)
    G = 1 if T % G else G
    C = RMoE.moe_capacity(cfg, T // G)
    xt = jnp.asarray(x).reshape(G, T // G, D)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt, params["router"]),
                           axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    choice_e = top_e.reshape(G, -1)
    oh = jax.nn.one_hot(choice_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - 1) * oh, axis=-1)
    return np.asarray(choice_e), np.asarray(pos), np.asarray(pos < C)


def _port_plan(tp, x, tcfg):
    B, S, D = x.shape
    G, Tg, C = TMoE._groups(tcfg, B * S)
    _, top_p, top_e = TMoE._route(tp, torch.from_numpy(x).reshape(G, Tg, D),
                                  tcfg, False)
    plan = TMoE.dispatch_plan(top_p, top_e, tcfg, C)
    return (plan["expert"].numpy(), plan["pos"].numpy(),
            plan["keep"].numpy())


# (E, K, capacity factor, shared experts, qwen name, dispatch groups)
CASES = [
    (4, 2, 2.0, 0, False, 1),       # lossless (cf = E/k)
    (4, 2, 1.25, 1, True, 2),       # shipped capacity, shared, qwen, groups
    (6, 4, 1.25, 2, True, 1),
    (8, 2, 0.1, 0, False, 2),       # drops most choices
    (4, 1, 4.0, 1, False, 4),
    (8, 2, 0.5, 0, True, 4),
]
IDS = [f"E{e}k{k}cf{cf}s{s}{'q' if q else ''}G{g}"
       for e, k, cf, s, q, g in CASES]


@pytest.mark.parametrize("E,K,cf,shared,qwen,G", CASES, ids=IDS)
def test_moe_matches_reference(E, K, cf, shared, qwen, G):
    rcfg, tcfg = _cfgs(E, K, cf, shared, "qwen2-moe-test" if qwen
                       else "test-moe", G)
    rp = _params(rcfg, seed=E + K)
    tp = params_from_numpy(rp)
    x = _x((2, 16, rcfg.d_model), seed=E * 10 + G)
    for rf, tf in ((RMoE.moe_forward, TMoE.moe_forward),
                   (RMoE.moe_forward_dense, TMoE.moe_forward_dense)):
        ry, raux = rf(rp, jnp.asarray(x), rcfg, R)
        ty, taux = tf(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(_tn(ty), np.asarray(ry), **TOL)
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)
    for got, want in zip(_port_plan(tp, x, tcfg), _ref_plan(rp, x, rcfg)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,K,cf,shared,qwen,G", CASES[1:4], ids=IDS[1:4])
def test_moe_gradient_matches_reference(E, K, cf, shared, qwen, G):
    """Gradients of sum(y * ct) + aux to the parameters and x, through the
    dispatch's gathers and their inverse maps."""
    rcfg, tcfg = _cfgs(E, K, cf, shared, "qwen2-moe-test" if qwen
                       else "test-moe", G)
    rp = _params(rcfg, seed=3)
    x = _x((2, 12, rcfg.d_model), seed=4)
    ct = _x((2, 12, rcfg.d_model), seed=5)

    def rloss(p, xx):
        y, aux = RMoE.moe_forward(p, xx, rcfg, R)
        return jnp.sum(y * ct) + aux

    rg = jax.grad(rloss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v for k, v in params_from_numpy(rp).items()
              if not isinstance(v, dict)}
    tp = dict(params_from_numpy(rp))
    names = sorted(leaves)
    req = [leaves[k].requires_grad_(True) for k in names]
    for k, t in zip(names, req):
        tp[k] = t
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMoE.moe_forward(tp, tx, tcfg)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)) + aux,
                                req + [tx])
    for k, g in zip(names + ["x"], grads):
        want = np.asarray(rg[1] if k == "x" else rg[0][k])
        np.testing.assert_allclose(_tn(g), want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("tie", ["all", "pair"])
@pytest.mark.parametrize("G", [1, 2])
def test_router_ties_pick_the_references_expert_and_slot(tie, G):
    """Exact ties of the router probabilities: a zero router (every expert
    ties, so every token picks experts 0..k-1 and the queues overflow) or
    two zero columns (experts 1 and 3 tie on every token). Each choice's
    expert, position and keep bit equal the reference's, and so do the
    outputs."""
    rcfg, tcfg = _cfgs(E=6, K=2, cf=0.5, groups=G)
    rp = _params(rcfg, seed=7)
    if tie == "all":
        rp["router"] = np.zeros_like(rp["router"])
    else:
        rp["router"][:, [1, 3]] = 0.0
        rp["router"][:, [0, 2, 4, 5]] -= 5.0 * np.abs(
            rp["router"][:, [0, 2, 4, 5]]).max()
    tp = params_from_numpy(rp)
    x = np.abs(_x((2, 8, rcfg.d_model), seed=8))
    rplan, tplan = _ref_plan(rp, x, rcfg), _port_plan(tp, x, tcfg)
    assert not rplan[2].all()                   # some choices drop
    if tie == "all":
        assert (rplan[0].reshape(-1, 2) == [0, 1]).all()
    else:
        assert set(np.unique(rplan[0])) >= {1, 3}
    for got, want in zip(tplan, rplan):
        np.testing.assert_array_equal(got, want)
    ry, _ = RMoE.moe_forward(rp, jnp.asarray(x), rcfg, R)
    ty, _ = TMoE.moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_tn(ty), np.asarray(ry), **TOL)


def test_top_k_order_is_jax_top_k():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4.0   # many ties
    tv, ti = TMoE.top_k(torch.from_numpy(p), 5)
    rv, ri = jax.lax.top_k(jnp.asarray(p), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("mode", ["vmap", "grouped"])
@pytest.mark.parametrize("cf,G", [(2.0, 1), (0.75, 2)])
def test_moe_with_member_axis_matches_reference(cf, G, mode):
    rcfg, tcfg = _cfgs(E=4, K=2, cf=cf, shared=1, groups=G)
    B = 3
    rp = _params(rcfg, seed=9, members=B)
    tp = params_from_numpy(rp)
    x = _x((B, 2, 8, rcfg.d_model), seed=10)
    for rf, tf in ((RMoE.moe_forward, TMoE.moe_forward),
                   (RMoE.moe_forward_dense, TMoE.moe_forward_dense)):
        ry, raux = jax.vmap(lambda p, xx: rf(p, xx, rcfg, R))(
            rp, jnp.asarray(x))
        with member_math.routing(mode):
            ty, taux = tf(tp, torch.from_numpy(x), tcfg, members=True)
        assert taux.shape == (B,)
        np.testing.assert_allclose(_tn(ty), np.asarray(ry), **TOL)
        np.testing.assert_allclose(_tn(taux), np.asarray(raux), rtol=1e-5)


@pytest.mark.parametrize("E,K,shared", [(4, 2, 0), (8, 2, 0), (4, 1, 1),
                                        (6, 4, 2)])
def test_dispatch_equals_dropless_with_lossless_capacity(E, K, shared):
    _, cfg = _cfgs(E=E, K=K, cf=float(E) / K, shared=shared)
    p = params_from_numpy(_params(_cfgs(E=E, K=K, shared=shared)[0], 0))
    x = torch.from_numpy(_x((2, 8, cfg.d_model), seed=1))
    y1, aux1 = TMoE.moe_forward(p, x, cfg)
    y2, aux2 = TMoE.moe_forward_dense(p, x, cfg)
    np.testing.assert_allclose(_tn(y1), _tn(y2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)


def test_capacity_drops_tokens_and_aux_bounds():
    rcfg, cfg = _cfgs(E=4, K=2, cf=0.1)
    p = params_from_numpy(_params(rcfg, 1))
    x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=2))
    y1, _ = TMoE.moe_forward(p, x, cfg)
    y2, _ = TMoE.moe_forward_dense(p, x, cfg)
    assert float(torch.sum(y1 ** 2)) < float(torch.sum(y2 ** 2))
    rcfg, cfg = _cfgs(E=8, K=2)
    p = params_from_numpy(_params(rcfg, 2))
    _, aux = TMoE.moe_forward_dense(
        p, torch.from_numpy(_x((4, 64, cfg.d_model), seed=3)), cfg)
    coef = cfg.router_aux_coef
    assert coef * cfg.top_k * 0.5 <= float(aux) < coef * cfg.top_k * 8


def test_assigned_moe_configs_capacity():
    for arch in ("qwen2-moe-a2.7b", "arctic-480b", "jamba-v0.1-52b"):
        cfg, r = tget(arch), rget(arch)
        for n in (8, 1024):
            assert TMoE.moe_capacity(cfg, n) == RMoE.moe_capacity(r, n)
        assert TMoE.moe_capacity(cfg, 1024) * cfg.num_experts \
            >= cfg.top_k * 1024
        assert cfg.dispatch_groups == r.dispatch_groups == 16
    # qwen2-moe at serve: a decode step's 8 tokens are one group with one
    # slot an expert; the prefill's 16,384 are 16 groups of 86 slots
    q = tget("qwen2-moe-a2.7b")
    assert TMoE._groups(q, 8) == (1, 8, 1)
    assert TMoE._groups(q, 16_384) == (16, 1024, 86)
    lossless = dataclasses.replace(q, capacity_factor=60 / 4)
    assert TMoE._groups(lossless, 16_384)[2] == 1024
    # the smoke rule: <= 4 experts, top-k <= 2, lossless capacity
    s = tget("qwen2-moe-a2.7b-smoke")
    assert (s.num_experts, s.top_k, s.capacity_factor) == (4, 2, 2.0)
    assert s == dataclasses.replace(
        s, **{f.name: getattr(rget("qwen2-moe-a2.7b-smoke"), f.name)
              for f in dataclasses.fields(s)})
