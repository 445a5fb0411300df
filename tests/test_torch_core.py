"""The port's FedPSA core (``repro_torch.core``) against the JAX reference
(``repro.core``), mirroring ``tests/test_core_psa.py``: the same numpy
inputs go to both sides, and trajectories agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.core import psa as rpsa
from repro.core.sensitivity import (fisher_diagonal as r_fisher,
                                   sensitivity as r_sensitivity)
from repro.core import sketch as rsk
from repro.core import aggregation as ragg
from repro.core import thermometer as rthermo
from repro.models import model as RM
from repro_torch.common.tree import FlatSpec, tree_leaves, tree_map
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import psa as tpsa
from repro_torch.core import sensitivity as tsens
from repro_torch.core import sketch as tsk
from repro_torch.core import thermometer as tthermo
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401


def _mlp_world(seed=0):
    rcfg, tcfg = rget("paper-synthetic-mlp"), tget("paper-synthetic-mlp")
    rp = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp))
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randint(0, 10, size=64).astype(np.int32)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    rloss = lambda p, b: RM.loss_fn(p, b, rcfg, None)  # noqa: E731
    tloss = lambda p, b: TM.loss_fn(p, b, tcfg)  # noqa: E731
    return rp, tp, rb, tb, rloss, tloss


def _close_trees(t, r, rtol=1e-5, atol=1e-7):
    for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def test_fisher_and_sensitivity_match_reference():
    rp, tp, rb, tb, rloss, tloss = _mlp_world()
    _close_trees(tsens.fisher_diagonal(tloss, tp, tb, 4),
                 r_fisher(rloss, rp, rb, 4), atol=1e-9)
    _close_trees(tsens.sensitivity(tloss, tp, tb, 4),
                 r_sensitivity(rloss, rp, rb, 4), atol=1e-8)
    with pytest.raises(ValueError):
        tsens.fisher_diagonal(tloss, tp, {k: v[:6] for k, v in tb.items()}, 4)


def test_flat_grad_and_fisher_match_reference():
    """``grad_and_fisher`` on flat rows — one model, and a 3-member stack
    whose loss returns per-member losses — against the reference's
    ``jax.grad`` and ``fisher_diagonal`` of each member (gradient rtol 1e-5
    atol 1e-7, Fisher atol 1e-9, as above)."""
    rp, tp, rb, tb, rloss, tloss = _mlp_world(2)
    spec = FlatSpec(tp)

    def flat(tree):
        return np.concatenate([np.asarray(x).reshape(-1)
                               for x in jax.tree_util.tree_leaves(tree)])

    g, f = tsens.grad_and_fisher(tloss, spec, spec.flatten(tp), tb, 4)
    assert g.shape == f.shape == (spec.size,)
    np.testing.assert_allclose(g.numpy(), flat(jax.grad(rloss)(rp, rb)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(f.numpy(), flat(r_fisher(rloss, rp, rb, 4)),
                               rtol=1e-5, atol=1e-9)
    rng = np.random.RandomState(4)
    w = np.stack([flat(rp) + 0.1 * i * rng.randn(spec.size).astype(np.float32)
                  for i in range(3)]).astype(np.float32)

    def member_losses(params, batch):
        return torch.stack([tloss(tree_map(lambda x: x[i], params), batch)
                            for i in range(w.shape[0])])

    g, f = tsens.grad_and_fisher(member_losses, spec, torch.from_numpy(w), tb, 4)
    assert g.shape == f.shape == w.shape
    for i in range(w.shape[0]):
        rpi = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(rp),
            [jnp.asarray(x.numpy()) for x in
             tree_leaves(spec.unflatten(torch.from_numpy(w[i])))])
        np.testing.assert_allclose(g[i].numpy(), flat(jax.grad(rloss)(rpi, rb)),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(f[i].numpy(),
                                   flat(r_fisher(rloss, rpi, rb, 4)),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("use_sensitivity", [True, False])
def test_client_sketch_matches_reference(use_sensitivity):
    """The port's fused-kernel sketch (plain version on CPU) against the
    reference's CPU path (jnp sensitivity + sketch_tree)."""
    rp, tp, rb, tb, rloss, tloss = _mlp_world(1)
    rcfg = rpsa.PSAConfig(use_sensitivity=use_sensitivity)
    tcfg = tpsa.PSAConfig(use_sensitivity=use_sensitivity)
    want = np.asarray(rpsa.client_sketch(rloss, rp, rb, rcfg))
    got = tpsa.client_sketch(tloss, tp, tb, tcfg).numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_thermometer_trajectory_matches_reference():
    rng = np.random.RandomState(0)
    rs, ts = rthermo.init_thermometer(4), tthermo.init_thermometer(4)
    for m in rng.uniform(0.1, 5.0, size=11).astype(np.float32):
        rs, ts = rthermo.push(rs, m), tthermo.push(ts, torch.tensor(m))
        assert tthermo.is_full(ts) == bool(rthermo.is_full(rs))
        np.testing.assert_allclose(float(tthermo.current_mean(ts)),
                                   float(rthermo.current_mean(rs)), rtol=1e-6)
        np.testing.assert_allclose(float(ts.m0), float(rs.m0), rtol=1e-6)
        if tthermo.is_full(ts):
            np.testing.assert_allclose(float(tthermo.temperature(ts, 5.0, 0.5)),
                                       float(rthermo.temperature(rs, 5.0, 0.5)),
                                       rtol=1e-6)


def test_psa_weights_staleness_and_cosine_match_reference():
    for seed in range(10):
        rng = np.random.RandomState(seed)
        kappas = rng.uniform(-1, 1, size=rng.randint(2, 9)).astype(np.float32)
        temp = np.float32(rng.uniform(0.125, 20.0))
        np.testing.assert_allclose(
            tagg.psa_weights(torch.from_numpy(kappas), torch.tensor(temp)).numpy(),
            np.asarray(ragg.psa_weights(jnp.asarray(kappas), jnp.float32(temp))),
            rtol=1e-6, atol=1e-7)
        a, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
        np.testing.assert_allclose(
            float(tsk.cosine(torch.from_numpy(a), torch.from_numpy(b))),
            float(rsk.cosine(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    for tau in range(20):
        np.testing.assert_allclose(tagg.staleness_polynomial(tau, 1.0, 0.5),
                                   float(ragg.staleness_polynomial(tau, 1.0, 0.5)),
                                   rtol=1e-6)


@pytest.mark.parametrize("thermo", [True, False])
def test_server_step_trajectory_matches_reference(thermo):
    """Receive/aggregate trajectories of Algorithm 1, both weight phases
    (the queue fills mid-run) and the w/o-T ablation, with a sketch
    refresh after every aggregation."""
    kw = dict(buffer_size=3, queue_len=7, use_thermometer=thermo)
    rcfg, tcfg = rpsa.PSAConfig(**kw), tpsa.PSAConfig(**kw)
    d, k = 40, rcfg.sketch_k
    rng = np.random.RandomState(5)
    proj = rng.randn(k, d).astype(np.float32)
    rrefresh = lambda v: jnp.tanh(jnp.asarray(proj) @ v)  # noqa: E731
    trefresh = lambda v: torch.tanh(torch.from_numpy(proj) @ v)  # noqa: E731
    g0 = rng.randn(d).astype(np.float32)
    rs = rpsa.init_state(rcfg, d, rrefresh(jnp.asarray(g0)))
    ts = tpsa.init_state(tcfg, d, trefresh(torch.from_numpy(g0)))
    rg, tg = jnp.asarray(g0), torch.from_numpy(g0)
    step = jax.jit(lambda s, g, u, sk: rpsa.server_step(s, g, u, sk, rcfg,
                                                        rrefresh))
    updates = 0
    for i in range(16):
        u = (rng.randn(d) * 0.1 * (1 + i % 3)).astype(np.float32)
        sk = rng.randn(k).astype(np.float32)
        rs, rg, rinfo = step(rs, rg, jnp.asarray(u), jnp.asarray(sk))
        ts, tg, tinfo = tpsa.server_step(ts, tg, torch.from_numpy(u),
                                         torch.from_numpy(sk), tcfg, trefresh)
        assert tinfo.updated == bool(rinfo.updated)
        assert ts.count == int(rs.count)
        np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.global_sketch.numpy(),
                                   np.asarray(rs.global_sketch), rtol=1e-5, atol=1e-6)
        if tinfo.updated:
            updates += 1
            assert tinfo.temp_valid == bool(rinfo.temp_valid)
            np.testing.assert_allclose(tinfo.weights.numpy(),
                                       np.asarray(rinfo.weights), rtol=1e-5, atol=1e-6)
    assert updates == 5


def test_server_step_never_writes_the_global_vector():
    """Dispatch snapshots alias old global vectors, so an aggregation must
    return a fresh tensor and leave its input as it was."""
    cfg = tpsa.PSAConfig(buffer_size=1, queue_len=2)
    st = tpsa.init_state(cfg, 4, torch.ones(cfg.sketch_k))
    g = torch.zeros(4)
    st, g2, info = tpsa.server_step(st, g, torch.ones(4), torch.ones(cfg.sketch_k), cfg)
    assert info.updated and torch.equal(g, torch.zeros(4))
    assert torch.equal(g2, torch.ones(4))
