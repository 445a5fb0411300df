"""The port's cohort engine and member-math seam against the JAX reference.

* ``member_dot``: both routing modes give the reference's values and
  gradients, member-batched, with shared weights and with ``ncon=2``;
* ``member_conv2d``: both modes give XLA's grouped convolution's value
  and gradients; its weight gradient goes through the grouped kernel
  under ``"grouped"``, and a member's is the same bits at any width;
* ``CohortEngine.cohort_update`` against the reference's on the same numpy
  init and data (``paper-synthetic-mlp`` and a narrow CNN; ragged sizes,
  prox/align variants), in both member-kernel modes; padding rows are
  exact no-ops, and ending a wave at its last live step changes no bit.

The simulator's ``engine="cohort"`` is held in
``tests/test_torch_cohort_sim.py``. Inputs are numpy arrays from seeds
handed to both sides; tolerances are stated beside each check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as rtu
from repro.configs import get_config as rget
from repro.data import StackedClients as RStacked
from repro.federated.cohort import CohortEngine as RCohort
from repro.models import member_math as rmm
from repro.models import model as RM
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.federated.cohort import CohortEngine, bucket_size
from repro_torch.models import member_math as tmm
from torch_threads import one_torch_thread  # noqa: F401

NARROW_CNN = dict(cnn_channels=(4, 8), input_hw=(8, 8, 3), mlp_hidden=(16,))
TOL = 1e-5          # the reference suite's cohort parity gate


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --- member_dot ------------------------------------------------------------

MEMBER_CASES = {
    # name: (x shape, w shape, ncon, x_members, w_members)
    "members": ((4, 6, 24), (4, 24, 8), 1, True, True),
    "shared_weights": ((5, 3, 12), (12, 7), 1, True, False),
    "ncon2": ((3, 5, 4, 8), (3, 4, 8, 16), 2, True, True),
    "unbatched": ((9, 13), (13, 5), 1, False, False),
}


def _ref_member_dot(x, w, ncon, xm, wm):
    """The reference's value and grads of sum(tanh(member_dot)^2), its
    member axes under ``jax.vmap``."""
    def loss(x1, w1):
        return jnp.sum(jnp.tanh(rmm.member_dot(x1, w1, ncon)) ** 2)

    f = jax.value_and_grad(loss, argnums=(0, 1))
    if xm or wm:
        f = jax.vmap(f, in_axes=(0, 0 if wm else None))
    val, (gx, gw) = f(jnp.asarray(x), jnp.asarray(w))
    # a shared weight's gradient is the sum over members
    gw = gw if wm or not xm else jnp.sum(gw, axis=0)
    return np.sum(np.asarray(val)), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("case", sorted(MEMBER_CASES))
@pytest.mark.parametrize("mode", tmm.MODES)
def test_member_dot_value_and_grad_match_reference(case, mode):
    xs, ws, ncon, xm, wm = MEMBER_CASES[case]
    rng = np.random.RandomState(len(case))
    x, w = rng.randn(*xs).astype(np.float32), rng.randn(*ws).astype(np.float32)
    want = _ref_member_dot(x, w, ncon, xm, wm)
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    with tmm.routing(mode):
        out = tmm.member_dot(tx, tw, ncon, x_members=xm, w_members=wm)
        loss = torch.sum(torch.tanh(out) ** 2)
        gx, gw = torch.autograd.grad(loss, (tx, tw))
    for got, ref in zip((loss, gx, gw), want):
        got = got.detach().numpy()
        scale = np.max(np.abs(ref)) + 1e-9
        assert np.max(np.abs(got - ref)) / scale < TOL


def test_routing_validates_and_restores():
    assert tmm.current_mode() == "vmap"
    with pytest.raises(ValueError, match="member_kernel"):
        with tmm.routing("einsum"):
            pass
    with tmm.routing("grouped"):
        assert tmm.current_mode() == "grouped"
    assert tmm.current_mode() == "vmap"


def test_grouped_mode_goes_through_the_kernel_both_ways(monkeypatch):
    """grouped mode calls the grouped_matmul wrapper for the forward, dW
    and dx (3 calls), and skips dx when the input needs no gradient."""
    calls = []
    real = tmm.grouped_matmul
    monkeypatch.setattr(tmm, "grouped_matmul",
                        lambda a, b: calls.append(a.shape) or real(a, b))
    x = torch.randn(4, 6, 24)
    w = torch.randn(4, 24, 8, requires_grad=True)
    with tmm.routing("grouped"):
        out = tmm.member_dot(x, w, x_members=True, w_members=True)
        out.sum().backward()
    assert len(calls) == 2                 # forward, dW (x needs no grad)
    x.requires_grad_(True)
    with tmm.routing("grouped"):
        tmm.member_dot(x, w, x_members=True, w_members=True).sum().backward()
    assert len(calls) == 5


# --- member_conv2d ---------------------------------------------------------

# (groups, images, channels in, channels out, height = width, kernel)
CONV_CASES = {"one_group": (1, 3, 3, 4, 8, 5), "members": (3, 2, 2, 5, 6, 5),
              "kernel3": (4, 2, 3, 2, 5, 3)}


def _ref_conv(x, w, groups, pad):
    """The reference's value and grads of sum(tanh(conv)^2): XLA's grouped
    convolution (``feature_group_count``), as ``jax.vmap`` batches the
    reference model's per-member convolution."""
    def loss(x1, w1):
        y = jax.lax.conv_general_dilated(
            x1, w1, (1, 1), [(pad, pad)] * 2, feature_group_count=groups,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(jnp.tanh(y) ** 2)

    val, (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(val), np.asarray(gx), np.asarray(gw)


def _conv_inputs(case):
    G, n, c_in, c_out, hw, k = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    return (rng.randn(n, G * c_in, hw, hw).astype(np.float32),
            rng.randn(G * c_out, c_in, k, k).astype(np.float32), G, k // 2)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("mode", tmm.MODES)
def test_member_conv2d_value_and_grad_match_reference(case, mode):
    """The forward, input gradient and weight gradient (the port's own:
    the output gradient times the input's windows) against XLA's grouped
    convolution, relative to the largest value, at the cohort gate."""
    x, w, G, pad = _conv_inputs(case)
    want = _ref_conv(x, w, G, pad)
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    with tmm.routing(mode):
        y = tmm.member_conv2d(tx, tw, groups=G, padding=pad)
        loss = torch.sum(torch.tanh(y) ** 2)
        gx, gw = torch.autograd.grad(loss, (tx, tw))
    for got, ref in zip((loss, gx, gw), want):
        got = got.detach().numpy()
        scale = np.max(np.abs(ref)) + 1e-9
        assert np.max(np.abs(got - ref)) / scale < TOL


def test_member_conv2d_weight_grad_routes_and_ignores_width(monkeypatch):
    """Under "grouped" the weight gradient is one grouped_matmul call (the
    forward and the input gradient none), under "vmap" none; a member's
    weight gradient is the same bits in a wave three times as wide."""
    calls = []
    real = tmm.grouped_matmul
    monkeypatch.setattr(tmm, "grouped_matmul",
                        lambda a, b: calls.append(a.shape) or real(a, b))
    x, w, _, pad = _conv_inputs("members")
    gy = np.random.RandomState(7).randn(2, 15, 6, 6).astype(np.float32)
    wide = {}
    for mode in tmm.MODES:
        for G in (1, 3):
            tw = _t(w[:5 * G]).requires_grad_(True)
            with tmm.routing(mode):
                y = tmm.member_conv2d(_t(x[:, :2 * G]), tw, groups=G,
                                      padding=pad)
                (wide[mode, G],) = torch.autograd.grad(y, tw, _t(gy[:, :5 * G]))
        assert len(calls) == (2 if mode == "grouped" else 0)
    assert torch.equal(wide["grouped", 3][:5], wide["grouped", 1])
    np.testing.assert_allclose(wide["vmap", 3].numpy(),
                               wide["grouped", 3].numpy(), rtol=1e-5,
                               atol=1e-5)


# --- CohortEngine.cohort_update --------------------------------------------

def _configs(name):
    if name == "narrow-cnn":
        return (dataclasses.replace(rget("paper-cifar10-cnn"), **NARROW_CNN),
                dataclasses.replace(tget("paper-cifar10-cnn"), **NARROW_CNN))
    return rget(name), tget(name)


def _world(model, clients, alpha, seed=0, samples=2_000):
    """Client datasets (the port's and the reference's are the same numpy
    arrays) and the reference's init as numpy."""
    rcfg, tcfg = _configs(model)
    if rcfg.family == "cnn":
        full = tdata.make_classification(samples, 10, image_hw=rcfg.input_hw,
                                         seed=seed, class_sep=0.7)
    else:
        full = tdata.make_classification(samples, 10, rcfg.input_hw[0],
                                         seed=seed, class_sep=0.7)
    train, _ = tdata.train_test_split(full, 0.1)
    parts = (tdata.iid_partition(train, clients, seed) if alpha <= 0 else
             tdata.dirichlet_partition(train, clients, alpha, seed))
    datasets = [tdata.ClientDataset(train.subset(ix)) for ix in parts]
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(seed), rcfg))
    return rcfg, tcfg, datasets, params


def _engines(rcfg, tcfg, datasets, params, member_kernel, **kw):
    rspec = rtu.FlatSpec(params)
    reng = RCohort(rcfg, RStacked.from_datasets(datasets), rspec, params, **kw)
    tparams = params_from_numpy(params)
    tspec = FlatSpec(tparams)
    teng = CohortEngine(tcfg, tdata.StackedClients.from_datasets(datasets),
                        tspec, member_kernel=member_kernel, **kw)
    return rspec, reng, tspec, teng


ENGINE_CASES = {
    # name: (model, clients, alpha, engine kwargs)
    "mlp-uniform": ("paper-synthetic-mlp", 8, 0.0,
                    dict(local_epochs=3, batch_size=64)),
    "mlp-ragged": ("paper-synthetic-mlp", 8, 0.1,
                   dict(local_epochs=2, batch_size=64)),
    "mlp-prox": ("paper-synthetic-mlp", 6, 0.3,
                 dict(local_epochs=2, batch_size=32, prox=0.5)),
    "mlp-align": ("paper-synthetic-mlp", 6, 0.3,
                  dict(local_epochs=2, batch_size=32, align=0.1)),
    "cnn-ragged": ("narrow-cnn", 6, 0.3, dict(local_epochs=1, batch_size=32)),
}


@pytest.mark.parametrize("mode", tmm.MODES)
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_cohort_update_matches_reference(case, mode):
    model, clients, alpha, kw = ENGINE_CASES[case]
    rcfg, tcfg, datasets, params = _world(model, clients, alpha)
    if alpha > 0:
        sizes = sorted(len(d) for d in datasets)
        assert sizes[0] != sizes[-1], "world not ragged enough"
    rspec, reng, tspec, teng = _engines(rcfg, tcfg, datasets, params, mode,
                                        **kw)
    flat = np.asarray(rspec.flatten(params))
    rng = np.random.RandomState(5)
    # 3 members (pads to 4) from distinct snapshots
    thetas = np.stack([flat + 0.01 * i * rng.randn(flat.size).astype(np.float32)
                       for i in range(3)])
    cids, lrs, seeds = [0, clients // 2, clients - 1], [0.01, 0.008, 0.012], \
        [11, 22, 33]
    rd, rw = reng.cohort_update(jnp.asarray(thetas), cids, lrs, seeds)
    td, tw = teng.cohort_update(_t(thetas), cids, lrs, seeds)
    assert td.shape == tw.shape == (3, flat.size)
    # |delta| is a sum of <= 30 SGD steps of f32 arithmetic in another order
    assert float(np.max(np.abs(td.numpy() - np.asarray(rd)))) <= TOL
    assert float(np.max(np.abs(tw.numpy() - np.asarray(rw)))) <= TOL


@pytest.mark.parametrize("model", ["paper-synthetic-mlp", "narrow-cnn"])
def test_grouped_matches_vmap_and_padding_is_a_noop(model):
    """grouped member math within 1e-5 of vmap on a real cohort update;
    B=3 (padded to 4) agrees exactly with the first 3 rows of B=4; ending
    each wave after its last live step is bit-identical to running all
    num_steps (the skipped steps have lr 0)."""
    rcfg, tcfg, datasets, params = _world(model, 6, 0.3)
    kw = dict(local_epochs=2, batch_size=32)
    _, _, tspec, eng_v = _engines(rcfg, tcfg, datasets, params, "vmap", **kw)
    eng_g = CohortEngine(tcfg, tdata.StackedClients.from_datasets(datasets),
                         tspec, member_kernel="grouped", **kw)
    flat = tspec.flatten(params_from_numpy(params))
    thetas = torch.stack([flat] * 3)
    cids, lrs, seeds = [0, 2, 5], [0.01, 0.008, 0.012], [11, 22, 33]
    dv, wv = eng_v.cohort_update(thetas, cids, lrs, seeds)
    dg, wg = eng_g.cohort_update(thetas, cids, lrs, seeds)
    assert float((dv - dg).abs().max()) <= TOL
    assert float((wv - wg).abs().max()) <= TOL

    d4, _ = eng_v.cohort_update(torch.stack([flat] * 4), cids + [1],
                                lrs + [0.01], seeds + [44])
    assert torch.equal(dv, d4[:3])

    # the three clients with the fewest local steps: their wave ends early
    cids = [int(c) for c in np.argsort(eng_v.steps_per_client,
                                       kind="stable")[:3]]
    before = eng_v.steps_run
    d_cut, w_cut = eng_v.cohort_update(thetas, cids, lrs, seeds)
    ran = eng_v.steps_run - before
    assert ran == max(eng_v.steps_per_client[c] for c in cids)
    assert ran < eng_v.num_steps, "nothing was trimmed"
    run = eng_v._train
    eng_v._train = lambda *a: run(*a[:-1], eng_v.num_steps)
    d_full, w_full = eng_v.cohort_update(thetas, cids, lrs, seeds)
    assert torch.equal(d_full, d_cut) and torch.equal(w_full, w_cut)


def test_bucket_size_matches_reference():
    from repro.federated.cohort import bucket_size as r_bucket
    for kind in ("image", "tokens"):
        for B in range(1, 70):
            assert bucket_size(B, kind) == r_bucket(B, kind)


def test_engine_rejects_unknown_member_kernel():
    rcfg, tcfg, datasets, params = _world("paper-synthetic-mlp", 4, 0.0,
                                          samples=400)
    with pytest.raises(ValueError, match="member_kernel"):
        CohortEngine(tcfg, tdata.StackedClients.from_datasets(datasets),
                     FlatSpec(params_from_numpy(params)),
                     member_kernel="einsum")
