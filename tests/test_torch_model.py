"""The port's paper models against the JAX reference: forward, loss and
gradients on the same numpy inputs and the reference's own (converted)
initial parameters, plus the CIFAR CNN's layout and the numpy round trip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as rtu
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.common.tree import FlatSpec, grad, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import model as TM

NARROW_CNN = dict(cnn_channels=(4, 8), input_hw=(8, 8, 3), mlp_hidden=(16,))


def _configs(name):
    if name == "narrow-cnn":
        return (dataclasses.replace(rget("paper-cifar10-cnn"), **NARROW_CNN),
                dataclasses.replace(tget("paper-cifar10-cnn"), **NARROW_CNN))
    return rget(name), tget(name)


def _batch(rcfg, n=12, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n,) + (tuple(rcfg.input_hw) if rcfg.family == "cnn"
                    else (rcfg.input_hw[0],))
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, rcfg.num_classes, size=n).astype(np.int32))


@pytest.mark.parametrize("name", ["paper-synthetic-mlp", "narrow-cnn"])
def test_forward_loss_grads_match_reference(name):
    rcfg, tcfg = _configs(name)
    rp = RM.init_params(jax.random.PRNGKey(3), rcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp))
    x, y = _batch(rcfg)
    rbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    fwd = RM.cnn_forward if rcfg.family == "cnn" else RM.mlp_forward
    np.testing.assert_allclose(TM.forward(tp, tbatch["x"], tcfg).detach().numpy(),
                               np.asarray(fwd(rp, rbatch["x"], rcfg)),
                               rtol=1e-5, atol=1e-6)
    rloss = lambda p: RM.loss_fn(p, rbatch, rcfg, None)  # noqa: E731
    tloss = lambda p: TM.loss_fn(p, tbatch, tcfg)  # noqa: E731
    np.testing.assert_allclose(float(tloss(tp)), float(rloss(rp)),
                               rtol=1e-5, atol=1e-6)
    rg = jax.grad(rloss)(rp)
    tg = grad(tloss, tp)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(rg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(TM.accuracy(tp, tbatch, tcfg)),
        float(RM.accuracy(rp, rbatch, rcfg)), atol=0)


def test_cifar_cnn_layout_matches_reference():
    """Leaf shapes, flat (sorted-key) order and d of the main path's model."""
    rcfg, tcfg = _configs("paper-cifar10-cnn")
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), rcfg))
    want = [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    spec = FlatSpec(tp)
    assert list(spec.shapes) == want
    assert spec.size == sum(int(np.prod(s)) for s in want) == 1_756_426
    assert [tuple(leaf.shape) for leaf in tree_leaves(tp)] == want
    # init law: zero biases, truncated-normal weights within 2 std of fan-in
    w = tp["fc0"]["w"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(w.shape[0]) + 1e-6
    assert float(tp["conv0"]["b"].abs().max()) == 0.0


def test_flatspec_matches_reference_flatten():
    rcfg, _ = _configs("narrow-cnn")
    rp = RM.init_params(jax.random.PRNGKey(1), rcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp))
    spec = FlatSpec(tp)
    vec = spec.flatten(tp)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(rtu.FlatSpec(rp).flatten(rp)))
    back = spec.unflatten(vec)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_params_from_numpy_round_trip():
    rcfg, _ = _configs("paper-synthetic-mlp")
    rp = jax.tree_util.tree_map(np.asarray,
                                RM.init_params(jax.random.PRNGKey(0), rcfg))
    back = params_to_numpy(params_from_numpy(rp))
    assert set(back) == set(rp)
    for k in rp:
        for kk in rp[k]:
            assert back[k][kk].dtype == np.float32
            np.testing.assert_array_equal(back[k][kk], rp[k][kk])
