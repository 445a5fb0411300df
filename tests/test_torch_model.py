"""The port's paper models against the JAX reference: forward, loss and
gradients on the same numpy inputs and the reference's own (converted)
initial parameters — the synthetic MLP, a narrowed CNN and the four paper
models at their real widths — plus the CIFAR CNN's layout, the numpy round
trip, a short full-width ``paper-cifar10-cnn`` FedPSA run against a live
reference run, and the calibration batch's refusal of token data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as rtu
from repro.configs import get_config as rget
from repro.core import PSAConfig as RPSAConfig
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec, grad, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.launch.train import build_task as t_build_task
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


# The paper models at their real widths: the largest reduction (fc0's 4,096
# inputs, the 3,136 of MNIST's fc) stays within rtol 1e-5 / atol 1e-6; the
# worst element measured 0.80 of that limit (CIFAR-100 logits, max |value|
# 1.10, |err| 8.9e-7), gradients at most 0.16 of it.
@pytest.mark.parametrize("name", ["paper-synthetic-mlp", "narrow-cnn",
                                  "paper-mnist-cnn", "paper-fmnist-linear",
                                  "paper-cifar10-cnn", "paper-cifar100-cnn"])
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


# A short FedPSA run of the chip's full-width model (d = 1,756,426) on a
# small world: 6 IID clients of 54 samples, one local epoch of two 27-sample
# batches, buffer 2, so the horizon of 350 units holds 3 receives and one
# aggregation. (The reference sketches each model with its Pallas kernel in
# interpret mode, some seconds per full-width sketch on a CPU: the horizon
# is cut for that.)
CIFAR_SIM = dict(num_clients=6, concurrency=0.34, horizon=350.0,
                 eval_every=300.0, seed=0, local_epochs=1, batch_size=27,
                 eval_batches=2, eval_batch_size=64)
CIFAR_PSA = dict(buffer_size=2, queue_len=3)


def test_full_width_cifar_fedpsa_run_matches_reference():
    """The port's sequential FedPSA run on ``paper-cifar10-cnn`` at full
    width against the reference's live run of the same world (the init
    drawn with the legacy threefry, as the goldens'): counters exact,
    digests at the golden RTOL=1e-4 / ATOL=1e-3, accuracy within 2e-3."""
    r = r_build_task("paper-cifar10-cnn", 360, 0.0, 6, 0)
    t = t_build_task("paper-cifar10-cnn", 360, 0.0, 6, 0)
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(0), r[0])
    p = jax.tree_util.tree_map(np.asarray, p)
    want = r_run("fedpsa", r[0], p, r[1], r[2],
                 RSim(engine="sequential", record_trajectory=True, **CIFAR_SIM),
                 psa_cfg=RPSAConfig(**CIFAR_PSA), calib_batch=r[3])
    got = run_algorithm("fedpsa", t[0], params_from_numpy(p), t[1], t[2],
                        SimConfig(engine="sequential", record_trajectory=True,
                                  device="cpu", **CIFAR_SIM),
                        psa_cfg=PSAConfig(**CIFAR_PSA), calib_batch=t[3])
    assert got.versions >= 1
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_allclose(np.asarray(got.digests),
                               np.asarray(want.digests), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.final_accuracy, want.final_accuracy,
                               atol=2e-3)
    np.testing.assert_allclose(got.aulc, want.aulc, atol=2e-3)


def test_calibration_batch_refuses_token_data():
    """The token branch (ported with the LM training slice: uniform token
    ids for "gaussian", held-out sequences for "real", labels mirroring the
    tokens) and the image path are the reference's, output for output."""
    from repro import data as rdata
    toks = tdata.SyntheticClassification(
        x=np.random.RandomState(0).randint(0, 50, (20, 8)).astype(np.int32),
        y=np.zeros(20, np.int32), num_classes=50)
    for source in ("gaussian", "real"):
        got = tdata.make_calibration_batch(toks, 4, source)
        want = rdata.make_calibration_batch(toks, 4, source)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    img = tdata.make_classification(40, 10, 16, seed=2)
    for source in ("gaussian", "real"):
        got = tdata.make_calibration_batch(img, 8, source)
        want = rdata.make_calibration_batch(img, 8, source)
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], want[k])
