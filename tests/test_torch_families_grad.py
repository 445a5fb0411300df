"""The recurrent, MoE and hybrid LMs' training loss and gradients against
the JAX reference, on the CPU.

``loss_fn`` (next-token cross-entropy plus the MoE layers' Switch aux
loss) and its gradient with respect to every parameter, at smoke size
(``xlstm-350m-smoke``, ``qwen2-moe-a2.7b-smoke``, ``jamba-v0.1-52b-smoke``,
``arctic-480b-smoke``) on the reference's init (converted), under remat
``"none"``, ``"full"`` and ``"dots"`` on both sides (the reference's
``jax.checkpoint`` and its ``dots_with_no_batch_dims_saveable`` policy; the
port's ``torch.utils.checkpoint``): the loss within rtol 1e-5, each
gradient leaf within 1e-5 x max(1, max|ref leaf|) (f32); and the port's
remats bit-equal to each other. With a member axis:
``tests/test_torch_families_members.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.common.tree import tree_leaves, tree_unflatten_like
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401

SMOKES = ["xlstm-350m-smoke", "qwen2-moe-a2.7b-smoke", "jamba-v0.1-52b-smoke",
          "arctic-480b-smoke"]


@functools.lru_cache(maxsize=None)
def _ref_init(arch, seed, members=0):
    cfg = rget(arch)
    if members:
        keys = jax.random.split(jax.random.PRNGKey(seed), members)
        p = jax.vmap(lambda k: RM.init_params(k, cfg))(keys)
    else:
        p = RM.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(cfg, shape, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    labels = toks.copy()
    labels[..., 1, 3:6] = -1                 # masked targets
    return {"tokens": toks, "labels": labels}


def _port(tcfg, rp, batch, members=False):
    p = params_from_numpy(rp)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    loss = TM.loss_fn(p, tb, tcfg, members=members)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss, tree_unflatten_like(p, list(grads))


def _close_tree(got, want, tol=1e-5):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", SMOKES)
def test_loss_and_grad_match_reference(arch, remat):
    rcfg = dataclasses.replace(rget(arch), remat=remat)
    tcfg = dataclasses.replace(tget(arch), remat=remat)
    rp = _ref_init(arch, 1)
    batch = _batch(rcfg, (3, 14), 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_l, want_g = jax.value_and_grad(
        lambda p: RM.loss_fn(p, jb, rcfg, R))(rp)
    got_l, got_g = _port(tcfg, rp, batch)
    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               rtol=1e-5)
    _close_tree(got_g, want_g)
    if remat != "none":     # the same values as no remat, bit for bit
        l0, g0 = _port(dataclasses.replace(tcfg, remat="none"), rp, batch)
        assert torch.equal(l0, got_l)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(g0), tree_leaves(got_g)))
