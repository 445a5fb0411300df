"""The reference's other dense LM configs in the port, and its two-level
remat, against the JAX reference on the CPU.

``codeqwen1.5-7b`` (multi-head attention, kv = 32, ``rope_theta`` 1e6),
``minitron-8b`` (squared-ReLU FFN without a gate, vocab 256,000) and
``llama3-405b`` (``scan_groups=9``): each full config field for field; the
meta-device init of all four dense configs against ``jax.eval_shape`` of
the reference's init (leaf paths, shapes and dtypes; nothing is drawn);
each ``-smoke`` config's loss and gradient on the reference's converted
init within rtol 1e-5 (each gradient leaf within 1e-5 x max(1, max|ref
leaf|), as ``tests/test_torch_lm_train.py``). ``scan_groups`` at 6 layers
in 3 groups under ``remat="full"``: bit-equal to ``scan_groups=0`` on the
port, and within the same tolerances of the reference's two-level scan.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import model as RM
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from test_torch_lm_train import (_close_tree, _port_value_and_grad,
                                 _ref_init, _ref_value_and_grad, _tokens)
from torch_threads import one_torch_thread  # noqa: F401

NEW = ["codeqwen1.5-7b", "minitron-8b", "llama3-405b"]
DENSE = ["phi4-mini-3.8b"] + NEW


def _fields_equal(r, t):
    ported = {f.name for f in dataclasses.fields(t)}
    assert {"scan_groups", "rope_theta", "ffn_act", "long_context_window",
            "sliding_window"} <= ported
    for f in dataclasses.fields(r):
        if f.name in ported:
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for prop in ("num_superblocks", "vocab_padded", "is_encoder_only",
                 "has_decode"):
        assert getattr(t, prop) == getattr(r, prop), prop


@pytest.mark.parametrize("arch", NEW + [a + "-smoke" for a in NEW])
def test_config_matches_reference_field_for_field(arch):
    r, t = rget(arch), tget(arch)
    _fields_equal(r, t)
    _fields_equal(r.for_long_context(), t.for_long_context())
    assert t.for_long_context().sliding_window == 8192
    assert arch.replace("-smoke", "") in list_archs()


@pytest.mark.parametrize("arch", DENSE)
def test_meta_init_matches_reference_eval_shape(arch):
    want = jax.eval_shape(lambda key: RM.init_params(key, rget(arch)),
                          jax.random.PRNGKey(0))
    got = TM.init_params(None, tget(arch), "meta")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [tuple(k.key for k in p) for p, _ in wl] == \
        [tuple(k.key for k in p) for p, _ in gl]
    for (_, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        assert g.device.type == "meta"
    assert TM.count_params(tget(arch)) == RM.count_params(rget(arch))
    if arch == "minitron-8b":      # relu2: no gate
        assert "w_gate" not in got["blocks"]["p0"]["ffn"]


@pytest.mark.parametrize("arch", NEW)
def test_smoke_loss_and_grad_match_reference(arch):
    smoke = arch + "-smoke"
    rcfg, tcfg = rget(smoke), tget(smoke)
    rp = _ref_init(smoke, 2)
    assert ("w_gate" in rp["blocks"]["p0"]["ffn"]) == \
        (rcfg.ffn_act == "swiglu")
    tp = params_from_numpy(rp)
    assert set(tp["blocks"]["p0"]["ffn"]) == set(rp["blocks"]["p0"]["ffn"])
    toks = _tokens(rcfg, (3, 20), 5)
    labels = toks.copy()
    labels[0, 3:7] = -1
    batch = {"tokens": toks, "labels": labels}
    want_l, want_g = _ref_value_and_grad(rcfg, rp, batch)
    got_l, got_g = _port_value_and_grad(tcfg, rp, batch)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    _close_tree(got_g, want_g, 1e-5)


def _grouped_pair(scan_groups):
    over = dict(num_layers=6, scan_groups=scan_groups, remat="full")
    return (dataclasses.replace(rget("llama3-405b-smoke"), **over),
            dataclasses.replace(tget("llama3-405b-smoke"), **over))


def test_scan_groups_is_bit_equal_and_matches_the_two_level_scan():
    rcfg, tcfg = _grouped_pair(3)
    assert tcfg.num_superblocks == 6
    with jax.threefry_partitionable(False):
        rp = jax.tree_util.tree_map(
            np.asarray, RM.init_params(jax.random.PRNGKey(7), rcfg))
    toks = _tokens(rcfg, (2, 16), 8)
    batch = {"tokens": toks, "labels": toks}
    got_l, got_g = _port_value_and_grad(tcfg, rp, batch)
    flat_l, flat_g = _port_value_and_grad(_grouped_pair(0)[1], rp, batch)
    assert torch.equal(got_l, flat_l)
    for a, b in zip(tree_leaves(got_g), tree_leaves(flat_g)):
        assert torch.equal(a, b)
    want_l, want_g = _ref_value_and_grad(rcfg, rp, batch)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    _close_tree(got_g, want_g, 1e-5)


def test_scan_groups_checkpoints_each_group():
    """Under remat "full" with G groups the backward recomputes each group
    (its outer checkpoint) up to the input of its last superblock, which is
    all that the group saved (torch's non-reentrant checkpoint stops there),
    and then each superblock (the inner ones): 6 + (6 - 3) + 6 superblock
    calls a step, against 6 + 6 with one level and 6 with remat "none"."""
    _, tcfg = _grouped_pair(3)
    p = params_from_numpy(_ref_init("llama3-405b-smoke", 0, num_layers=6))
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    toks = torch.from_numpy(_tokens(tcfg, (1, 8), 9).astype(np.int64))
    calls = []
    real = TM.superblock_forward

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    for cfg, want in ((tcfg, 15), (_grouped_pair(0)[1], 12),
                      (dataclasses.replace(tcfg, remat="none"), 6)):
        calls.clear()
        TM.superblock_forward = counted
        try:
            loss = TM.loss_fn(p, {"tokens": toks, "labels": toks}, cfg)
            torch.autograd.grad(loss, tree_leaves(p))
        finally:
            TM.superblock_forward = real
        assert len(calls) == want, (cfg.scan_groups, cfg.remat, len(calls))
