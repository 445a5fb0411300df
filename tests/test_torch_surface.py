"""The port's package surface against the reference's, on the CPU.

Each namespace of the port (``repro_torch.federated``, ``core``,
``common``, ``kernels``, ``checkpoint``, ``data``, ``optim``, ``configs``)
holds the public names
that the reference's ``__init__`` exports, less the stated ``LEFT_OUT``
list, each with its reason; ``AS_MODULE`` names are the port's submodule
of that name, which holds the function (exporting the function would
shadow the submodule the port's callers import). The small helpers behind
those names are held to the reference on the same numpy inputs:
``data.batch_iterator`` and the registry's ``register_family`` /
``registered_families`` exactly, the ``tree_*`` helpers,
``first_order_sensitivity`` and ``aggregate_buffer`` within 1e-6 relative
(float32 sums in the same order), ``dense_projection`` and
``psa.structural`` exactly, and the sweep's ``make_sketch_fn_lanes`` on
fed-lm-smoke lane models within 1e-4 x max|ref|.
"""
import ast
import dataclasses
import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as rtree
from repro.core import aggregation as ragg
from repro.core import psa as rpsa
from repro.core import sketch as rsk
from repro.data import loader as rloader
from repro.data import synthetic as rsyn
from repro.federated.simulator import make_sketch_fn_lanes as r_lanes
from repro.launch.train import build_task as r_build_task
from repro.models import registry as rreg
from repro_torch.common import tree as ttree
from repro_torch.common.tree import FlatSpec
from repro_torch.convert import load_npz_params, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import psa as tpsa
from repro_torch.core import sensitivity as tsens
from repro_torch.core import sketch as tsk
from repro_torch.data import loader as tloader
from repro_torch.data import synthetic as tsyn
from repro_torch.federated import make_sketch_fn_flat, make_sketch_fn_lanes
from repro_torch.launch.train import build_task as t_build_task
from repro_torch.models import registry as treg
from torch_dist import FEDLM_INIT, FEDLM_PSA, FEDLM_WORLD
from torch_threads import one_torch_thread  # noqa: F401

# the reference's core namespace binds ``sensitivity`` to the function
rsens = importlib.import_module("repro.core.sensitivity")

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
NAMESPACES = ("federated", "core", "common", "kernels", "checkpoint", "data",
              "optim", "configs")
LEFT_OUT = {
    "federated": {
        "make_legacy_server": "federated/legacy.py is ROADMAP.md Queue 1 "
                              "item 13, not ported",
        "StepInfo": "the reference's fixed-shape per-step diagnostics of a "
                    "jitted step; the port's Policy.step returns a host log "
                    "entry",
    },
    "common": {
        "logical_to_pspec": "XLA partition specs (item 12)",
        "shard_pytree_spec": "XLA partition specs (item 12)",
        "with_logical_constraint": "XLA sharding constraints (item 12)",
    },
    "kernels": {
        "ref": "the pure-jnp oracles; each port kernel keeps its plain "
               "version beside it (``*_plain``)",
        "sens_sketch_pallas": "Pallas entry point; the CUDA wrapper is "
                              "kernels.sens_sketch.sens_sketch",
        "buffer_agg_pallas": "Pallas entry point; the CUDA wrapper is "
                             "kernels.buffer_agg.buffer_agg",
        "grouped_matmul_pallas": "Pallas entry point; the CUDA wrapper is "
                                 "kernels.grouped_matmul.grouped_matmul",
    },
}
AS_MODULE = {("core", "sensitivity"), ("kernels", "flash_attention")}


def _reference_exports(ns: str) -> list:
    """The names ``src/repro/<ns>/__init__.py`` binds by its imports from
    the reference's own modules (``configs`` also imports ``typing`` and
    ``__future__`` names, which are no part of the package)."""
    with open(os.path.join(SRC, "repro", ns, "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "repro"):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("ns", NAMESPACES)
def test_namespace_holds_the_reference_names(ns):
    ref = importlib.import_module(f"repro.{ns}")
    port = importlib.import_module(f"repro_torch.{ns}")
    left_out = LEFT_OUT.get(ns, {})
    names = _reference_exports(ns)
    assert set(left_out) <= set(names)
    for name in names:
        assert hasattr(ref, name), name
        if name in left_out:
            assert not hasattr(port, name), (name, left_out[name])
            continue
        got = getattr(port, name)
        if (ns, name) in AS_MODULE:
            assert isinstance(got, types.ModuleType), name
            assert callable(getattr(got, name)), name
        elif callable(getattr(ref, name)):
            assert callable(got), name


def test_federated_namespace_runs_a_sweep():
    from repro_torch.federated import (SimConfig, SweepConfig, run_algorithm,
                                       run_sweep)
    from repro_torch.federated import simulator
    assert run_sweep is simulator.run_sweep
    assert run_algorithm is simulator.run_algorithm
    assert SimConfig is simulator.SimConfig
    assert SweepConfig is simulator.SweepConfig


def test_package_docstring_names_what_is_ported():
    import repro_torch
    doc = repro_torch.__doc__
    for name in ("run_sweep", "mesh", "fed-lm-smoke", "remat"):
        assert name in doc, name
    assert "Ported so far" not in doc


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

def _tree(seed: int, dtype=np.float32) -> dict:
    rng = np.random.RandomState(seed)
    return {"b": {"w": rng.randn(3, 4).astype(dtype),
                  "s": rng.randn(4).astype(dtype)},
            "a": rng.randn(5).astype(dtype),
            "c": np.asarray(rng.randn(), dtype)}


def _t(tree):
    return ttree.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _same_tree(got, want, rtol=0.0):
    gl = ttree.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=0)


@pytest.mark.parametrize("fn", ["tree_add", "tree_sub", "tree_scale",
                                "tree_axpy", "tree_zeros_like",
                                "tree_weighted_sum", "tree_cast",
                                "unflatten_from_vector", "flatten_to_vector"])
def test_tree_maps_match_reference(fn):
    a, b, c = _tree(0), _tree(1), _tree(2)
    w = np.asarray([0.3, -1.2, 0.7], np.float32)
    args = {
        "tree_add": (a, b), "tree_sub": (a, b), "tree_scale": (a, 0.37),
        "tree_axpy": (0.37, a, b), "tree_zeros_like": (a,),
        "tree_cast": (a, "bfloat16"),
    }
    if fn == "tree_weighted_sum":
        got = ttree.tree_weighted_sum([_t(a), _t(b), _t(c)],
                                      torch.from_numpy(w))
        want = rtree.tree_weighted_sum([_j(a), _j(b), _j(c)], jnp.asarray(w))
        _same_tree(got, want, 1e-6)
        return
    if fn in ("unflatten_from_vector", "flatten_to_vector"):
        vec, unflat = ttree.flatten_to_vector(_t(a))
        rvec, runflat = rtree.flatten_to_vector(_j(a))
        np.testing.assert_array_equal(vec.numpy(), np.asarray(rvec))
        v = np.arange(vec.shape[0], dtype=np.float32)
        _same_tree(unflat(torch.from_numpy(v)), runflat(jnp.asarray(v)))
        _same_tree(ttree.unflatten_from_vector(torch.from_numpy(v), _t(b)),
                   rtree.unflatten_from_vector(jnp.asarray(v), _j(b)))
        return
    targs = [_t(x) if isinstance(x, dict) else x for x in args[fn]]
    jargs = [_j(x) if isinstance(x, dict) else x for x in args[fn]]
    if fn == "tree_cast":
        targs[1], jargs[1] = torch.bfloat16, jnp.bfloat16
        want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                      getattr(rtree, fn)(*jargs))
        got = ttree.tree_map(lambda x: x.float(), getattr(ttree, fn)(*targs))
        assert all(x.dtype == torch.bfloat16 for x in
                   ttree.tree_leaves(getattr(ttree, fn)(*targs)))
        _same_tree(got, want)
        return
    _same_tree(getattr(ttree, fn)(*targs), getattr(rtree, fn)(*jargs), 1e-6)


@pytest.mark.parametrize("fn", ["tree_dot", "tree_sq_norm", "tree_norm",
                                "tree_size", "tree_all_finite"])
def test_tree_reductions_match_reference(fn):
    a, b = _tree(3), _tree(4)
    args = (a, b) if fn == "tree_dot" else (a,)
    got = getattr(ttree, fn)(*(_t(x) for x in args))
    want = getattr(rtree, fn)(*(_j(x) for x in args))
    if fn == "tree_size":
        assert got == want == 22
    elif fn == "tree_all_finite":
        assert bool(got) is bool(want) is True
        bad = _tree(3)
        bad["b"]["s"][1] = np.inf
        assert not bool(ttree.tree_all_finite(_t(bad)))
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n,bs,seed", [(50, 8, 0), (37, 37, 3), (10, 16, 1)])
def test_batch_iterator_matches_reference(n, bs, seed):
    rng = np.random.RandomState(n)
    kw = dict(x=rng.randn(n, 3).astype(np.float32),
              y=rng.randint(0, 4, n).astype(np.int64), num_classes=4)
    got = tloader.batch_iterator(tsyn.SyntheticClassification(**kw), bs, seed)
    want = rloader.batch_iterator(rsyn.SyntheticClassification(**kw), bs,
                                  seed)
    if bs > n:
        return     # an endless iterator of nothing: both yield no batch
    for _ in range(3 * (n // bs) + 1):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"x", "y"}
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_register_family_matches_reference():
    ported = treg.registered_families()
    assert ported == rreg.registered_families()
    mlp = treg.get_family("mlp")
    copy = mlp._replace(name="mlp-copy")
    treg.register_family(copy)
    try:
        assert treg.get_family("mlp-copy") is copy
        assert "mlp-copy" in treg.registered_families()
        with pytest.raises(ValueError, match="already registered"):
            treg.register_family(copy)
        again = copy._replace(data_kind="tokens")
        treg.register_family(again, override=True)
        assert treg.get_family("mlp-copy") is again
        with pytest.raises(ValueError, match="data_kind"):
            treg.register_family(copy._replace(name="x", data_kind="audio"))
    finally:
        treg._REGISTRY.pop("mlp-copy", None)
    assert treg.registered_families() == ported


def test_first_order_sensitivity_matches_reference():
    p, g = _tree(5), _tree(6)
    _same_tree(tsens.first_order_sensitivity(_t(p), _t(g)),
               rsens.first_order_sensitivity(_j(p), _j(g)), 1e-6)


@pytest.mark.parametrize("seed,k", [(42, 16), (7, 4)])
def test_dense_projection_matches_reference(seed, k):
    shapes = [(3, 4), (5,), (), (2, 2, 2)]
    got = tsk.dense_projection(seed, shapes, k)
    want = rsk.dense_projection(seed, shapes, k)
    assert got.shape == want.shape == (k, 12 + 5 + 1 + 8)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # R @ concat(leaves) is sketch_tree
    tree = {f"l{i}": torch.from_numpy(np.asarray(
        np.random.RandomState(i).randn(*s), np.float32))
        for i, s in enumerate(shapes)}
    flat = np.concatenate([x.numpy().reshape(-1) for x in
                           ttree.tree_leaves(tree)])
    np.testing.assert_allclose(tsk.sketch_tree(tree, seed, k).numpy(),
                               got @ flat, rtol=1e-5, atol=1e-5)


def test_aggregate_buffer_matches_reference():
    g, u = _tree(7), [_tree(8 + i) for i in range(3)]
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    got = tagg.aggregate_buffer(_t(g), [_t(x) for x in u],
                                torch.from_numpy(w), server_lr=0.8)
    want = ragg.aggregate_buffer(_j(g), [_j(x) for x in u], jnp.asarray(w),
                                 server_lr=0.8)
    _same_tree(got, want, 1e-6)


@pytest.mark.parametrize("over", [{}, {"buffer_size": 3, "sketch_k": 8},
                                  {"use_sensitivity": False, "gamma": 0.1}])
def test_psa_structural_matches_reference(over):
    assert tpsa.structural(tpsa.PSAConfig(**over)) == \
        rpsa.structural(rpsa.PSAConfig(**over))
    # the per-lane hyperparameters are not structural
    base = tpsa.PSAConfig(**over)
    assert tpsa.structural(dataclasses.replace(
        base, gamma=2.0, delta=0.1, server_lr=0.5,
        use_thermometer=False)) == tpsa.structural(base)


def test_sketch_fn_lanes_matches_reference():
    """(S, B, d) -> (S, B, k) on random lane models of fed-lm-smoke: the
    reference's ``make_sketch_fn_lanes`` within 1e-4 x max|ref| (a sketch
    sums d products of gradients and Fisher terms), and lane s equal to
    ``make_sketch_fn_flat`` of its rows."""
    W = FEDLM_WORLD
    world = (W["samples"], W["alpha"], W["clients"], W["seed"])
    cfg, _, _, calib = t_build_task("fed-lm-smoke", *world, seq_len=W["seq"])
    rcfg, _, _, rcalib = r_build_task("fed-lm-smoke", *world,
                                      seq_len=W["seq"])
    init = load_npz_params(FEDLM_INIT)
    spec = FlatSpec(init)
    rng = np.random.RandomState(3)
    base = spec.flatten(init).numpy()
    w = (base + 0.05 * rng.randn(3, 2, spec.size)).astype(np.float32)
    psa = tpsa.PSAConfig(**FEDLM_PSA)
    got = make_sketch_fn_lanes(cfg, calib, psa, spec)(torch.from_numpy(w))
    assert tuple(got.shape) == (3, 2, psa.sketch_k)
    flat = make_sketch_fn_flat(cfg, calib, psa, spec)
    for s in range(3):
        assert torch.equal(got[s], flat(torch.from_numpy(w[s])))
    rspec = rtree.FlatSpec(params_to_numpy(init))
    want = np.asarray(r_lanes(rcfg, rcalib, rpsa.PSAConfig(**FEDLM_PSA), rspec)(
        jnp.asarray(w)))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
