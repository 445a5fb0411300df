"""The port's production-mesh rules, input shapes and logical-axis trees
against the reference's, exactly.

``rules_for``, ``axis_dims`` and ``describe_rules`` for the ten assigned
architectures on both production meshes at the four global batches of the
assigned shapes (and with ``pure_data_parallel`` and ``seq_shard`` set),
the reference's side on a ``SimpleNamespace`` mesh as
``tests/test_sharding_rules.py`` builds it; ``input_specs`` for every pair
of the 40-cell matrix (mode, every spec's shape and dtype, decode caches
included, and every axes tuple) and the same skips; ``param_axes`` and
``cache_axes`` key for key; and ``shard_pytree_spec`` of every arch's
parameter axes on the pod mesh equal to the reference's ``PartitionSpec``s
as tuples, leaf for leaf. Those are logic; then the layouts run: a
tiny model on 4 gloo ranks as a (2, 2) mesh under the rules computes one
device's numbers.
"""
import dataclasses
from types import SimpleNamespace

import jax
import pytest

from repro.common import sharding as rsh
from repro.configs import ASSIGNED as R_ASSIGNED
from repro.configs import get_config as rget
from repro.configs import shapes as rshapes
from repro.launch import mesh as rmesh
from repro.models import model as rmodel
from repro_torch.common import sharding as tsh
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from torch_threads import one_torch_thread  # noqa: F401


def _fake_mesh(shape, axes):
    return SimpleNamespace(axis_names=axes,
                           devices=SimpleNamespace(shape=shape))


MESHES = {"pod": _fake_mesh((16, 16), ("data", "model")),
          "multipod": _fake_mesh((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (256, 32, 128, 1)
OVERRIDES = ({}, {"pure_data_parallel": True}, {"seq_shard": True})


def _norm(v):
    """A rule's assignment as the reference's ``dryrun`` records it."""
    return list(v) if isinstance(v, (list, tuple)) else v


def test_assigned_matches_reference():
    assert ASSIGNED == R_ASSIGNED


@pytest.mark.parametrize("over", OVERRIDES, ids=["base", "pure_dp", "seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_rules_match_reference(arch, mesh, over):
    cfg = dataclasses.replace(get_config(arch), **over)
    rcfg = dataclasses.replace(rget(arch), **over)
    # the port's own mesh description and the reference's test namespace
    port_mesh = tmesh.make_production_mesh(multi_pod=mesh == "multipod")
    assert tuple(port_mesh.axis_names) == MESHES[mesh].axis_names
    assert tuple(port_mesh.devices.shape) == MESHES[mesh].devices.shape
    for gb in BATCHES + (None,):
        got = tmesh.rules_for(cfg, port_mesh, gb).rules
        want = rmesh.rules_for(rcfg, MESHES[mesh], gb).rules
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}, (arch, mesh, gb)
        assert tmesh.axis_dims(cfg, gb) == rmesh.axis_dims(rcfg, gb)
        assert tmesh.describe_rules(cfg, port_mesh, gb) == \
            rmesh.describe_rules(rcfg, MESHES[mesh], gb)
    assert tmesh.dims_conflict(cfg) == rmesh.dims_conflict(rcfg)


def test_production_tables_match_reference():
    assert tsh.PRODUCTION_RULES.rules == rsh.PRODUCTION_RULES.rules
    assert tsh.EXPERT_TP_RULES.rules == rsh.EXPERT_TP_RULES.rules
    for name in ("pure_data_parallel", "seq_shard", "expert_tensor_parallel"):
        for arch in ASSIGNED:
            assert getattr(get_config(arch), name) == \
                getattr(rget(arch), name), (arch, name)


def _walk(tree, path=()):
    """(path, leaf) pairs of a dict tree, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    for shape in tshapes.SHAPES:
        ok, why = tshapes.shape_supported(cfg, shape)
        assert (ok, why) == rshapes.shape_supported(rcfg, shape)
        if not ok:
            with pytest.raises(ValueError, match="encoder-only"):
                tshapes.input_specs(cfg, shape)
            continue
        mode, specs, axes = tshapes.input_specs(cfg, shape)
        rmode, rspecs, raxes = rshapes.input_specs(rcfg, shape)
        assert mode == rmode
        got, want = list(_walk(specs)), list(_walk(rspecs))
        assert [p for p, _ in got] == [p for p, _ in want], (arch, shape)
        for (path, t), (_, s) in zip(got, want):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(s.shape), (arch, shape, path)
            assert str(t.dtype).split(".")[1] == str(s.dtype), \
                (arch, shape, path)
        assert list(_walk(axes)) == list(_walk(raxes)), (arch, shape)


def test_matrix_and_shapes_match_reference():
    assert tshapes.all_pairs(ASSIGNED) == rshapes.all_pairs(R_ASSIGNED)
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in rshapes.SHAPES.items()}
    for arch in ASSIGNED:
        for shape in tshapes.SHAPES:
            assert tshapes.config_for_shape(get_config(arch), shape) \
                .sliding_window == rshapes.config_for_shape(
                    rget(arch), shape).sliding_window


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_cache_axes_match_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    assert tmodel.param_axes(cfg) == rmodel.param_axes(rcfg)
    if cfg.has_decode:
        assert tmodel.cache_axes(cfg) == rmodel.cache_axes(rcfg)
    # key for key with the port's own init
    params = tmodel.init_params(None, cfg, "meta")
    got = [p for p, _ in _walk(tmodel.param_axes(cfg, params))]
    assert got == [p for p, _ in _walk(params)]
    for path, ax in _walk(tmodel.param_axes(cfg, params)):
        leaf = params
        for k in path:
            leaf = leaf[k]
        assert len(ax) == leaf.dim(), (arch, path)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_shard_pytree_spec_matches_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    rules = tmesh.rules_for(cfg, MESHES["pod"], 256)
    rrules = rmesh.rules_for(rcfg, MESHES["pod"], 256)
    got = list(_walk(tsh.shard_pytree_spec(rules, tmodel.param_axes(cfg))))
    want = list(_walk(rsh.shard_pytree_spec(rrules,
                                            rmodel.param_axes(rcfg))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, spec), (_, pspec) in zip(got, want):
        assert isinstance(pspec, jax.sharding.PartitionSpec)
        assert spec == tuple(pspec), (arch, path)
        assert tsh.logical_to_pspec(rules, ("embed", "mlp")) == \
            tuple(rsh.logical_to_pspec(rrules, ("embed", "mlp")))


def test_spec_dedup_first_wins():
    rules = tsh.LogicalRules({"a": "model", "b": "model", "c": "data"})
    assert rules.mesh_axes(("a", "b", "c")) == ("model", None, "data")


def test_with_logical_constraint_without_rules_is_identity():
    import torch
    x = torch.ones(3)
    assert tsh.with_logical_constraint(x, tsh.SINGLE_DEVICE_RULES,
                                       ("batch",)) is x
    assert tsh.constrain(x, ("batch",)) is x
    with tsh.logical_rules(tsh.SINGLE_DEVICE_RULES):
        assert tsh.current_rules() is None
        assert tsh.constrain(x, ("batch",)) is x
    with tsh.logical_rules(tsh.PRODUCTION_RULES):
        assert tsh.current_rules() is tsh.PRODUCTION_RULES
        with pytest.raises(TypeError, match="plain"):
            tsh.constrain(x, ("batch",))
    assert tsh.current_rules() is None


@pytest.mark.parametrize("arch,over", [
    ("llama3-405b-smoke", {"num_kv_heads": 1}), ("jamba-v0.1-52b-smoke", {})],
    ids=["dense-cache_seq", "hybrid-moe"])
def test_rules_layouts_compute_one_devices_numbers(arch, over, tmp_path):
    """The layouts the dry run counts are a program: on 4 gloo ranks as a
    (2, 2) ``data x model`` mesh under ``rules_for``'s rules, a train step
    (loss and every gradient), a prefill and a decode step equal one
    device's to f32 summation order. A dense model whose kv heads do not
    divide the model axis (heads over model with k and v repeated, the
    decode cache over its slots) and the hybrid (mamba, attention, MoE with
    experts over model)."""
    from torch_dist import run_ranks
    res = run_ranks(4, "sharded_lm_program", {"arch": arch, "over": over},
                    tmp_path)
    if "num_kv_heads" in over:
        assert res[0]["rules"]["cache_seq"] == "model"
        assert "kv_heads" not in res[0]["rules"]
    for r in res:
        assert r["loss"] < 1e-5 and r["grads"] < 1e-4, r
        assert r["prefill"] < 1e-5 and r["decode"] < 1e-5, r
