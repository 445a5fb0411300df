"""The port's mesh-sharded policy server against the reference's
single-device server, on gloo process groups of 2 and 4 CPU ranks.

The cases of ``tests/test_sharded.py``: on the same numpy arrival streams,
``ShardedPolicyServer`` (one process a rank, ``tests/torch_dist.py``)
stays within 1e-5 of the reference's single-device ``make_server`` after
every receive, for all seven policies (asyncfeded with each of its three
metrics) at d = 40 and 41 (41 pads the last shard), and on ``receive_many``
with B = 11; every rank holds the same gathered vector. A sum over d on
the shards (``param_axis_sums``) is the single-device sum bit for bit,
for shards shorter than a chunk, chunks cut by one or several shard
boundaries and boundaries on chunk edges. Also: the state
layout against the reference's ``server_state_specs``, rules that map
``param_shard`` nowhere, ``LogicalRules.mesh_axes`` against the
reference's, ``make_fed_mesh`` without a process group, and ``--mesh 2
--device cpu`` through the train CLI.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common import sharding as rsharding
from repro.core import PSAConfig as RPSAConfig
from repro.core import sketch as rsk
from repro.federated import servers as rsrv
from repro_torch.common import sharding as tsharding
from repro_torch.launch.mesh import make_fed_mesh
from torch_dist import (MANY_B, PSA_CASE, RECEIVES, ROOT, SERVER_CASES,
                        SKETCH_K, SUM_SIZES, Ranks, many_inputs, run_command,
                        server_params, server_stream, sum_terms)
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
RANKS = (2, 4)
CASES = list(SERVER_CASES)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{n: every rank's ``server_program`` results, with its
    ``sums_program`` results under "sums"} for n in RANKS: the jobs side by
    side."""
    jobs = {(n, prog): Ranks(n, prog, {}, tmp_path_factory.mktemp(
        f"{prog}{n}")) for n in RANKS for prog in ("server_program",
                                                   "sums_program")}
    out = {}
    for n in RANKS:
        out[n] = jobs[n, "server_program"].results()
        for r, sums in zip(out[n], jobs[n, "sums_program"].results()):
            r["sums"] = sums
    return out


def _reference(case: str, params: dict):
    name, kw = SERVER_CASES[case]
    kw = dict(kw)
    if name == "fedpsa":
        kw.update(psa_cfg=RPSAConfig(**PSA_CASE), sketch_fn=jax.jit(
            lambda p: rsk.sketch_tree(p, 42, SKETCH_K)))
    return rsrv.make_server(
        name, jax.tree_util.tree_map(jnp.asarray, params), **kw)


@pytest.mark.parametrize("n", RANKS, ids=[f"n{n}" for n in RANKS])
@pytest.mark.parametrize("extra_bias", [0, 1], ids=["d40", "d41"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_receive_matches_single_device(sharded, case, extra_bias, n):
    params = server_params(extra_bias)
    base = _reference(case, params)
    k = SKETCH_K if SERVER_CASES[case][0] == "fedpsa" else None
    ranks = [r["receive"][case, extra_bias] for r in sharded[n]]
    flags, rows, version = ranks[0]
    for other in ranks[1:]:
        assert other[0] == flags and other[2] == version
        np.testing.assert_array_equal(other[1], rows)
    for i, (delta, client, meta) in enumerate(
            server_stream(params, RECEIVES, k=k)):
        assert base.receive(delta, client, meta) == flags[i], i
        err = float(np.max(np.abs(np.asarray(base.flat_params) - rows[i])))
        assert err < TOL, (case, n, i, err)
    assert base.version == version > 0


@pytest.mark.parametrize("n", RANKS, ids=[f"n{n}" for n in RANKS])
@pytest.mark.parametrize("case", CASES)
def test_sharded_receive_many_matches_single_device(sharded, case, n):
    params = server_params(extra_bias=1)
    base = _reference(case, params)
    d = int(sum(v.size for v in params.values()))
    deltas, cids, sizes, vdisp, sketches = many_inputs(d)
    w0 = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    u1, t1, s1 = base.receive_many(
        jnp.asarray(deltas), jnp.asarray(w0[None] + deltas), cids, sizes,
        vdisp, jnp.asarray(sketches) if case == "fedpsa" else None)
    for upd, taus, snaps, version in (r["receive_many"][case]
                                      for r in sharded[n]):
        assert upd == [bool(u) for u in u1] and taus == list(t1)
        assert snaps.shape == (MANY_B, d)     # padding stripped
        err = float(np.max(np.abs(np.asarray(s1) - snaps)))
        assert err < TOL, (case, n, err)
        assert version == base.version


@pytest.mark.parametrize("n", RANKS, ids=[f"n{n}" for n in RANKS])
@pytest.mark.parametrize("d", SUM_SIZES)
def test_sums_over_shards_are_the_single_device_bits(sharded, d, n):
    """``param_axis_sums`` on the shards is the single-device sum bit for
    bit, on every rank, and within float32 rounding of the float64 sum."""
    want = np.sum(sum_terms(d).astype(np.float64), axis=1)
    for r in sharded[n]:
        sharded_bits, whole_bits = r["sums"][d]
        assert sharded_bits == whole_bits
        got = np.frombuffer(whole_bits, np.float32)
        scale = np.sum(np.abs(sum_terms(d).astype(np.float64)), axis=1)
        np.testing.assert_array_less(np.abs(got - want), 1e-6 * scale + 1e-30)


def _reference_sharded_names(state) -> set:
    """The state fields whose reference spec ends in the mesh axis "d", by
    the port's field names ("ring/data", "psa/buffer", ...)."""
    specs = rsrv.server_state_specs(state, "d")
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(k.name for k in path) for path, spec in leaves
            if len(spec) and spec[-1] == "d"}


@pytest.mark.parametrize("n", RANKS, ids=[f"n{n}" for n in RANKS])
@pytest.mark.parametrize("case", ["fedpsa", "ca2fl", "fedbuff"])
def test_sharded_state_layout_contract(sharded, case, n):
    """Exactly the d-trailing tensors shard, each rank's a tensor of its
    own of d_pad / n elements; the rest keep the single-device shapes."""
    params = server_params(extra_bias=1)
    base = _reference(case, params)
    want = _reference_sharded_names(base.state)
    assert want >= {"params"}
    for lay in (r["layout"][case] for r in sharded[n]):
        d, d_pad = lay["d"], lay["d_pad"]
        assert d == 41 and d_pad % n == 0 and d <= d_pad < d + n
        assert {k for k, v in lay["specs"].items() if v} == want
        assert lay["specs"]["params"] == ("d",)
        for name, (shape, is_view, contiguous) in lay["fields"].items():
            assert contiguous and not is_view, name
            holder = base.state
            for part in name.split("/"):
                holder = getattr(holder, part)
            full = tuple(np.shape(holder))
            if name in want:
                assert shape == full[:-1] + (d_pad // n,), name
            else:
                assert shape == full, name


@pytest.mark.parametrize("n", RANKS, ids=[f"n{n}" for n in RANKS])
def test_sharded_server_rejects_bad_rules(sharded, n):
    for r in sharded[n]:
        assert r["bad_rules"] is not None and "param_shard" in r["bad_rules"]


RULES = [rsharding.FEDERATED_RULES.rules, rsharding.SINGLE_DEVICE_RULES.rules,
         rsharding.PRODUCTION_RULES.rules,
         {"a": ("x", "y"), "b": "y", "c": None, "e": ("y",)}]
LOGICAL = [("param_shard",), ("cohort",), ("param_shard", "cohort"),
           (None, "param_shard"), ("batch", "embed"), ("heads", "mlp"),
           ("a", "b"), ("b", "a"), ("a", "e"), ("c", None, "b"), ()]


@pytest.mark.parametrize("rules", range(len(RULES)),
                         ids=["federated", "single", "production", "mixed"])
def test_mesh_axes_match_reference(rules):
    ref = rsharding.LogicalRules(RULES[rules])
    port = tsharding.LogicalRules(RULES[rules])
    for axes in LOGICAL:
        assert port.mesh_axes(axes) == tuple(ref.mesh_axes(axes)), axes
    assert tsharding.FEDERATED_RULES.rules == rsharding.FEDERATED_RULES.rules
    assert tsharding.SINGLE_DEVICE_RULES.rules == {}


def test_make_fed_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_fed_mesh(2, device="cpu")


def test_cli_mesh_runs(tmp_path):
    """``--mesh 2 --device cpu``: two spawned gloo ranks; rank 0 writes
    ``..._mesh2.json`` with ``mesh_devices``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])}
    proc = run_command(
        [sys.executable, "-m", "repro_torch.launch.train", "--alg", "fedbuff",
         "--device", "cpu", "--mesh", "2", "--samples", "300", "--clients",
         "4", "--horizon", "1500", "--out", str(tmp_path)], env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (path,) = tmp_path.glob("fedbuff*_mesh2.json")
    rec = json.loads(path.read_text())
    assert rec["mesh_devices"] == 2 and rec["versions"] > 0
    assert 0.0 <= rec["final_accuracy"] <= 1.0
    assert proc.stdout.count("[train]") == 1      # rank 0 alone prints
