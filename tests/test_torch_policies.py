"""The port's staleness policies (``repro_torch.federated``) against the
JAX reference's (``repro.federated``), receive by receive.

The same numpy arrival stream goes to the reference's
``servers.make_server`` and to the port's; after every receive the flat
global vectors agree within rtol 1e-6, atol 1e-7, and the update flags,
versions and log entries agree. The cases are those of
``tests/test_policies.py`` (ring sizes 1, 3 and 4, ca2fl ``server_lr``,
fedfa ``beta``), plus asyncfeded's three metrics and fedpsa. Also: the
distance and magnitude-sketch helpers, ``make_hyper``'s names and errors,
the ca2fl ``client_id`` check, and that no policy writes a global vector
it has handed out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PSAConfig as RPSAConfig
from repro.core import aggregation as ragg
from repro.core import psa as rpsa
from repro.core import sketch as rsk
from repro.federated import policies as rpol
from repro.federated import servers as rsrv
from repro_torch.common.tree import FlatSpec
from repro_torch.core import aggregation as tagg
from repro_torch.core import psa as tpsa
from repro_torch.core import sketch as tsk
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import policies as tpol
from repro_torch.federated import servers as tsrv
from repro_torch.kernels import sens_sketch as tss
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
NUM_CLIENTS = 5


def _params(seed=0):
    """tests/test_policies.py's parameter tree, as numpy."""
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(6, 4) * 0.3).astype(np.float32),
            "b1": (rng.randn(4) * 0.1).astype(np.float32),
            "w2": (rng.randn(4, 3) * 0.3).astype(np.float32)}


def _stream(params, n, seed=1, k=None):
    """(delta, client_params, meta) triples in numpy, drawn as
    tests/test_policies.py draws them (deltas shrink like SGD updates)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        delta = {key: (rng.randn(*v.shape) * 0.05).astype(np.float32)
                 for key, v in sorted(params.items())}
        client = {key: params[key] + delta[key] for key in params}
        meta = {"tau": int(rng.randint(0, 4)),
                "client_id": int(rng.randint(NUM_CLIENTS)),
                "data_size": float(rng.randint(5, 50))}
        if k is not None:
            meta["sketch"] = rng.randn(k).astype(np.float32)
        out.append((delta, client, meta))
    return out


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _meta(meta, to):
    return {k: (to(v) if k == "sketch" else v) for k, v in meta.items()}


def _servers(name, params, kw, psa=None):
    """(reference server, port server) of one algorithm. fedpsa sketches
    the raw parameters (model-free, the same function on both sides)."""
    rkw, tkw = dict(kw), dict(kw)
    if psa is not None:
        rkw.update(psa_cfg=RPSAConfig(**psa), sketch_fn=jax.jit(
            lambda p: rsk.sketch_tree(p, 42, psa["sketch_k"])))
        tkw.update(psa_cfg=PSAConfig(**psa), sketch_fn=lambda p: tsk.sketch_tree(
            p, 42, psa["sketch_k"]))
    return (rsrv.make_server(name, _jax(params), num_clients=NUM_CLIENTS, **rkw),
            tsrv.make_server(name, _torch(params), num_clients=NUM_CLIENTS,
                             **tkw))


def _ring_n(L):
    """tests/test_policies.py's edge-case stream length: > 2L pushes, an
    exact multiple of L."""
    n = max(3 * L, 2 * L + 2)
    return n - n % L


CASES = {
    # tests/test_policies.py::test_policy_matches_legacy_trajectory
    "fedasync": ("fedasync", {"alpha": 0.6, "a": 0.5}, 25),
    "fedbuff": ("fedbuff", {"buffer_size": 4, "server_lr": 0.9}, 25),
    "ca2fl": ("ca2fl", {"buffer_size": 3, "server_lr": 0.8}, 25),
    "fedfa": ("fedfa", {"queue_len": 4, "beta": 0.5}, 25),
    "fedpac": ("fedpac", {"buffer_size": 3}, 25),
    # tests/test_policies.py::test_ring_buffer_edge_cases (L = 1, wrap)
    "fedbuff-L1": ("fedbuff", {"buffer_size": 1}, _ring_n(1)),
    "ca2fl-L1": ("ca2fl", {"buffer_size": 1}, _ring_n(1)),
    "fedfa-L1": ("fedfa", {"queue_len": 1}, _ring_n(1)),
    "fedpac-L1": ("fedpac", {"buffer_size": 1}, _ring_n(1)),
    "fedbuff-L3": ("fedbuff", {"buffer_size": 3}, _ring_n(3)),
    "ca2fl-L4": ("ca2fl", {"buffer_size": 4}, _ring_n(4)),
    "fedfa-L3": ("fedfa", {"queue_len": 3}, _ring_n(3)),
    # beta that is not a power of two: the recency weights round
    "fedfa-beta0.7": ("fedfa", {"queue_len": 4, "beta": 0.7}, 25),
    "fedasync-a1": ("fedasync", {"alpha": 0.4, "a": 1.0}, 25),
    "asyncfeded-l2": ("asyncfeded", {"alpha": 0.5}, 25),
    "asyncfeded-cosine": ("asyncfeded", {"alpha": 0.5, "metric": "cosine"}, 25),
    "asyncfeded-sketch": ("asyncfeded", {"alpha": 0.5, "metric": "sketch"}, 25),
    "fedpsa": ("fedpsa", {}, 24),
}
PSA = dict(buffer_size=3, queue_len=5, sketch_k=8)


def _close_entry(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w is None or isinstance(w, int):
            assert g == w, key
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_trajectory_matches_reference(case):
    name, kw, n = CASES[case]
    params = _params()
    psa = PSA if name == "fedpsa" else None
    ref, port = _servers(name, params, kw, psa)
    handed_out = []          # (global vector the port handed out, its values)
    updates = 0
    for delta, client, meta in _stream(params, n, k=psa and psa["sketch_k"]):
        u_ref = ref.receive(_jax(delta), _jax(client), _meta(meta, jnp.asarray))
        vec = port.flat_params
        handed_out.append((vec, vec.clone()))
        u_port = port.receive(_torch(delta), _torch(client),
                              _meta(meta, torch.from_numpy))
        assert u_port == u_ref
        updates += int(u_port)
        assert port.version == ref.version
        assert type(port.version) is int
        np.testing.assert_allclose(port.flat_params.numpy(),
                                   np.asarray(ref.flat_params),
                                   rtol=RTOL, atol=ATOL)
    assert updates == ref.version > 0
    if name == "fedfa":
        assert updates == n                  # a refresh on every arrival
    elif "buffer_size" in kw:
        assert updates == n // kw["buffer_size"]
    # snapshots are never written: every vector handed out kept its values
    for vec, was in handed_out:
        assert torch.equal(vec, was)
    log = port.host_log()
    assert len(log) == len(ref.log)
    for got, want in zip(log, ref.log):
        _close_entry(got, want)
    if name in ("fedasync", "asyncfeded"):
        assert len(log) == n and all(isinstance(e["weight"], float) for e in log)


@pytest.mark.parametrize("metric", tpsa.DISTANCE_METRICS)
def test_asyncfeded_metrics_damp_drifted_clients(metric):
    """tests/test_policies.py's distance-family check on both sides: a
    fresh client (w_i = w + dw) gets the full alpha under every metric, a
    drifted one is damped, and the port's coefficients are the
    reference's."""
    params = _params()
    delta, client, meta = _stream(params, 1)[0]
    far = {k: client[k] + 5.0 * params[k] for k in params}
    ref, port = _servers("asyncfeded", params, {"alpha": 0.5, "metric": metric})
    for c in (client, far):
        ref.receive(_jax(delta), _jax(c), meta)
        port.receive(_torch(delta), _torch(c), meta)
    got = [e["weight"] for e in port.host_log()]
    want = [e["weight"] for e in ref.log]
    assert abs(got[0] - 0.5) < 1e-5
    assert got[1] < 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert bool(torch.isfinite(port.flat_params).all())


def test_distance_scales_match_reference():
    """``distance_staleness_scale`` (both codes) and
    ``sketch_distance_scale`` on one drifted arrival, and the closed form
    of the l2 rule."""
    rng = np.random.RandomState(3)
    g, wi, dw = (rng.randn(300).astype(np.float32) for _ in range(3))
    J = [jnp.asarray(x) for x in (g, wi, dw)]
    T = [torch.from_numpy(x) for x in (g, wi, dw)]
    for mode in (tpsa.DIST_MODE_L2, tpsa.DIST_MODE_COSINE):
        want = rpsa.distance_staleness_scale(*J, alpha=jnp.float32(0.6),
                                             eps=jnp.float32(1e-8),
                                             dist_mode=jnp.float32(mode))
        got = tpsa.distance_staleness_scale(*T, alpha=0.6, eps=1e-8,
                                            dist_mode=mode)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    s = 0.6 * min(1.0, np.linalg.norm(dw) / (np.linalg.norm(wi - g) + 1e-8))
    np.testing.assert_allclose(
        float(tpsa.distance_staleness_scale(*T, alpha=0.6, eps=1e-8,
                                            dist_mode=0.0)), s, rtol=1e-6)
    for k in (4, 16):
        want = rpsa.sketch_distance_scale(*J, alpha=0.6, eps=1e-8, k=k, seed=42)
        got = tpsa.sketch_distance_scale(*T, alpha=0.6, eps=1e-8, k=k, seed=42)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("d", [1, 300, 4097])
@pytest.mark.parametrize("k", [1, 16, 32])
def test_magnitude_sketch_matches_reference(d, k):
    """The plain path of ``magnitude_sketch`` (``sens_sketch`` with g = 1,
    F = 0) against the reference's, within 1e-5 * sum|v| / sqrt(k) (the
    same terms summed in another order); and each row of the two-row form
    is the one-vector sketch of that row."""
    rng = np.random.RandomState(d + k)
    v = rng.randn(d).astype(np.float32)
    want = np.asarray(rpsa.magnitude_sketch(jnp.asarray(v), k=k, seed=42))
    got = tpsa.magnitude_sketch(torch.from_numpy(v), k=k, seed=42).numpy()
    tol = 1e-5 * np.abs(v).sum() / np.sqrt(k) + 1e-7
    assert got.shape == (k,)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    rows = torch.from_numpy(rng.randn(2, d).astype(np.float32))
    ones, zeros = tpsa._unit_rows(d, rows.device)
    two = tss.sens_sketch_rows(rows, ones, zeros,
                               tss.vector_table(d, 42, 0, k, rows.device))
    for r in range(2):
        np.testing.assert_allclose(
            two[r].numpy(), tpsa.magnitude_sketch(rows[r], k=k, seed=42).numpy(),
            rtol=1e-6, atol=1e-6)


def test_staleness_functions_match_reference():
    """Host float32 arithmetic against the reference's: the constant and
    the hinge bit for bit; the polynomial within rtol 1e-6 (numpy's and
    XLA's float32 pow can differ in the last bit)."""
    for tau in (0, 1, 3, 4, 5, 9, 40):
        for fn, kw in (("staleness_constant", {"alpha": 0.6}),
                       ("staleness_polynomial", {"alpha": 0.6, "a": 0.5}),
                       ("staleness_hinge", {"alpha": 0.6, "a": 10.0, "b": 4.0}),
                       ("staleness_hinge", {"alpha": 0.3, "a": 2.0, "b": 1.0})):
            want = float(getattr(ragg, fn)(tau, **kw))
            got = getattr(tagg, fn)(tau, **kw)
            assert isinstance(got, float)
            if fn == "staleness_polynomial":
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                assert got == want, (fn, tau, kw)


def test_make_hyper_names_and_errors_match_reference():
    for name, code in (("l2", tpsa.DIST_MODE_L2),
                       ("cosine", tpsa.DIST_MODE_COSINE)):
        assert tpol.make_hyper(dist_mode=name).dist_mode == code == \
            float(rpol.make_hyper(dist_mode=name).dist_mode)
    assert tpol.HYPER_FIELDS == rpol.HYPER_FIELDS
    defaults = tpol.make_hyper()
    for field, want in rpol.HYPER_DEFAULTS.items():
        assert getattr(defaults, field) == want, field
    for bad in (dict(dist_mode="sketch"), dict(dist_mode="manhattan"),
                dict(buffer_size=3), dict(sketch_k=16, alfa=1.0)):
        with pytest.raises(ValueError) as want:
            rpol.make_hyper(**bad)
        with pytest.raises(ValueError) as got:
            tpol.make_hyper(**bad)
        assert str(got.value) == str(want.value)
    spec = FlatSpec(_torch(_params()))
    with pytest.raises(ValueError, match="unknown distance metric"):
        tpol.asyncfeded_policy(spec, metric="manhattan")
    with pytest.raises(ValueError, match="sketch_k"):
        tpol.asyncfeded_policy(spec, metric="sketch", sketch_k=8)


def test_every_policy_is_ported():
    assert set(tpol.PORTED) == set(tpol.POLICY_NAMES) == set(rpol.POLICY_NAMES)
    spec = FlatSpec(_torch(_params()))
    for name in tpol.POLICY_NAMES:
        kw = {}
        if name == "fedpsa":
            kw = dict(psa_cfg=PSAConfig(), sketch_refresh=lambda v: v[:16])
        assert tpol.make_policy(name, spec, **kw).name == name
    with pytest.raises(ValueError, match="unknown staleness policy"):
        tpol.make_policy("fedsgd", spec)


def test_ca2fl_rejects_out_of_range_client_id():
    """tests/test_policies.py's check, on ``receive`` and on the batched
    ``receive_many``; the server's state is left as it was."""
    params = _params()
    srv = tsrv.make_server("ca2fl", _torch(params), num_clients=2)
    delta, client, meta = _stream(params, 1)[0]
    for cid in (5, -1):
        with pytest.raises(ValueError, match="client_id"):
            srv.receive(_torch(delta), _torch(client), {**meta, "client_id": cid})
    spec = srv.policy.spec
    rows = spec.flatten(_torch(delta))[None]
    with pytest.raises(ValueError, match="client_id"):
        srv.receive_many(rows, rows, [2], [1.0], [0])
    assert srv.state.ring.count == 0 and not srv.state.cache.valid.any()
    assert srv.receive(_torch(delta), _torch(client), {**meta, "client_id": 1}) \
        is False
