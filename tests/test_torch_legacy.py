"""The port's legacy class-based servers (``repro_torch.federated.legacy``)
against the reference's (``repro.federated.legacy``), and the port's
policies against the port's legacy servers, on the CPU.

* Reference against port: the same numpy arrival stream
  (``tests/test_policies.py``'s parameters, stream and kwargs) goes to the
  reference's ``legacy.make_legacy_server`` and to the port's; every
  receive returns the same flag, the versions agree exactly, the global
  parameters within 1e-6 (both apply one float32 tree op at a time, in the
  same order), and the logs agree (fedasync's weights, FedPSA's weights,
  kappas and temperature) within 1e-6.
* Port policy against port legacy: every case of ``tests/test_policies.py``
  repeated on the port (the five policies' trajectories, the stacked-ring
  edge cases, FedPSA's trajectory and log, its ablations) at that file's
  1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PSAConfig as RPSAConfig
from repro.core import sketch as rsk
from repro.federated import legacy as rlegacy
from repro_torch.core import sketch as tsk
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import legacy as tlegacy
from repro_torch.federated import servers as tsrv
from torch_threads import one_torch_thread  # noqa: F401

REF_TOL = 1e-6     # port legacy vs reference legacy
POLICY_TOL = 1e-5  # tests/test_policies.py's policy vs legacy
NUM_CLIENTS = 5


def _params(seed=0):
    """tests/test_policies.py's parameter tree, as numpy."""
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(6, 4) * 0.3).astype(np.float32),
            "b1": (rng.randn(4) * 0.1).astype(np.float32),
            "w2": (rng.randn(4, 3) * 0.3).astype(np.float32)}


def _stream(params, n, seed=1, k=None):
    """tests/test_policies.py's arrival stream in numpy: its deltas are
    drawn leaf by leaf in the tree's sorted-key order."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        delta = {key: (rng.randn(*params[key].shape) * 0.05).astype(np.float32)
                 for key in sorted(params)}
        client = {key: params[key] + delta[key] for key in params}
        meta = {"tau": int(rng.randint(0, 4)),
                "client_id": int(rng.randint(NUM_CLIENTS)),
                "data_size": float(rng.randint(5, 50))}
        if k is not None:
            meta["sketch"] = rng.randn(k).astype(np.float32)
        out.append((delta, client, meta))
    return out


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _meta(meta, to):
    return {k: (to(v) if k == "sketch" else v) for k, v in meta.items()}


def _gap(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for k in a)


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def _sketch_fns(seed, k):
    """The raw-parameter sketch (model-free) on each side."""
    return (jax.jit(lambda p: rsk.sketch_tree(p, seed, k)),
            lambda p: tsk.sketch_tree(p, seed, k))


def _ring_n(L):
    """tests/test_policies.py's edge-case stream length: > 2L pushes, an
    exact multiple of L."""
    n = max(3 * L, 2 * L + 2)
    return n - n % L


# tests/test_policies.py::test_policy_matches_legacy_trajectory
TRAJECTORY = [
    ("fedasync", {"alpha": 0.6, "a": 0.5}),
    ("fedbuff", {"buffer_size": 4, "server_lr": 0.9}),
    ("ca2fl", {"buffer_size": 3, "server_lr": 0.8}),
    ("fedfa", {"queue_len": 4, "beta": 0.5}),
    ("fedpac", {"buffer_size": 3}),
]
# tests/test_policies.py::test_ring_buffer_edge_cases
RING = [
    ("fedbuff", {"buffer_size": 1}, 1),
    ("ca2fl", {"buffer_size": 1}, 1),
    ("fedfa", {"queue_len": 1}, 1),
    ("fedpac", {"buffer_size": 1}, 1),
    ("fedbuff", {"buffer_size": 3}, 3),
    ("ca2fl", {"buffer_size": 4}, 4),
    ("fedfa", {"queue_len": 3}, 3),
]
# tests/test_policies.py's FedPSA cases: (PSAConfig kwargs, sketch seed,
# stream length)
PSA_TRAJECTORY = (dict(buffer_size=3, queue_len=5, sketch_k=8), 0, 24)
PSA_ABLATIONS = [(dict(buffer_size=2, queue_len=3, sketch_k=8,
                       use_thermometer=False), 7, 10),
                 (dict(buffer_size=2, queue_len=3, sketch_k=8,
                       server_lr=0.7), 7, 10)]

REF_CASES = (
    {f"{n}-traj": (n, kw, 25, None) for n, kw in TRAJECTORY}
    | {f"{n}-L{L}": (n, kw, _ring_n(L), None) for n, kw, L in RING}
    | {"fedbuff-a1": ("fedbuff", {"buffer_size": 4, "a": 1.0}, 25, None),
       "fedfa-beta0.7": ("fedfa", {"queue_len": 4, "beta": 0.7}, 25, None),
       "fedpsa": ("fedpsa", {}, PSA_TRAJECTORY[2], PSA_TRAJECTORY),
       "fedpsa-noT": ("fedpsa", {}, 10, PSA_ABLATIONS[0]),
       "fedpsa-lr0.7": ("fedpsa", {}, 10, PSA_ABLATIONS[1])})


def _legacy_pair(name, params, kw, psa):
    """(reference legacy server, port legacy server) of one case."""
    rkw, tkw = dict(kw), dict(kw)
    if psa is not None:
        cfg, seed, _ = psa
        rfn, tfn = _sketch_fns(seed, cfg["sketch_k"])
        rkw.update(psa_cfg=RPSAConfig(**cfg), sketch_fn=rfn)
        tkw.update(psa_cfg=PSAConfig(**cfg), sketch_fn=tfn)
    return (rlegacy.make_legacy_server(name, _jax(params),
                                       num_clients=NUM_CLIENTS, **rkw),
            tlegacy.make_legacy_server(name, _torch(params),
                                       num_clients=NUM_CLIENTS, **tkw))


@pytest.mark.parametrize("case", list(REF_CASES))
def test_legacy_server_matches_reference_legacy(case):
    name, kw, n, psa = REF_CASES[case]
    params = _params()
    ref, port = _legacy_pair(name, params, kw, psa)
    k = None if psa is None else psa[0]["sketch_k"]
    updates = 0
    for delta, client, meta in _stream(params, n, k=k):
        u_ref = ref.receive(_jax(delta), _jax(client), _meta(meta, jnp.asarray))
        u_port = port.receive(_torch(delta), _torch(client),
                              _meta(meta, torch.from_numpy))
        assert u_ref == u_port
        assert ref.version == port.version
        assert _gap(_np(ref.params), _np(port.params)) < REF_TOL
        updates += int(u_port)
    assert port.version == updates > 0
    assert type(port).__name__ == type(ref).__name__
    assert len(port.log) == len(ref.log)
    for e_r, e_p in zip(ref.log, port.log):
        assert set(e_r) == set(e_p)
        for key in e_r:
            if key == "temp" and e_r[key] is None:
                assert e_p[key] is None
            elif key == "tau":
                assert e_p[key] == e_r[key]
            else:
                np.testing.assert_allclose(e_p[key], e_r[key], rtol=REF_TOL,
                                           atol=REF_TOL)
    if name == "fedpsa":
        temps = [e["temp"] for e in port.log]
        assert isinstance(port.log[0]["weights"], np.ndarray)
        if psa[0].get("use_thermometer", True):
            # the uniform phase, then the softmax once the queue is full
            assert temps[0] is None and temps[-1] is not None
        else:
            assert all(t == pytest.approx(5.5) for t in temps)


def _policy_pair(name, kw, psa=None):
    params = _torch(_params())
    kw = dict(kw)
    if name == "ca2fl":
        kw["num_clients"] = NUM_CLIENTS
    if psa is not None:
        cfg, seed, _ = psa
        kw.update(psa_cfg=PSAConfig(**cfg),
                  sketch_fn=_sketch_fns(seed, cfg["sketch_k"])[1])
    return (tlegacy.make_legacy_server(name, params, **kw),
            tsrv.make_server(name, params, **kw))


def _port_stream(n, k=None):
    return [(_torch(d), _torch(c), _meta(m, torch.from_numpy))
            for d, c, m in _stream(_params(), n, k=k)]


def _port_gap(a, b) -> float:
    return max(float((a[key] - b[key]).abs().max()) for key in a)


@pytest.mark.parametrize("name,kwargs", TRAJECTORY)
def test_policy_matches_legacy_trajectory(name, kwargs):
    legacy, policy = _policy_pair(name, kwargs)
    for delta, client, meta in _port_stream(25):
        assert legacy.receive(delta, client, meta) == policy.receive(
            delta, client, meta)
        assert _port_gap(legacy.params, policy.params) < POLICY_TOL
    assert legacy.version == policy.version > 0


@pytest.mark.parametrize("name,kwargs,L", RING)
def test_ring_buffer_edge_cases(name, kwargs, L):
    """A stream whose length is an exact multiple of L (the buffer exactly
    full at the final flush) and longer than 2L (slot indices wrap at least
    twice), against the port's deque/list oracles."""
    legacy, policy = _policy_pair(name, kwargs)
    n = _ring_n(L)
    flushes = 0
    for delta, client, meta in _port_stream(n):
        u_legacy = legacy.receive(delta, client, meta)
        u_policy = policy.receive(delta, client, meta)
        assert u_legacy == u_policy
        flushes += int(u_policy)
        assert _port_gap(legacy.params, policy.params) < POLICY_TOL
    assert legacy.version == policy.version
    assert flushes == (n if name == "fedfa" else n // L)


def test_fedpsa_policy_matches_legacy_trajectory():
    legacy, policy = _policy_pair("fedpsa", {}, PSA_TRAJECTORY)
    for delta, client, meta in _port_stream(24, k=8):
        assert legacy.receive(delta, client, meta) == policy.receive(
            delta, client, meta)
        assert _port_gap(legacy.params, policy.params) < POLICY_TOL
    assert legacy.version == policy.version > 0
    # logs agree: the same uniform -> softmax switch, the same weights
    log = policy.host_log()
    assert len(legacy.log) == len(log)
    for e_l, e_p in zip(legacy.log, log):
        assert (e_l["temp"] is None) == (e_p["temp"] is None)
        np.testing.assert_allclose(e_l["weights"], e_p["weights"],
                                   atol=POLICY_TOL)
        np.testing.assert_allclose(e_l["kappas"], e_p["kappas"],
                                   atol=POLICY_TOL)


@pytest.mark.parametrize("psa", PSA_ABLATIONS, ids=["no-thermometer", "lr0.7"])
def test_fedpsa_ablations_match_legacy(psa):
    legacy, policy = _policy_pair("fedpsa", {}, psa)
    for delta, client, meta in _port_stream(10, k=8):
        legacy.receive(delta, client, meta)
        policy.receive(delta, client, meta)
        assert _port_gap(legacy.params, policy.params) < POLICY_TOL


def test_fedpsa_legacy_needs_its_config_and_sketch():
    params = _torch(_params())
    with pytest.raises(ValueError, match="psa_cfg and sketch_fn"):
        tlegacy.make_legacy_server("fedpsa", params, psa_cfg=PSAConfig())
    assert tlegacy.FedPACLiteServer.client_align == 0.1
    assert tlegacy.FedPSAServer.needs_sketch
    assert not tlegacy.FedBuffServer.needs_sketch


def test_legacy_servers_never_write_a_tree_they_were_given():
    """The global trees the servers hand out stay as they were after later
    receives (a dispatch snapshot), as the reference's immutable arrays."""
    for name, kw in TRAJECTORY:
        legacy, _ = _policy_pair(name, kw)
        snaps = []
        for delta, client, meta in _port_stream(12):
            legacy.receive(delta, client, meta)
            snaps.append((legacy.params,
                          {k: v.clone() for k, v in legacy.params.items()}))
        for tree, copy in snaps:
            assert all(torch.equal(tree[k], copy[k]) for k in tree), name
