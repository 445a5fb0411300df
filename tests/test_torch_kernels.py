"""The port's kernel modules against the JAX reference's oracles.

Inputs are made with numpy from a seed and handed to both sides. On the
CPU the port's wrappers run their plain versions; the reference runs its
``kernels/ref.py`` oracles and its Pallas kernels in interpret mode. The
CUDA kernels themselves run only on a card: the ``gpu``-marked test holds
them against the plain versions there
(``python -m pytest -m gpu tests/test_torch_kernels.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as rsk
from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.buffer_agg import buffer_agg_pallas
from repro.kernels.sens_sketch import sens_sketch_pallas
from repro_torch.core import sketch as tsk
from repro_torch.kernels import buffer_agg as tba
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sens_sketch as tss


def _pair(x, dtype):
    """The same numpy values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)))


def _sketch_inputs(d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(d).astype(np.float32), rng.randn(d).astype(np.float32),
            np.abs(rng.randn(d)).astype(np.float32))


def _sketch_tol(theta, g, f, k):
    """|delta| <= 1e-5 * sum|s| / sqrt(k) + 1e-7: the two sides sum the same
    terms in different orders."""
    t, gg, ff = (np.asarray(x, np.float64) for x in (theta, g, f))
    return 1e-5 * np.sum(np.abs(gg * t - 0.5 * ff * t * t)) / math.sqrt(k) + 1e-7


@pytest.mark.parametrize("seed", [0, 42, 0xDEADBEEF, 2 ** 32 - 1])
def test_pcg_hash_and_signs_bit_identical(seed):
    rng = np.random.RandomState(seed % (2 ** 31))
    x = np.concatenate([np.arange(50_000, dtype=np.uint64),
                        rng.randint(0, 2 ** 32, size=50_000, dtype=np.uint64)])
    want = np.asarray(rsk.pcg_hash(jnp.asarray(x.astype(np.uint32))))
    got = tsk.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    lin = np.arange(100_000, dtype=np.uint32)
    for r, k in ((0, 1), (3, 4), (15, 16), (31, 32)):
        want = np.asarray(rsk.rademacher_row(jnp.uint32(seed), jnp.asarray(lin),
                                             r, k))
        got = tsk.rademacher_row(seed, torch.from_numpy(lin.astype(np.int64)),
                                 r, k).numpy()
        np.testing.assert_array_equal(got, want)
    for i in range(12):
        assert tsk.leaf_seed_host(seed, i) == rsk.leaf_seed_host(seed, i) \
            == int(rsk.leaf_seed(seed, i))


@pytest.mark.parametrize("d", [1, 7, 512, 1024, 4097, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sens_sketch_plain_matches_reference(d, dtype):
    theta, g, f = _sketch_inputs(d, d)
    (jt, tt), (jg, tg), (jf, tf) = (_pair(x, dtype) for x in (theta, g, f))
    got = tss.sens_sketch(tt, tg, tf, k=16, seed=3).numpy()
    f32 = [np.asarray(x.astype(jnp.float32)) for x in (jt, jg, jf)]
    tol = _sketch_tol(*f32, 16)
    want_ref = np.asarray(ref.sens_sketch_ref(*(jnp.asarray(x) for x in f32),
                                              k=16, seed=3))
    want_pallas = np.asarray(sens_sketch_pallas(jt, jg, jf, k=16, seed=3,
                                                block=1024, interpret=True))
    assert got.shape == (16,) and got.dtype == np.float32
    assert np.max(np.abs(got - want_ref)) <= tol
    assert np.max(np.abs(got - want_pallas)) <= tol


@pytest.mark.parametrize("k", [1, 4, 16, 32])
def test_sens_sketch_plain_k_sweep(k):
    theta, g, f = _sketch_inputs(3000, 100 + k)
    got = tss.sens_sketch(*(torch.from_numpy(x) for x in (theta, g, f)),
                          k=k, seed=0).numpy()
    want = np.asarray(sens_sketch_pallas(*(jnp.asarray(x) for x in (theta, g, f)),
                                         k=k, seed=0, block=512, interpret=True))
    assert got.shape == (k,)
    assert np.max(np.abs(got - want)) <= _sketch_tol(theta, g, f, k)


def test_sens_sketch_index_offset_matches_reference_shards():
    """Per-shard sketches with ``index_offset`` equal the reference's
    per-shard sketches, and sum to the full-vector sketch."""
    d = 4096 + 640
    theta, g, f = _sketch_inputs(d, 3)
    T = [torch.from_numpy(x) for x in (theta, g, f)]
    J = [jnp.asarray(x) for x in (theta, g, f)]
    full = tss.sens_sketch(*T, k=16, seed=11).numpy()
    tol = _sketch_tol(theta, g, f, 16)
    for nshards in (2, 4):
        bounds = np.linspace(0, d, nshards + 1).astype(int)
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            got = tss.sens_sketch(*(x[lo:hi] for x in T), k=16, seed=11,
                                  index_offset=int(lo)).numpy()
            want = np.asarray(sens_sketch_pallas(
                *(x[lo:hi] for x in J), k=16, seed=11, index_offset=int(lo),
                interpret=True))
            assert np.max(np.abs(got - want)) <= tol
            parts.append(got)
        assert np.max(np.abs(sum(parts) - full)) <= tol


def test_sketch_tree_fused_matches_reference():
    """Whole-tree fused sketch (one launch per leaf, per-leaf seeds) against
    the reference's ``ops.sketch_tree_fused`` on the same numpy tree."""
    rng = np.random.RandomState(0)
    shapes = {"a": {"w": (40, 30), "b": (30,)}, "c": {"w": (55,)}}
    mk = lambda: {k: {kk: rng.randn(*s).astype(np.float32)  # noqa: E731
                      for kk, s in v.items()} for k, v in shapes.items()}
    p, g = mk(), mk()
    f = {k: {kk: np.abs(x) for kk, x in v.items()} for k, v in mk().items()}
    to_t = lambda t: {k: {kk: torch.from_numpy(x) for kk, x in v.items()}  # noqa: E731
                      for k, v in t.items()}
    got = tops.sketch_tree_fused(to_t(p), to_t(g), to_t(f), k=16, seed=5).numpy()
    want = np.asarray(rops.sketch_tree_fused(p, g, f, k=16, seed=5))
    leaves = [(p[a][b], g[a][b], f[a][b]) for a in sorted(p) for b in sorted(p[a])]
    tol = sum(_sketch_tol(*lf, 16) for lf in leaves)
    assert np.max(np.abs(got - want)) <= tol


@pytest.mark.parametrize("L,d", [(1, 64), (5, 3000), (8, 8193), (20, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_buffer_agg_plain_matches_reference(L, d, dtype):
    rng = np.random.RandomState(L * d)
    w = np.exp(rng.randn(L)).astype(np.float32)
    w /= w.sum()
    gv, ups = rng.randn(d).astype(np.float32), rng.randn(L, d).astype(np.float32)
    (jg, tg), (ju, tu) = _pair(gv, dtype), _pair(ups, dtype)
    got = tba.buffer_agg(torch.from_numpy(w), tg, tu)
    assert got.dtype == torch.float32 and got.shape == (d,)
    want_ref = np.asarray(ref.buffer_agg_ref(jnp.asarray(w), jg, ju))
    want_pallas = np.asarray(buffer_agg_pallas(jnp.asarray(w), jg, ju,
                                               block=1024, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-6, atol=1e-6)


def test_buffer_agg_writes_a_fresh_output():
    g = torch.arange(6, dtype=torch.float32)
    before = g.clone()
    out = tba.buffer_agg(torch.ones(2), g, torch.ones(2, 6))
    assert out.data_ptr() != g.data_ptr()
    assert torch.equal(g, before)
    assert torch.equal(out, before + 2.0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "k", "device_mix"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.ones(8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            tba.buffer_agg(torch.ones(3), x, torch.ones(2, 8))
        elif bad == "dtype":
            tss.sens_sketch(x.double(), x.double(), x.double())
        elif bad == "k":
            tss.sens_sketch(x, x, x, k=8)
        else:
            tba.buffer_agg(torch.ones(1), x, torch.ones(1, 8, device="meta"))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, and the
    sketch's repeated runs bit-identical (the kernel reduces in a fixed
    order, without atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    for L, d in ((5, 1_756_426), (8, 8193), (1, 64)):
        w = torch.softmax(torch.from_numpy(rng.randn(L).astype(np.float32)), 0).to(dev)
        g = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
        u = torch.from_numpy(rng.randn(L, d).astype(np.float32)).to(dev)
        want = tba.buffer_agg_plain(w, g, u)
        got = tba.buffer_agg(w, g, u)
        tol = 1e-6 * (1.0 + float(want.abs().max())) * L
        assert float((got - want).abs().max()) <= tol
    for d in (1, 7, 4097, 1_572_864):
        for k in tss.KS:
            theta, g, f = _sketch_inputs(d, d + k)
            T = [torch.from_numpy(x).to(dev) for x in (theta, g, f)]
            got = tss.sens_sketch(*T, k=k, seed=9)
            want = tss.sens_sketch_plain(*T, k=k, seed=9)
            assert float((got - want).abs().max()) <= _sketch_tol(theta, g, f, k)
            assert torch.equal(got, tss.sens_sketch(*T, k=k, seed=9))
