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
from repro.kernels.grouped_matmul import grouped_matmul_pallas
from repro.kernels.sens_sketch import sens_sketch_pallas
from repro_torch.core import sketch as tsk
from repro_torch.kernels import buffer_agg as tba
from repro_torch.kernels import grouped_matmul as tgm
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


def _rel_err(got, want):
    """max |got - want| / max |want|: the reference suite's relative
    measure (the two sides accumulate K terms in different orders)."""
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _gm_inputs(G, M, K, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(G, M, K).astype(np.float32),
            rng.randn(G, K, N).astype(np.float32))


# the four shapes of tests/test_grouped_matmul.py::test_kernel_vs_ref
GM_SHAPES = [(1, 8, 16, 16), (3, 130, 200, 96), (5, 1, 7, 3), (4, 32, 256, 64)]


@pytest.mark.parametrize("G,M,K,N", GM_SHAPES)
def test_grouped_matmul_plain_matches_reference(G, M, K, N):
    a, b = _gm_inputs(G, M, K, N, G * 1000 + K)
    got = tgm.grouped_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (G, M, N) and got.dtype == torch.float32
    want_pallas = grouped_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True)
    want_ref = ref.grouped_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    assert _rel_err(got.numpy(), want_pallas) < 1e-5
    assert _rel_err(got.numpy(), want_ref) < 1e-5
    # the transposed views the backward passes give the same values
    bt = torch.from_numpy(np.ascontiguousarray(b.transpose(0, 2, 1)))
    assert _rel_err(tgm.grouped_matmul(torch.from_numpy(a),
                                       bt.transpose(1, 2)).numpy(),
                    got.numpy()) < 1e-6


def test_grouped_matmul_valid_zero_groups_are_exact_zeros():
    a, b = _gm_inputs(4, 16, 64, 32, 0)
    a[3] = np.inf                         # garbage in a masked slot
    valid = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    got = tgm.grouped_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(valid)).numpy()
    want = np.asarray(grouped_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                            valid=jnp.asarray(valid),
                                            interpret=True))
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(got[3], 0.0)
    for g in (0, 2):
        assert _rel_err(got[g], want[g]) < 1e-5


@pytest.mark.parametrize("dtypes", [("bfloat16", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "bfloat16")])
def test_grouped_matmul_dtype_promotion(dtypes):
    a, b = _gm_inputs(2, 8, 16, 8, 3)
    (ja, ta), (jb, tb) = _pair(a, dtypes[0]), _pair(b, dtypes[1])
    got = tgm.grouped_matmul(ta, tb)
    want = grouped_matmul_pallas(ja, jb, interpret=True)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < 5e-3
    assert _rel_err(got.float().numpy(),
                    np.asarray(ref.grouped_matmul_ref(ja, jb), np.float32)) < 5e-3


# (G, M, N, K) -> (S, slice): the cohort main path's fc0 forward, dW and dx
# at G = 4 and 8, fc1's forward, the edge shapes and long-K cases
SPLIT_K = {(4, 64, 384, 4096): (11, 384), (8, 64, 384, 4096): (6, 704),
           (4, 4096, 384, 64): (1, 64), (8, 4096, 384, 64): (1, 64),
           (4, 64, 4096, 384): (1, 384), (8, 64, 4096, 384): (1, 384),
           (4, 64, 192, 384): (1, 384), (1, 8, 16, 16): (1, 32),
           (3, 130, 96, 200): (1, 224), (5, 1, 3, 7): (1, 32),
           (4, 32, 64, 256): (1, 256), (2, 64, 64, 530): (1, 544),
           (2, 64, 64, 600): (2, 320), (3, 40, 72, 5000): (10, 512)}


@pytest.mark.parametrize("shape", sorted(SPLIT_K))
def test_grouped_matmul_split_k_is_pinned(shape):
    """The split count is a function of the shape alone: pinned values,
    S >= 1, S = 1 for short K, the same on repeated calls, slices that
    cover K and are each at least MIN_SLICE deep (the last one too)."""
    G, M, N, K = shape
    S, depth = tgm.split_k(G, M, N, K)
    assert (S, depth) == SPLIT_K[shape] == tgm.split_k(G, M, N, K)
    assert S >= 1 and depth % tgm.SLAB == 0
    assert (S - 1) * depth < K <= S * depth
    if K < 2 * tgm.MIN_SLICE:
        assert S == 1
    if S > 1:
        assert K - (S - 1) * depth >= tgm.MIN_SLICE
        tiles = G * -(-M // tgm.TILE) * -(-N // tgm.TILE)
        assert tiles < 2 * tgm.SMS


@pytest.mark.parametrize("bad", ["shape", "dtype", "k", "device_mix",
                                 "gm_shape", "gm_dtype", "gm_valid"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.ones(8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            tba.buffer_agg(torch.ones(3), x, torch.ones(2, 8))
        elif bad == "dtype":
            tss.sens_sketch(x.double(), x.double(), x.double())
        elif bad == "k":
            tss.sens_sketch(x, x, x, k=8)
        elif bad == "device_mix":
            tba.buffer_agg(torch.ones(1), x, torch.ones(1, 8, device="meta"))
        elif bad == "gm_shape":
            tgm.grouped_matmul(torch.ones(2, 3, 4), torch.ones(2, 5, 6))
        elif bad == "gm_dtype":
            tgm.grouped_matmul(torch.ones(2, 3, 4, dtype=torch.float64),
                               torch.ones(2, 4, 6, dtype=torch.float64))
        else:
            tgm.grouped_matmul(torch.ones(2, 3, 4), torch.ones(2, 4, 6),
                               torch.ones(3))


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


@pytest.mark.gpu
def test_grouped_matmul_cuda_matches_plain_on_card():
    """The grouped kernel against its plain version on the card at the
    main path's fc0 shapes (forward, dW and dx through transposed views),
    the edge shapes and a long K split ten ways with K not a multiple of
    the slice; valid-zero groups exactly zero, also through the split's
    second pass with inf in a masked group; bf16 promotion; repeated runs
    bit-identical (fixed K order and a fixed-order split sum, no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    T = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    x, w = T(rng.randn(4, 64, 4096).astype(np.float32)), \
        T(rng.randn(4, 4096, 384).astype(np.float32))
    g = T(rng.randn(4, 64, 384).astype(np.float32))
    cases = [(x, w), (x.transpose(1, 2), g), (g, w.transpose(1, 2))]
    cases += [tuple(T(v) for v in _gm_inputs(*s, 7)) for s in GM_SHAPES]
    assert tgm.split_k(3, 40, 72, 5000) == (10, 512)
    cases.append(tuple(T(v) for v in _gm_inputs(3, 40, 5000, 72, 8)))
    for a, b in cases:
        got = tgm.grouped_matmul(a, b)
        assert _rel_err(got.cpu().numpy(),
                        tgm.grouped_matmul_plain(a, b).cpu().numpy()) < 1e-5
        assert torch.equal(got, tgm.grouped_matmul(a, b))
    valid = T(np.array([1.0, 0.0, 1.0, 0.0], np.float32))
    assert tgm.split_k(4, 64, 384, 4096)[0] > 1
    xm = x.clone()
    xm[3] = float("inf")                   # garbage in a masked group
    got = tgm.grouped_matmul(xm, w, valid)
    assert bool((got[1] == 0).all()) and bool((got[3] == 0).all())
    assert _rel_err(got.cpu().numpy(), tgm.grouped_matmul_plain(
        xm, w, valid).cpu().numpy()) < 1e-5
    assert torch.equal(got, tgm.grouped_matmul(xm, w, valid))
    out = tgm.grouped_matmul(x[:, :8, :64].bfloat16(), w[:, :64, :8])
    assert out.dtype == torch.float32
    assert _rel_err(out.cpu().numpy(), tgm.grouped_matmul_plain(
        x[:, :8, :64].bfloat16(), w[:, :64, :8]).cpu().numpy()) < 1e-5
