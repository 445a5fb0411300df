"""The port's kernel modules against the JAX reference's oracles.

Inputs are made with numpy from a seed and handed to both sides. On the
CPU the port's wrappers run their plain versions; the reference runs its
``kernels/ref.py`` oracles and its Pallas kernels in interpret mode. The
CUDA kernels themselves run only on a card: the ``gpu``-marked test holds
them against the plain versions there
(``python -m pytest -m gpu tests/test_torch_kernels.py``).
"""
import dataclasses
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
from repro_torch.common.tree import FlatSpec
from repro_torch.configs import get_config as tget
from repro_torch.core import sketch as tsk
from repro_torch.kernels import buffer_agg as tba
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sens_sketch as tss
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401


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


NARROW_CNN = dict(cnn_channels=(4, 8), input_hw=(8, 8, 3), mlp_hidden=(16,))


def _narrow_cnn_spec():
    """FlatSpec of a narrow CIFAR CNN (10 leaves, 4 to 800 elements)."""
    cfg = dataclasses.replace(tget("paper-cifar10-cnn"), **NARROW_CNN)
    return FlatSpec(TM.init_params(torch.Generator().manual_seed(0), cfg))


@pytest.mark.parametrize("k", [4, 16])
def test_sens_sketch_rows_plain_matches_reference(k):
    """The batched leaf-table form (``ops.sketch_flat``: all members and
    leaves in one call) against the reference's ``ops.sketch_tree_fused``
    (interpret-mode Pallas, one launch per leaf) member by member, on a
    narrow CNN's layout; tolerance the sum of the leaves' ``_sketch_tol``
    (the two sum the same terms in different orders)."""
    spec = _narrow_cnn_spec()
    B, d = 2, spec.size
    rng = np.random.RandomState(k)
    w, g = rng.randn(B, d).astype(np.float32), rng.randn(B, d).astype(np.float32)
    f = np.abs(rng.randn(B, d)).astype(np.float32)
    got = tops.sketch_flat(spec, *(torch.from_numpy(x) for x in (w, g, f)),
                           k=k, seed=5).numpy()
    assert got.shape == (B, k) and got.dtype == np.float32
    for b in range(B):
        trees = [jax.tree_util.tree_map(
            np.asarray, spec.unflatten(torch.from_numpy(x[b]))) for x in (w, g, f)]
        want = np.asarray(rops.sketch_tree_fused(*trees, k=k, seed=5))
        tol = sum(_sketch_tol(w[b, o:o + n], g[b, o:o + n], f[b, o:o + n], k)
                  for o, n in zip(spec.offsets, spec.sizes))
        assert np.max(np.abs(got[b] - want)) <= tol


def test_sens_sketch_rows_honours_index_offset():
    """A one-leaf table hashed from ``index_offset`` (``vector_table``)
    through the rows entry equals the reference's per-shard
    ``sens_sketch_pallas`` (interpret mode) at that offset."""
    d, lo = 1500, 3333
    theta, g, f = _sketch_inputs(d, 8)
    table = tss.vector_table(d, 11, lo, 16, "cpu")
    got = tss.sens_sketch_rows(*(torch.from_numpy(x)[None]
                                 for x in (theta, g, f)), table)[0].numpy()
    want = np.asarray(sens_sketch_pallas(
        *(jnp.asarray(x) for x in (theta, g, f)), k=16, seed=11,
        index_offset=lo, interpret=True))
    assert np.max(np.abs(got - want)) <= _sketch_tol(theta, g, f, 16)


def _kernel_hash_signs(tiles, k):
    """The CUDA kernel's hash algebra emulated in numpy uint32 on its tile
    records: per step base state + (v*k + r)*A, the seed folded into the
    inner hash's last xor, the outer hash stopped at its multiply, the sign
    read from bit 31. Returns the (element, row) signs in layout order."""
    A, C, Bm = np.uint32(747796405), np.uint32(2891336453), np.uint32(277803737)

    def word(state):
        return ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * Bm

    out = []
    with np.errstate(over="ignore"):
        for off, n, seed, state0 in tiles.tolist():
            e = np.arange(n, dtype=np.uint32)
            st = np.uint32(state0) + e * np.uint32(k * 747796405 % 2 ** 32)
            r = np.arange(k, dtype=np.uint32)
            w1 = word(st[:, None] + r[None, :] * A)
            w2 = word(((w1 >> np.uint32(22)) ^ w1 ^ np.uint32(seed)) * A + C)
            out.append(np.where(w2 >> np.uint32(31), -1.0, 1.0))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4, 16, 32])
def test_kernel_tile_hash_matches_rademacher_rows(k):
    """The kernel's tile records and hash algebra give the reference's
    signs (``rademacher_row``) at every element of a layout whose leaves
    span several tiles, tails and a hash base (index_offset)."""
    sizes, bases = (5, 2048, 4100, 1), (0, 0, 0, 70000)
    seeds = [tsk.leaf_seed_host(9, i) for i in range(len(sizes))]
    offs = np.cumsum((0,) + sizes[:-1])
    leaves = list(zip(offs.tolist(), sizes, seeds, bases))
    tiles = tss.tile_records(leaves, k, tile=1024)
    assert tiles.shape == (1 + 2 + 5 + 1, 4)
    assert np.all(tiles[:, 1] <= 1024) and tiles[:, 1].sum() == sum(sizes)
    got = _kernel_hash_signs(tiles, k)
    want = np.concatenate([
        np.stack([tsk.rademacher_row(sd, (torch.arange(n) + b) & 0xFFFFFFFF,
                                     r, k).numpy() for r in range(k)], axis=1)
        for (_, n, sd, b) in leaves])
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(tiles, tss.tile_records(leaves, k, tile=1024))


@pytest.mark.parametrize("k", [1, 4, 16])
def test_sens_sketch_rows_exact_sign_case_is_bit_equal(k):
    """theta = 1, F = 0 and integer g in [-3, 3]: every partial sum is an
    integer below 2**24, so any summation order gives the same bits. The
    leaf-table form then equals the per-leaf one-vector plain sums bit for
    bit (k in {1, 4, 16}: power-of-two scales, applied once instead of per
    leaf); a single wrong sign would move it by 2/sqrt(k)."""
    spec = _narrow_cnn_spec()
    B = 3
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randint(-3, 4, (B, spec.size)).astype(np.float32))
    t, f = torch.ones_like(g), torch.zeros_like(g)
    got = tops.sketch_flat(spec, t, g, f, k=k, seed=42)
    table = tss.layout_table(spec.sizes, 42, k, "cpu")
    want = torch.stack([sum(tss.sens_sketch_plain(
        t[b, o:o + n], g[b, o:o + n], f[b, o:o + n], k=k, seed=sd)
        for o, n, sd, _ in table.leaves) for b in range(B)])
    assert torch.equal(got, want)
    assert torch.equal(got, tss.sens_sketch_rows_plain(t, g, f, table))


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


# (M, N, K) -> (S, slice): the cohort main path's fc0 forward, dW and dx,
# fc1's forward, the CNN's conv weight gradients (conv0, conv1 at 64 and
# 32 images), the edge shapes and long-K cases
SPLIT_K = {(64, 384, 4096): (11, 384), (4096, 384, 64): (1, 64),
           (64, 4096, 384): (1, 384), (64, 192, 384): (1, 384),
           (64, 75, 65536): (33, 2016), (64, 1600, 16384): (3, 5472),
           (64, 75, 32768): (32, 1024), (64, 1600, 8192): (3, 2752),
           (8, 16, 16): (1, 32), (130, 96, 200): (1, 224), (1, 3, 7): (1, 32),
           (32, 64, 256): (1, 256), (64, 64, 530): (1, 544),
           (64, 64, 600): (2, 320), (40, 72, 5000): (10, 512)}


@pytest.mark.parametrize("shape", sorted(SPLIT_K))
def test_grouped_matmul_split_k_is_pinned(shape):
    """The split count is a function of one group's shape alone (so a
    member's sums do not depend on the wave's width G): pinned values,
    S >= 1, S = 1 for short K, the same on repeated calls, slices that
    cover K and are each at least MIN_SLICE deep (the last one too)."""
    M, N, K = shape
    S, depth = tgm.split_k(M, N, K)
    assert (S, depth) == SPLIT_K[shape] == tgm.split_k(M, N, K)
    assert S >= 1 and depth % tgm.SLAB == 0
    assert (S - 1) * depth < K <= S * depth
    if K < 2 * tgm.MIN_SLICE:
        assert S == 1
    if S > 1:
        assert K - (S - 1) * depth >= tgm.MIN_SLICE
        tiles = tgm.FILL_GROUPS * -(-M // tgm.TILE) * -(-N // tgm.TILE)
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
def test_sens_sketch_rows_cuda_matches_plain_on_card():
    """The kernel's one-launch form against its plain version on the card:
    the full-width CIFAR CNN layout (10 leaves, rows of 1,756,426 elements,
    so every odd member's rows are not 16-byte aligned) as one tree and as
    waves of 3 and 8 members, every k, within ``_sketch_tol`` per member,
    with bit-identical repeats; and the exact-sign case (theta = 1, F = 0,
    integer g in [-3, 3]: integer partial sums below 2**24), bit-equal for
    k in {1, 4, 16} and within one ulp for k = 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = tget("paper-cifar10-cnn")
    spec = FlatSpec(TM.init_params(torch.Generator().manual_seed(0), cfg))
    rng = np.random.RandomState(2)
    for B, ks in ((1, tss.KS), (3, tss.KS), (8, (16,))):
        w, g = rng.randn(B, spec.size).astype(np.float32), \
            rng.randn(B, spec.size).astype(np.float32)
        f = np.abs(rng.randn(B, spec.size)).astype(np.float32)
        T = [torch.from_numpy(x).to(dev) for x in (w, g, f)]
        for k in ks:
            table = tss.layout_table(spec.sizes, 42, k, str(dev))
            got = tss.sens_sketch_rows(*T, table)
            want = tss.sens_sketch_rows_plain(*T, table)
            for b in range(B):
                assert float((got[b] - want[b]).abs().max()) <= \
                    _sketch_tol(w[b], g[b], f[b], k)
            assert torch.equal(got, tss.sens_sketch_rows(*T, table))
    gi = torch.from_numpy(rng.randint(-3, 4, (3, spec.size)).astype(
        np.float32)).to(dev)
    t, f0 = torch.ones_like(gi), torch.zeros_like(gi)
    for k in tss.KS:
        table = tss.layout_table(spec.sizes, 42, k, str(dev))
        got = tss.sens_sketch_rows(t, gi, f0, table)
        want = tss.sens_sketch_rows_plain(t, gi, f0, table)
        dist = (got.view(torch.int32).long() - want.view(torch.int32).long())
        ulps = int(torch.where(got == want, 0, dist.abs()).max())
        assert ulps <= (1 if k == 32 else 0), (k, ulps)


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
    assert tgm.split_k(40, 72, 5000) == (10, 512)
    cases.append(tuple(T(v) for v in _gm_inputs(3, 40, 5000, 72, 8)))
    for a, b in cases:
        got = tgm.grouped_matmul(a, b)
        assert _rel_err(got.cpu().numpy(),
                        tgm.grouped_matmul_plain(a, b).cpu().numpy()) < 1e-5
        assert torch.equal(got, tgm.grouped_matmul(a, b))
    valid = T(np.array([1.0, 0.0, 1.0, 0.0], np.float32))
    assert tgm.split_k(64, 384, 4096)[0] > 1
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
