"""The population path of the port against the reference: lazy client
populations, the streaming slab store with its prefetch, and the streaming
cohort engine in every runner.

* ``SyntheticPopulation``, ``skewed_client_sizes``, ``_table_idx`` and the
  population presets are bit-equal to the reference's (two seeds);
* ``ClientSlabStore.gather`` returns the source's rows exactly, and its
  stats equal the reference store's over the same cid sequence: the LRU
  order, the prefetch paths (shard future, row block, stale key, an
  in-flight shard awaited), a list source; a worker's failure raises at
  ``gather``; the store holds no more than its resident bound;
* ``Timeline.peek_wave_cids`` returns the cids of the port's ``_pop_wave``
  and consumes nothing (the reference test's case and seeded random
  timelines);
* the reference's population scenarios, port against a live reference run
  at the golden suite's ``RTOL=1e-4, ATOL=1e-3`` from the committed init,
  for fedasync, fedbuff and fedpsa: the streaming engine with both member
  kernels (counters and the store's stats exact), the sequential engine
  (and the two engines agree), auto-streaming of a lazy population,
  ``run_sweep`` lanes, ``run_fedavg``; prefetch on against off and resume
  against the unbroken run bit-equal across evictions;
* the port's plain path reproduces ``tests/torch_fixtures/
  population_digests.json``, the reference's runs of the smoke presets
  that ``chip_smoke.py`` holds the card to (``reference_population_digests``
  makes it; ``tests/test_torch_slice.py`` checks it against the reference
  and regenerates it).
"""
import contextlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.configs import POPULATION_PRESETS as R_PRESETS
from repro.configs import get_config as rget
from repro.core import PSAConfig as RPSA
from repro.data import synthetic as rsyn
from repro.data.loader import ClientSlabStore as RStore
from repro.federated import SimConfig as RSim, run_algorithm as r_run
from repro.federated import timeline as rtl
from repro_torch import data as tdata
from repro_torch.configs import POPULATION_PRESETS, get_population_preset
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params, params_to_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.data.loader import ClientSlabStore
from repro_torch.federated import simulator as tsim
from repro_torch.federated import timeline as ttl
from repro_torch.federated.simulator import (SimConfig, SweepConfig,
                                             run_algorithm, run_sweep)
from torch_eval_digests import eval_digests
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
INIT = os.path.join(ROOT, "tests", "torch_fixtures",
                    "paper_synthetic_mlp_init_seed0.npz")
# the reference's digests of the smoke presets, which chip_smoke.py holds
# the card to (regenerate with `python tests/test_torch_slice.py`)
POP_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                           "population_digests.json")
MODEL = "paper-synthetic-mlp"
# the reference's tests/test_population.py world
C = 20
POP = dict(num_clients=C, num_classes=10, dim=32, seed=3,
           size_mean=24, size_spread=0.4, size_lo=8, size_hi=40)
SIM = dict(num_clients=C, horizon=2_500.0, eval_every=1_250.0, seed=0)
# forced multi-shard path: 5 shards, 2 resident, every touched shard cached
SHARDS = dict(shard_size=4, shard_cache=2, shard_promote=1)
# tests/test_golden.py's digest tolerance
RTOL, ATOL = 1e-4, 1e-3
POLICIES = ["fedasync", "fedbuff", "fedpsa"]
STAT_KEYS = ("hits", "row_fetches", "shard_loads", "evictions")
# The fixture's runs: the smoke presets at the reference population
# benchmark's dispatch load (latency U(100, 500), 2 local epochs, batch
# 32), horizons sized for about FIXTURE_RECEIVES receives, cohort engine
# under member_kernel="grouped", prefetch off.
FIXTURE_PRESETS = ("pop-smoke", "pop-1m-smoke")
FIXTURE_RECEIVES = 150
LATENCY_LO, LATENCY_HI = 100.0, 500.0


@pytest.fixture(scope="module")
def world():
    """Both packages' populations, test sets and calibration batches."""
    out = {}
    for key, lib in (("port", tdata), ("ref", rdata)):
        pop = lib.SyntheticPopulation(**POP)
        test = pop.test_dataset(512)
        out[key] = (pop, test, lib.make_calibration_batch(test, 64))
    return out


@contextlib.contextmanager
def built_stores(cls):
    """Record every store ``cls.build`` makes while the block runs."""
    made, orig = [], cls.build.__func__

    def spy(klass, datasets, **kw):
        made.append(orig(klass, datasets, **kw))
        return made[-1]

    cls.build = classmethod(spy)
    try:
        yield made
    finally:
        cls.build = classmethod(orig)


def _run(side, world, name, *, sweep=None, **kw):
    """One run of either package on ``world`` from the committed init."""
    pop, test, calib = world[side]
    psa = {}
    if name == "fedpsa":
        psa = dict(psa_cfg=(PSAConfig if side == "port" else RPSA)(),
                   calib_batch=calib)
    if side == "port":
        sim = SimConfig(device="cpu", **kw)
        args = (tget(MODEL), load_npz_params(INIT), pop, test, sim)
        if sweep is not None:
            return run_sweep(name, *args, SweepConfig(**sweep), **psa)
        return run_algorithm(name, *args, **psa)
    return r_run(name, rget(MODEL), params_to_numpy(load_npz_params(INIT)),
                 pop, test, RSim(**kw), **psa)


def _memo_runs(world, side):
    """Memoized runs of one package: ``get(name, **SimConfig fields)`` ->
    (result, the stats of the stores the run built)."""
    memo = {}
    store_cls = ClientSlabStore if side == "port" else RStore

    def get(name, **kw):
        key = (name, json.dumps(kw, sort_keys=True))
        if key not in memo:
            with built_stores(store_cls) as stores:
                res = _run(side, world, name, **kw)
            memo[key] = res, [s.stats for s in stores]
        return memo[key]

    return get


@pytest.fixture(scope="module")
def ref_runs(world):
    """Live reference runs, each made once for the module."""
    return _memo_runs(world, "ref")


@pytest.fixture(scope="module")
def port_runs(world):
    """The port's runs that several tests compare, each made once."""
    return _memo_runs(world, "port")


def _assert_digests(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.shape[0] > 10
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The numpy copies: population, hash, sizes, presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11])
def test_population_matches_reference(seed):
    kw = {**POP, "seed": seed}
    tp, rp = tdata.SyntheticPopulation(**kw), rdata.SyntheticPopulation(**kw)
    assert len(tp) == len(rp) == C and tp.n_max == rp.n_max
    assert tp.kind == rp.kind == "image" and tp.num_classes == rp.num_classes
    np.testing.assert_array_equal(tp.sizes, rp.sizes)
    for cids in ([0, 7, 13, 19], np.arange(C), [5]):
        for a, b in zip(tp.member_rows(cids), rp.member_rows(cids)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for c in (0, 9, C - 1):
        a, b = tp[c], rp[c]
        assert isinstance(a, tdata.ClientDataset) and len(a) == len(b)
        np.testing.assert_array_equal(a.data.x, b.data.x)
        np.testing.assert_array_equal(a.data.y, b.data.y)
        assert a.data.y.dtype == b.data.y.dtype
    a, b = tp.test_dataset(300), rp.test_dataset(300)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


def test_hash_and_sizes_match_reference():
    rng = np.random.RandomState(0)
    for shape in ((5,), (3, 4), (2, 3, 4)):
        parts = [rng.randint(0, 2**31, size=shape) for _ in range(4)]
        np.testing.assert_array_equal(tsyn._table_idx(*parts),
                                      rsyn._table_idx(*parts))
    np.testing.assert_array_equal(tsyn._table_idx(7, 0, 0, 3),
                                  rsyn._table_idx(7, 0, 0, 3))
    assert (tsyn._TABLE, tsyn._T_TEST) == (rsyn._TABLE, rsyn._T_TEST)
    for kw in (dict(mean=64, spread=0.6, lo=16, hi=512, seed=0),
               dict(mean=24, spread=0.4, lo=8, hi=40, seed=4),
               dict(mean=16, spread=1.5, lo=16, hi=16, seed=1)):
        got = tdata.skewed_client_sizes(5_000, **kw)
        np.testing.assert_array_equal(
            got, rdata.skewed_client_sizes(5_000, **kw))
        assert got.dtype == np.int64
    with pytest.raises(ValueError):
        tdata.skewed_client_sizes(10, mean=8, lo=16, hi=512)


def test_presets_match_reference():
    assert sorted(POPULATION_PRESETS) == sorted(R_PRESETS)
    for name, preset in POPULATION_PRESETS.items():
        assert preset.__dict__ == R_PRESETS[name].__dict__, name
        assert preset.sim_kwargs() == R_PRESETS[name].sim_kwargs()
        assert preset.resident_mb == R_PRESETS[name].resident_mb
    # the million-client bound: 4 x 1,024 x 128 rows of 132 bytes
    assert get_population_preset("pop-1m").resident_mb == 66.0
    pop = get_population_preset("pop-smoke").population(seed=2)
    want = R_PRESETS["pop-smoke"].population(seed=2)
    assert isinstance(pop, tdata.SyntheticPopulation)
    np.testing.assert_array_equal(pop.sizes, want.sizes)
    for a, b in zip(pop.member_rows([0, 100, 239]),
                    want.member_rows([0, 100, 239])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        get_population_preset("pop-2m")


# ---------------------------------------------------------------------------
# ClientSlabStore against the source rows and the reference store's stats
# ---------------------------------------------------------------------------

def _stores(world, **kw):
    return (ClientSlabStore(world["port"][0], **kw),
            RStore(world["ref"][0], **kw))


def _gather_both(world, store, rstore, cids):
    """Gather in both stores: the port's rows must be the source's, and
    its stats the reference store's."""
    x, y = store.gather(cids)
    want_x, want_y = world["port"][0].member_rows(cids)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(y.numpy(), want_y)
    rstore.gather(cids)
    assert store.stats == rstore.stats


def test_store_gather_matches_source_and_reference(world):
    """Every service path — cached shard, fresh shard load, row path and
    a mix — in input order, with the reference store's counts."""
    store, rstore = _stores(world, shard_size=5, cache_shards=2, promote=2)
    assert store.num_shards == rstore.num_shards == 4
    for cids in ([0, 1, 17, 6],        # shard 0 cached, 1 and 3 row path
                 [5, 6, 7],            # shard 1 promoted
                 [10, 11, 12, 3, 19],  # shard 2 promoted, evicts shard 0
                 [0, 18]):             # shard 0 gone: row path again
        _gather_both(world, store, rstore, cids)
    st = store.stats
    assert st["shard_loads"] == 3 and st["evictions"] == 1
    assert st["row_fetches"] > 0 and st["hits"] > 0
    assert st["resident_shards"] <= 2


def test_store_lru_order_matches_reference(world):
    store, rstore = _stores(world, shard_size=5, cache_shards=2, promote=2)
    for cids in ([0, 1], [5, 6], [0, 1], [10, 11]):   # shard 1 least recent
        _gather_both(world, store, rstore, cids)
    loads, hits = store.stats["shard_loads"], store.stats["hits"]
    _gather_both(world, store, rstore, [0, 2])        # shard 0 still cached
    assert store.stats["shard_loads"] == loads
    assert store.stats["hits"] == hits + 2
    _gather_both(world, store, rstore, [5, 6])        # shard 1 reloads
    assert store.stats["shard_loads"] == loads + 1
    assert list(store._cache) == list(rstore._cache)


def test_store_prefetch_paths_match_reference(world):
    """A correct prediction serves the next gather from the worker's
    shards and row block; a stale row block is dropped; cached shards are
    not re-issued — with the reference store's counts at every step."""
    store, rstore = _stores(world, shard_size=5, cache_shards=2, promote=2)
    for s in (store, rstore):
        s.prefetch([0, 1, 17])       # shard 0 by the worker, 17 row block
    _gather_both(world, store, rstore, [0, 1, 17])
    st = store.stats
    assert st["prefetch_issued"] == 3 and st["prefetch_hits"] == 3
    assert st["shard_loads"] == 1 and st["hits"] == 2
    assert st["row_fetches"] == 1 and st["prefetch_wasted"] == 0
    for s in (store, rstore):
        s.prefetch([6, 18])          # one row block, then another wave
    _gather_both(world, store, rstore, [6, 19])
    assert store.stats["prefetch_wasted"] == 1
    assert store.stats["prefetch_hits"] == 3
    issued = store.stats["prefetch_issued"]
    for s in (store, rstore):
        s.prefetch([0, 1, 2])        # shard 0 is resident
    assert store.stats["prefetch_issued"] == issued
    _gather_both(world, store, rstore, [0, 1, 2])
    st = store.stats
    assert 0.0 < st["hit_rate"] < 1.0
    assert abs(st["hit_rate"] + st["row_fetch_rate"] - 1.0) < 1e-12
    store.close()
    rstore._pool.shutdown(wait=True)


def test_store_prefetch_inflight_shard_awaited(world):
    """A gather that needs a shard whose prefetch may still be in flight
    waits for the worker instead of materializing it again."""
    store, rstore = _stores(world, shard_size=5, cache_shards=2, promote=2)
    for s in (store, rstore):
        s.prefetch([5, 6, 7])
    _gather_both(world, store, rstore, [5, 6, 7])
    st = store.stats
    assert st["shard_loads"] == 1 and st["prefetch_hits"] == 3
    store.close()
    rstore._pool.shutdown(wait=True)


def test_store_wraps_dataset_lists(world):
    """build() on a client-dataset list streams the rows the monolithic
    slab holds, and picks the reference's default geometry."""
    clients = [world["port"][0][c] for c in range(8)]
    slab = tdata.StackedClients.from_datasets(clients)
    store = ClientSlabStore.build(clients, shard_size=3, cache_shards=2,
                                  promote=1)
    cids = [7, 0, 4, 2]
    x, y = store.gather(cids)
    np.testing.assert_array_equal(x.numpy()[:, :slab.x.shape[1]],
                                  slab.x[cids])
    np.testing.assert_array_equal(y.numpy()[:, :slab.y.shape[1]],
                                  slab.y[cids])
    rclients = [world["ref"][0][c] for c in range(8)]
    assert ClientSlabStore.build(clients).shard_size == \
        RStore.build(rclients).shard_size == len(clients)


class _Failing:
    """A source whose rows fail to materialize past client 3."""
    kind, num_classes = "image", 10

    def __init__(self, pop):
        self.pop, self.sizes, self.n_max = pop, pop.sizes, pop.n_max

    def member_rows(self, cids):
        if np.max(cids) > 3:
            raise RuntimeError("materialization failed")
        return self.pop.member_rows(cids)


@pytest.mark.parametrize("cids", [[5, 6, 7], [9, 17]])
def test_store_worker_failure_raises(world, cids):
    """A prefetch that fails on the worker (a shard, a row block) raises at
    the gather that needs it, and the store does not load it again
    instead; one that no gather takes raises at ``close``."""
    store = ClientSlabStore(_Failing(world["port"][0]), shard_size=5,
                            cache_shards=2, promote=2)
    store.prefetch(cids)
    with pytest.raises(RuntimeError, match="materialization failed"):
        store.gather(cids)
    assert store.stats["shard_loads"] == 0
    store.close()
    store.prefetch(cids)
    with pytest.raises(RuntimeError, match="materialization failed"):
        store.close()
    store.close()


@pytest.mark.parametrize("prefetch", [False, True])
def test_store_holds_its_resident_bound(world, prefetch):
    """Over random waves of up to 8 members the cached shards never exceed
    ``cache_shards * shard_size`` clients' rows; without prefetch the store
    never holds more than that plus one wave's row block."""
    pop = world["port"][0]
    rng = np.random.RandomState(5)
    store = ClientSlabStore(pop, shard_size=4, cache_shards=2, promote=2)
    assert store.row_bytes == pop.n_max * (POP["dim"] * 4 + 4)
    waves = [rng.choice(C, size=rng.randint(1, 9), replace=False)
             for _ in range(30)]
    for i, cids in enumerate(waves):
        store.gather(cids)
        assert store.device_bytes <= 2 * 4 * store.row_bytes
        if prefetch and i + 1 < len(waves):
            store.prefetch(waves[i + 1])
    assert store.stats["evictions"] > 0 and store.stats["row_fetches"] > 0
    assert store.peak_bytes >= store.device_bytes > 0
    if not prefetch:
        assert store.peak_bytes <= (2 * 4 + 8) * store.row_bytes
    store.close()


# ---------------------------------------------------------------------------
# Timeline.peek_wave_cids
# ---------------------------------------------------------------------------

def test_peek_wave_matches_reference_case():
    """The reference test's case (strict bound, cap over all events, the
    horizon, the ok filter), on both timelines, consuming nothing."""
    t = np.array([10.0, 12.0, 19.9, 20.0, 25.0])
    ok = np.array([True, False, True, True, True])
    for mod in (ttl, rtl):
        tl = mod.Timeline()
        tl.extend_arrays(t, np.arange(5), np.array([3, 4, 5, 6, 7]),
                         np.zeros(5, np.int64), ok, [None] * 5)
        np.testing.assert_array_equal(tl.peek_wave_cids(10.0, 256, 1e9),
                                      [3, 5])
        assert len(tl) == 5
        np.testing.assert_array_equal(tl.peek_wave_cids(10.0, 2, 1e9), [3])
        assert tl.peek_wave_cids(10.0, 256, 5.0).size == 0
        np.testing.assert_array_equal(tl.peek_wave_cids(10.0, 256, 11.0), [3])
        assert [tl.pop().cid for _ in range(5)] == [3, 4, 5, 6, 7]


@pytest.mark.parametrize("seed", [0, 1])
def test_peek_wave_matches_pop_wave(seed):
    """On seeded random timelines (several runs, ties in t, dropouts), the
    peek equals the ok cids of the port's ``_pop_wave`` — and the
    reference's peek — before every wave, and pops nothing."""
    rng = np.random.RandomState(seed)
    for _ in range(20):
        tl, rl = ttl.Timeline(), rtl.Timeline()
        seq = 0
        for _run in range(rng.randint(1, 6)):
            n = rng.randint(1, 40)
            t = np.round(rng.uniform(0, 300, n), 0)   # ties included
            args = (t, np.arange(seq, seq + n), rng.randint(0, 50, n),
                    np.zeros(n, np.int64), rng.rand(n) < 0.8)
            seq += n
            tl.extend_arrays(*args, [None] * n)
            rl.extend_arrays(*args, [None] * n)
        sim = SimConfig(latency_lo=float(rng.choice([5.0, 30.0, 100.0])),
                        max_cohort=int(rng.choice([3, 16, 256])),
                        horizon=float(rng.choice([150.0, 1e9])))
        while tl:
            n = len(tl)
            peek = tl.peek_wave_cids(sim.latency_lo, sim.max_cohort,
                                     sim.horizon)
            np.testing.assert_array_equal(
                peek, rl.peek_wave_cids(sim.latency_lo, sim.max_cohort,
                                        sim.horizon))
            assert len(tl) == n
            wave, t_over = tsim._pop_wave(tl, sim)
            tsim._pop_wave(rl, sim)
            np.testing.assert_array_equal(
                peek, np.asarray([e.cid for e in wave if e.ok], np.int64))
            if t_over is not None or not wave:
                break


# ---------------------------------------------------------------------------
# The reference's population scenarios, port against a live reference run
# ---------------------------------------------------------------------------

# the scenarios' streaming runs: cohort engine over the forced
# multi-shard store, digests recorded
STREAM = dict(engine="cohort", record_trajectory=True, **SHARDS, **SIM)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("mk", ["vmap", "grouped"])
def test_streaming_matches_reference(ref_runs, port_runs, name, mk):
    """Forced multi-shard streaming: digests at the golden tolerance,
    counters and the store's stats exact."""
    want, want_stats = ref_runs(name, **STREAM)
    got, stats = port_runs(name, **STREAM, **(
        {"member_kernel": mk} if mk != "vmap" else {}))
    _assert_digests(got.digests, want.digests)
    for key in ("versions", "dispatches", "cohorts", "launched", "dropped"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.cohorts > 0 and got.engine == "cohort"
    assert stats == want_stats and stats[0]["evictions"] > 0


@pytest.mark.parametrize("name", POLICIES)
def test_sequential_matches_reference_and_streaming(world, ref_runs,
                                                    port_runs, name):
    """The sequential oracle takes a population's clients through
    ``__getitem__`` and agrees with the streaming engine: the port's
    sequential run matches the reference's live streaming run (which the
    reference's own suite holds to its sequential one) and the port's
    streaming run."""
    got = _run("port", world, name, **{**STREAM, "engine": "sequential"})
    assert got.engine == "sequential"
    _assert_digests(got.digests, ref_runs(name, **STREAM)[0].digests)
    assert got.dispatches == ref_runs(name, **STREAM)[0].dispatches
    _assert_digests(port_runs(name, **STREAM)[0].digests, got.digests)


def test_auto_streaming(world, ref_runs, monkeypatch):
    """A lazy population with ``shard_size=0`` streams (a population cannot
    be stacked), and no code path takes ``len()`` of every client."""
    kw = dict(engine="cohort", record_trajectory=True, **SIM)
    want, want_stats = ref_runs("fedasync", **kw)
    monkeypatch.setattr(tdata.SyntheticPopulation, "__getitem__", None)
    with built_stores(ClientSlabStore) as stores:
        got = _run("port", world, "fedasync", **kw)
    (store,) = stores
    assert store.source is world["port"][0]
    assert store.shard_size == C           # the reference's default
    _assert_digests(got.digests, want.digests)
    assert store.stats == want_stats[0]


@pytest.mark.parametrize("name", POLICIES)
def test_sweep_matches_reference(world, ref_runs, port_runs, name):
    """Sweep lanes ride the streaming engine: lane 0 matches the
    reference's live run of its configuration, each lane equals the port's
    standalone run of its data seed on the shared timeline (the lane
    tolerance, rtol 1e-5 / atol 1e-4), the reseeded lane differs, and the
    wave's rows are gathered once for all lanes, so the store's stats are
    the standalone run's (as the reference's lanes share their rows)."""
    want, want_stats = ref_runs(name, **STREAM)
    with built_stores(ClientSlabStore) as stores:
        got = _run("port", world, name, sweep=dict(data_seeds=[0, 7]),
                   **STREAM)
    _assert_digests(got.digests[0], want.digests)
    assert stores[0].stats == want_stats[0]
    solos = (port_runs(name, **STREAM)[0],
             _run("port", world, name, **{**STREAM, "seed": 7,
                                          "timeline_seed": 0}))
    for lane, solo in enumerate(solos):
        np.testing.assert_allclose(np.asarray(got.digests[lane]),
                                   np.asarray(solo.digests), rtol=1e-5,
                                   atol=1e-4)
    assert not np.array_equal(np.asarray(got.digests[1]),
                              np.asarray(got.digests[0]))


@pytest.mark.parametrize("engine", ["cohort", "sequential"])
def test_fedavg_matches_reference(world, engine):
    """``run_fedavg`` over a population (sizes from ``.sizes``, rows
    streamed per round, or clients through ``__getitem__`` on the
    sequential engine) against the reference's live streaming run, with
    the digest of every evaluated model."""
    kw = dict(shard_size=8, num_clients=C, horizon=1_500.0,
              eval_every=150.0, seed=0)
    with eval_digests() as seen:
        want = _run("ref", world, "fedavg", engine="cohort", **kw)
        got = _run("port", world, "fedavg", engine=engine, **kw)
    assert len(seen["port"]) == len(seen["ref"]) > 5
    np.testing.assert_allclose(seen["port"], seen["ref"], rtol=RTOL,
                               atol=ATOL)
    for key in ("versions", "dispatches", "launched"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.cohorts == (want.cohorts if engine == "cohort" else 0)
    np.testing.assert_allclose(got.accuracies, want.accuracies, atol=1e-6)


# a one-shard cache that cycles through evictions
EVICTING = {**STREAM, "shard_cache": 1}


@pytest.mark.parametrize("name", POLICIES)
def test_prefetch_bit_equal_across_eviction(world, ref_runs, port_runs,
                                            name):
    """Prefetch is a pure overlap hint: with a one-shard cache that cycles
    through evictions, the run with it is bit-equal to the run without,
    and the worker really served waves."""
    _, want_stats = ref_runs(name, **EVICTING)
    base, (st_base,) = port_runs(name, **EVICTING)
    with built_stores(ClientSlabStore) as stores:
        pre = _run("port", world, name, prefetch=True, **EVICTING)
    st_pre = stores[0].stats
    assert st_base == want_stats[0]
    assert st_pre["evictions"] > 0
    assert st_pre["prefetch_issued"] > 0 and st_pre["prefetch_hits"] > 0
    np.testing.assert_array_equal(np.asarray(pre.digests),
                                  np.asarray(base.digests))
    assert pre.accuracies == base.accuracies
    assert (pre.dispatches, pre.cohorts) == (base.dispatches, base.cohorts)
    assert stores[0]._pool is None           # the run closed its worker


def _prune_to_mid_run(ckdir, total_dispatches):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
    mid = [s for s in steps if 0 < s < total_dispatches]
    assert mid, steps
    for s in steps:
        if s > mid[-1]:
            shutil.rmtree(os.path.join(ckdir, f"step_{s:08d}"))


@pytest.mark.parametrize("name", POLICIES)
def test_resume_across_eviction(world, port_runs, tmp_path, name):
    """A streaming run whose one-shard cache loads some shard twice,
    checkpointed and resumed from a mid-run snapshot, reproduces the
    unbroken digest stream bit for bit (the checkpoint holds no store
    state; the resumed run rebuilds the store)."""
    kw = EVICTING
    base, (stats,) = port_runs(name, **kw)
    # more loads than the population has shards: some shard loaded twice
    assert stats["shard_loads"] > -(-C // kw["shard_size"])
    ckdir = str(tmp_path / name)
    ck = _run("port", world, name, checkpoint_dir=ckdir,
              checkpoint_every=800.0, **kw)
    np.testing.assert_array_equal(np.asarray(ck.digests),
                                  np.asarray(base.digests))
    _prune_to_mid_run(ckdir, base.dispatches)
    res = _run("port", world, name, checkpoint_dir=ckdir,
               checkpoint_every=800.0, resume=True, **kw)
    np.testing.assert_array_equal(np.asarray(res.digests),
                                  np.asarray(base.digests))
    assert (res.dispatches, res.launched) == (base.dispatches, base.launched)


# ---------------------------------------------------------------------------
# The card's fixture: the smoke presets, as the reference runs them
# ---------------------------------------------------------------------------

def fixture_sim(preset_name: str) -> dict:
    """The SimConfig fields of a fixture run: the preset's, at the
    reference population benchmark's dispatch load (its ``horizon_for``
    sizing), prefetch off."""
    preset = get_population_preset(preset_name)
    mean_lat = 0.5 * (LATENCY_LO + LATENCY_HI)
    horizon = LATENCY_LO + FIXTURE_RECEIVES * mean_lat / preset.n_inflight
    return {**preset.sim_kwargs(), "prefetch": False, "local_epochs": 2,
            "batch_size": 32, "latency_lo": LATENCY_LO,
            "latency_hi": LATENCY_HI, "horizon": horizon,
            "eval_every": horizon / 2, "eval_batches": 2, "seed": 0,
            "engine": "cohort", "member_kernel": "grouped",
            "record_trajectory": True}


def _fixture_world(side: str, preset_name: str):
    lib, presets = ((tdata, POPULATION_PRESETS) if side == "port"
                    else (rdata, R_PRESETS))
    pop = presets[preset_name].population(seed=0)
    test = pop.test_dataset(512)
    return {side: (pop, test, lib.make_calibration_batch(test, 64))}


def reference_population_digests() -> dict:
    """The reference's runs of the fixture: per preset and policy the
    digest stream, the final counters and the store's stats."""
    out = {"model": MODEL, "init": os.path.basename(INIT), "runs": {}}
    for preset in FIXTURE_PRESETS:
        sim = fixture_sim(preset)
        w = _fixture_world("ref", preset)
        runs = out["runs"][preset] = {"sim": sim}
        for name in POLICIES:
            with built_stores(RStore) as stores:
                res = _run("ref", w, name, **sim)
            (store,) = stores
            runs[name] = {
                "digests": np.asarray(res.digests).tolist(),
                "final": {"final_accuracy": res.final_accuracy,
                          "versions": res.versions,
                          "dispatches": res.dispatches,
                          "cohorts": res.cohorts, "launched": res.launched,
                          "dropped": res.dropped},
                "stats": {k: store.stats[k] for k in STAT_KEYS}}
    return out


def load_population_fixture() -> dict:
    with open(POP_FIXTURE) as fh:
        return json.load(fh)


def check_population_fixture(fixture: dict, want: dict) -> None:
    """``fixture`` holds ``want``'s runs: digests at the golden tolerance,
    counters and store stats exact, accuracies within 2e-3; and its runs
    cross evictions and the row path."""
    assert fixture["model"] == want["model"] == MODEL
    for preset in FIXTURE_PRESETS:
        got_runs, want_runs = fixture["runs"][preset], want["runs"][preset]
        assert got_runs["sim"] == want_runs["sim"]
        for name in POLICIES:
            got, ref = got_runs[name], want_runs[name]
            _assert_digests(got["digests"], ref["digests"])
            assert got["stats"] == ref["stats"]
            assert got["stats"]["evictions"] > 0
            assert got["stats"]["row_fetches"] > 0 or preset == "pop-smoke"
            for key, v in ref["final"].items():
                if key == "final_accuracy":
                    np.testing.assert_allclose(got["final"][key], v,
                                               atol=2e-3)
                else:
                    assert got["final"][key] == v, key


@pytest.mark.parametrize("preset", FIXTURE_PRESETS)
def test_port_reproduces_population_fixture(preset):
    """The port's plain path (``member_kernel="grouped"`` on the CPU) gives
    the fixture's digests, counters and store stats."""
    fixture = load_population_fixture()["runs"][preset]
    w = _fixture_world("port", preset)
    for name in POLICIES:
        with built_stores(ClientSlabStore) as stores:
            res = _run("port", w, name, **fixture["sim"])
        want = fixture[name]
        _assert_digests(res.digests, want["digests"])
        for key in ("versions", "dispatches", "cohorts", "launched",
                    "dropped"):
            assert getattr(res, key) == want["final"][key], key
        assert {k: stores[0].stats[k] for k in STAT_KEYS} == want["stats"]
