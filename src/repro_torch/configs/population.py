"""Population presets: named geometries for population-scale simulation.

A preset bundles the three knobs a population-scale run has to agree on —
the lazy client population (``data.synthetic.SyntheticPopulation``), the
streaming-slab geometry (``SimConfig.shard_size/shard_cache/shard_promote``)
and the dispatch load (a FIXED absolute in-flight count, so cells at
different C run comparable device waves and per-dispatch cost is an
apples-to-apples number). A copy of the reference's
``repro.configs.population`` with the same presets and numbers;
``pop-smoke`` and ``pop-1m-smoke`` are the small cells (tiny C,
deliberately fragmented shards so the chunked path and the LRU eviction
are exercised, not bypassed).

Memory model: resident client data is O(shard_cache * shard_size * n_max)
plus O(C) metadata (sizes, latency means), never the O(C * n_max)
monolithic slab.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PopulationPreset:
    num_clients: int
    # streaming-slab geometry (SimConfig.shard_*)
    shard_size: int = 512
    shard_cache: int = 8
    shard_promote: int = 8
    # absolute number of concurrently-training clients (NOT a fraction:
    # the bench holds this fixed across C so waves stay comparable)
    n_inflight: int = 1024
    # overlap the next wave's shard/row materialization + H2D upload with
    # device compute (SimConfig.prefetch; results bit-identical either way)
    prefetch: bool = False
    # population shape (SyntheticPopulation)
    num_classes: int = 10
    dim: int = 32
    size_mean: int = 64
    size_spread: float = 0.5
    size_lo: int = 16
    size_hi: int = 128

    def population(self, seed: int = 0):
        from repro_torch.data.synthetic import SyntheticPopulation
        return SyntheticPopulation(
            self.num_clients, self.num_classes, self.dim, seed=seed,
            size_mean=self.size_mean, size_spread=self.size_spread,
            size_lo=self.size_lo, size_hi=self.size_hi)

    def sim_kwargs(self) -> dict:
        """The SimConfig fields a preset pins (merge with run-specific
        horizon/eval/engine settings)."""
        return dict(num_clients=self.num_clients,
                    concurrency=self.n_inflight / self.num_clients,
                    shard_size=self.shard_size,
                    shard_cache=self.shard_cache,
                    shard_promote=self.shard_promote,
                    prefetch=self.prefetch)

    @property
    def resident_mb(self) -> float:
        """The contract's data-memory bound for this geometry (float32
        features + int32 labels), independent of num_clients."""
        rows = self.shard_cache * self.shard_size * self.size_hi
        return rows * (self.dim * 4 + 4) / 2**20


POPULATION_PRESETS = {
    # the reference benchmark's baseline / headline pair
    "pop-5k": PopulationPreset(5_000),
    "pop-100k": PopulationPreset(100_000),
    # the million-client preset; same resident bound as pop-100k. At C=1M a
    # <=256-member wave spreads over ~977 shards and essentially never
    # crosses the promote threshold, so the row path serves everything —
    # prefetch overlaps those row-block materializations (and any shard
    # loads) with device compute.
    "pop-1m": PopulationPreset(1_000_000, shard_size=1024, shard_cache=4,
                               prefetch=True),
    # smoke: tiny C but FORCED multi-shard chunked path (8 shards,
    # 2-resident LRU, promote=1 so shards actually cache and evict)
    "pop-smoke": PopulationPreset(240, shard_size=32, shard_cache=2,
                                  shard_promote=1, n_inflight=48,
                                  size_mean=24, size_lo=8, size_hi=40),
    # smoke in the pop-1m shape: prefetch on over a fragmented
    # multi-shard cache (16 shards, 2-resident LRU) whose promote=4
    # threshold both caches shards (eviction-crossing) and leaves a
    # row-path residue, so every prefetch path — shard futures, row
    # blocks, stale-key fallback — runs
    "pop-1m-smoke": PopulationPreset(2_000, shard_size=128, shard_cache=2,
                                     shard_promote=4, n_inflight=128,
                                     size_mean=24, size_lo=8, size_hi=40,
                                     prefetch=True),
}


def get_population_preset(name: str) -> PopulationPreset:
    if name not in POPULATION_PRESETS:
        raise KeyError(f"unknown population preset {name!r}; "
                       f"known: {sorted(POPULATION_PRESETS)}")
    return POPULATION_PRESETS[name]
