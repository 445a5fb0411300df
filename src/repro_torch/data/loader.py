"""Client-side data loading: shuffled epoch batches.

``epoch_batch_indices`` is a copy of the reference's one shuffle routine,
so the port visits exactly the batches the reference's per-client loop
would (same ``RandomState`` stream, same drop-last rule).
``StackedClients`` is the cohort engine's padded all-clients slab;
``ClientSlabStore`` the streaming one (fixed-size client shards behind a
bounded LRU, for populations too large to stack).

Both views take the registry's two data kinds (``data_kind_of``): image
shards hold ``x (n, ...) float32`` features and ``y (n,) int`` labels and
batch as ``{"x", "y"}``; token shards (federated LM fine-tuning) hold ``x =
y = (n, seq) int32`` token sequences and batch as ``{"tokens",
"labels"}``, the keys the token family's loss reads.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticClassification


def data_kind_of(x: np.ndarray) -> str:
    """The registry data kind a feature array implies: integer dtypes are
    token-id sequences, everything else image/feature rows."""
    return "tokens" if np.issubdtype(np.asarray(x).dtype, np.integer) \
        else "image"


def _x_dtype(kind: str):
    """Host dtype of a slab's features: int32 tokens or float32 rows."""
    return np.int32 if kind == "tokens" else np.float32


def epoch_batch_indices(n: int, num_epochs: int, batch_size: int,
                        seed: int) -> np.ndarray:
    """Batch schedule for one client: ``(steps, bs)`` int32 indices into its
    ``n`` samples, ``bs = min(batch_size, n)``, drop-last, one fresh
    permutation per epoch from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    m = n // bs                       # drop-last batch count per epoch
    out = np.empty((num_epochs * m, bs), np.int32)
    for e in range(num_epochs):
        out[e * m:(e + 1) * m] = rng.permutation(n)[:m * bs].reshape(m, bs)
    return out


def batch_iterator(ds, batch_size: int, seed: int = 0) -> Iterator[dict]:
    """Endless shuffled batches of ``ds`` (host numpy, the reference's
    stream): every batch has exactly ``batch_size`` rows, so each epoch's
    last ``n % batch_size`` rows of its permutation are dropped, and
    ``batch_size > n`` yields nothing."""
    rng = np.random.RandomState(seed)
    n = len(ds)
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            yield {"x": ds.x[idx].astype(np.float32),
                   "y": ds.y[idx].astype(np.int32)}


@dataclass
class ClientDataset:
    data: SyntheticClassification

    def __len__(self):
        return len(self.data)

    @property
    def kind(self) -> str:
        return data_kind_of(self.data.x)

    def epochs(self, num_epochs: int, batch_size: int, seed: int) -> Iterator[dict]:
        """Host batches in schedule order: ``{"x": float32, "y": int32}``,
        or ``{"tokens", "labels"}`` (both int32) for token data."""
        tokens = self.kind == "tokens"
        for idx in epoch_batch_indices(len(self.data), num_epochs,
                                       batch_size, seed):
            if tokens:
                yield {"tokens": self.data.x[idx].astype(np.int32),
                       "labels": self.data.y[idx].astype(np.int32)}
            else:
                yield {"x": self.data.x[idx].astype(np.float32),
                       "y": self.data.y[idx].astype(np.int32)}


@dataclass
class StackedClients:
    """All clients' data as one padded slab (the cohort engine's layout),
    the reference's ``repro.data.loader.StackedClients``.

    ``x[c, :sizes[c]]`` are client ``c``'s real samples; rows beyond that
    are zero padding. Padding never reaches a loss term: the batch
    schedules index only real rows, and ragged batch tails are masked
    inside the engine's loss (for token rows by the ``-1`` no-target
    label). ``kind == "image"``: x (C, n_max, ...) float32, y (C, n_max)
    int32; ``kind == "tokens"``: x and y both (C, n_max, seq) int32.
    """
    x: np.ndarray
    y: np.ndarray
    sizes: np.ndarray    # (C,) int32 true per-client sample counts
    kind: str = "image"

    @classmethod
    def from_datasets(cls, datasets: Sequence[ClientDataset]
                      ) -> "StackedClients":
        d0 = datasets[0].data
        kind = data_kind_of(d0.x)
        sizes = np.asarray([len(d) for d in datasets], np.int32)
        C, n_max = len(datasets), int(sizes.max())
        x = np.zeros((C, n_max) + d0.x.shape[1:], _x_dtype(kind))
        y = np.zeros((C, n_max) + d0.y.shape[1:], np.int32)
        for c, d in enumerate(datasets):
            x[c, :sizes[c]] = d.data.x
            y[c, :sizes[c]] = d.data.y
        return cls(x=x, y=y, sizes=sizes, kind=kind)

    def to_device(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The slab as device tensors: x float32 (int64 tokens, an
        embedding index), y int64 (gather index)."""
        x = self.x.astype(np.int64) if self.kind == "tokens" else self.x
        return (torch.as_tensor(x, device=device),
                torch.as_tensor(self.y.astype(np.int64), device=device))


class _ListSource:
    """Row source over a materialized client-dataset list — the small-C
    adapter that lets the streaming slab path run on exactly the data the
    monolithic ``StackedClients`` slab would hold (digest-parity tests)."""

    def __init__(self, datasets: Sequence[ClientDataset]):
        self._datasets = list(datasets)
        self.sizes = np.asarray([len(d) for d in self._datasets], np.int64)
        self.n_max = int(self.sizes.max())
        d0 = self._datasets[0].data
        self.kind = data_kind_of(d0.x)
        self.num_classes = d0.num_classes
        self._feat = d0.x.shape[1:]
        self._lab = d0.y.shape[1:]

    def member_rows(self, cids):
        """``(B, n_max, ...)`` float32 (int32 tokens) / ``(B, n_max[, seq])``
        int32 host rows, zero past each client's size."""
        cids = np.asarray(cids, np.int64)
        B = cids.shape[0]
        x = np.zeros((B, self.n_max) + self._feat, _x_dtype(self.kind))
        y = np.zeros((B, self.n_max) + self._lab, np.int32)
        for i, c in enumerate(cids):
            d = self._datasets[int(c)]
            n = int(self.sizes[c])
            x[i, :n] = d.data.x
            y[i, :n] = d.data.y
        return x, y


class ClientSlabStore:
    """Chunked/streaming ``StackedClients``: fixed-size client shards with
    lazy device upload behind a bounded LRU (the reference's
    ``repro.data.loader.ClientSlabStore``).

    ``gather(cids)`` returns the members' ``(B, n_max, ...)`` float32 rows
    and ``(B, n_max)`` int32 labels on the store's device, serving each
    member either from a cached device shard (clients ``[s*shard_size,
    (s+1)*shard_size)`` as one tensor) or, for shards the wave barely
    touches, from a host materialization of just those members (the "row
    path": uploaded with the wave, never cached). A shard is materialized
    and cached only when a wave wants >= ``promote`` of its clients, and at
    most ``cache_shards`` shards stay resident (LRU). Resident bound: the
    cached shards hold at most ``cache_shards * shard_size * n_max`` rows
    (``dim * 4 + 4`` bytes each for float32 features and int32 labels),
    set by the shard geometry, not by C; beside them the store holds at
    most one wave's row block (and, with prefetch, the next wave's
    shards and row block in flight). ``device_bytes`` and ``peak_bytes``
    report what it holds.

    Rows come from a deterministic source (``member_rows`` is a pure
    function of client id), so evictions never change results — only
    which path serves a member. ``stats`` counts both paths.

    ``prefetch(cids)`` overlaps the NEXT wave's host materialization and
    upload with the current wave's device work on one worker thread. On a
    CUDA device the worker copies the numpy rows into pinned host tensors
    and issues the host-to-device copies on a side stream of its own,
    records an event there and waits for it before it returns, so its
    pinned buffers live until their copies have ended; the side stream
    carries copies only (no kernel: ``sens_sketch``'s tickets need every
    launch ordered on one stream). The device tensors are allocated under
    the side stream; the main thread, taking them over, makes its current
    stream wait on the event and calls ``record_stream`` on them, so the
    caching allocator does not hand their blocks out again while main-
    stream work still reads them. On the CPU the worker is a plain thread
    pool. Its results are integrated into the LRU (shards) or handed to the
    next gather (the row block) on the main thread — the worker never
    touches the cache or the counters — so results are bit-identical with
    prefetch on or off. A worker's exception is raised at the ``gather``
    that needs its result, or at ``close`` (a prefetch no gather took).
    """

    def __init__(self, source, *, shard_size: int, cache_shards: int = 32,
                 promote: int = 8, device="cpu"):
        self.source = source
        self.sizes = np.asarray(source.sizes, np.int64)
        self.num_clients = int(self.sizes.shape[0])
        self.shard_size = int(shard_size)
        if self.shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.num_shards = -(-self.num_clients // self.shard_size)
        self.cache_shards = max(1, int(cache_shards))
        self.promote = max(1, int(promote))
        self.device = torch.device(device)
        self._cache: OrderedDict = OrderedDict()   # sid -> (x_dev, y_dev)
        self.hits = 0            # members served from cached shards
        self.row_fetches = 0     # members served via the row path
        self.shard_loads = 0     # full-shard materializations
        self.evictions = 0
        # -- prefetch (one worker; results land on the main thread)
        self._pool = None                  # lazy ThreadPoolExecutor
        self._side = None                  # lazy side CUDA stream
        self._pending: dict = {}           # sid -> Future[staged shard]
        self._pending_rows = None          # (cid-tuple, Future) row block
        self._prefetched_fresh: set = set()   # installed, not yet served
        self.prefetch_issued = 0   # members covered by issued prefetches
        self.prefetch_hits = 0     # members served from prefetched data
        self.prefetch_wasted = 0   # prefetched row-blocks never consumed
        self.peak_bytes = 0        # most device bytes the store held
        x0, y0 = source.member_rows(np.zeros(1, np.int64))
        self.row_bytes = x0[0].nbytes + y0[0].nbytes   # one client's rows

    @classmethod
    def build(cls, client_datasets, *, shard_size: int = 0,
              cache_shards: int = 32, promote: int = 8,
              device="cpu") -> "ClientSlabStore":
        """Wrap either a lazy population (anything with ``member_rows``) or
        a plain client-dataset list; ``shard_size=0`` picks a default."""
        source = (client_datasets
                  if hasattr(client_datasets, "member_rows")
                  else _ListSource(client_datasets))
        if shard_size <= 0:
            shard_size = min(1024, int(np.asarray(source.sizes).shape[0]))
        return cls(source, shard_size=shard_size, cache_shards=cache_shards,
                   promote=promote, device=device)

    @property
    def n_max(self) -> int:
        return self.source.n_max

    @property
    def kind(self) -> str:
        return self.source.kind

    @property
    def num_classes(self) -> int:
        return self.source.num_classes

    @property
    def stats(self) -> dict:
        served = self.hits + self.row_fetches
        return {"hits": self.hits, "row_fetches": self.row_fetches,
                "shard_loads": self.shard_loads, "evictions": self.evictions,
                "resident_shards": len(self._cache),
                "prefetch_issued": self.prefetch_issued,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_wasted": self.prefetch_wasted,
                "hit_rate": self.hits / served if served else 0.0,
                "row_fetch_rate": (self.row_fetches / served
                                   if served else 0.0)}

    @property
    def device_bytes(self) -> int:
        """Device bytes of the cached shards."""
        return sum(x.nbytes + y.nbytes for x, y in self._cache.values())

    def _note_bytes(self, extra: int = 0) -> None:
        """Update ``peak_bytes`` with what the store holds now: cached
        shards, shards and the row block in flight, plus ``extra``."""
        row = self.row_bytes
        held = self.device_bytes + extra
        for sid in self._pending:
            lo = sid * self.shard_size
            held += (min(lo + self.shard_size, self.num_clients) - lo) * row
        if self._pending_rows is not None:
            held += len(self._pending_rows[0]) * row
        self.peak_bytes = max(self.peak_bytes, held)

    # -- materialization ----------------------------------------------------

    def _shard_cids(self, sid: int) -> np.ndarray:
        lo = sid * self.shard_size
        return np.arange(lo, min(lo + self.shard_size, self.num_clients))

    def _upload(self, cids: np.ndarray):
        """Materialize on the main thread: host rows, then a synchronous
        copy to the device on the current stream."""
        x, y = self.source.member_rows(cids)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def _stage(self, cids: np.ndarray):
        """Materialize on the worker thread: ``(x, y, event)``, the event
        None on the CPU."""
        x, y = self.source.member_rows(cids)
        if self.device.type != "cuda":
            return torch.from_numpy(x), torch.from_numpy(y), None
        host = [torch.from_numpy(a).pin_memory() for a in (x, y)]
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            dev = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for h in host]
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()       # the pinned buffers outlive their copies
        return dev[0], dev[1], done

    def _adopt(self, staged):
        """A worker's result, taken over by the main thread's stream."""
        x, y, done = staged
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(done)
            x.record_stream(main)
            y.record_stream(main)
        return x, y

    # -- cache integration (main thread only) -------------------------------

    def _install_shard(self, sid: int, entry) -> None:
        self._cache[sid] = entry
        self.shard_loads += 1
        while len(self._cache) > self.cache_shards:
            evicted, _ = self._cache.popitem(last=False)
            if evicted in self._prefetched_fresh:
                self._prefetched_fresh.discard(evicted)
                self.prefetch_wasted += 1
            self.evictions += 1

    def _load_shard(self, sid: int):
        entry = self._upload(self._shard_cids(sid))
        self._install_shard(sid, entry)
        return entry

    @staticmethod
    def _plan(cids: np.ndarray, shard_size: int):
        """Vectorized shard bucketing: ``(sid, positions)`` groups in
        ascending shard order, positions in input order within each
        group."""
        sids = (cids // shard_size).astype(np.int64)
        order = np.argsort(sids, kind="stable")
        uniq, starts = np.unique(sids[order], return_index=True)
        bounds = np.append(starts, cids.shape[0])
        return [(int(uniq[i]), order[bounds[i]:bounds[i + 1]])
                for i in range(uniq.shape[0])]

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(device=self.device)
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="slab-prefetch")
        return self._pool

    def close(self) -> None:
        """Wait for the worker's last job and stop it (idempotent); a
        prefetch that was never gathered still raises its failure here."""
        if self._pool is None:
            return
        self._pool.shutdown(wait=True)
        self._pool = None
        unread = list(self._pending.values())
        if self._pending_rows is not None:
            unread.append(self._pending_rows[1])
        self._pending.clear()
        self._pending_rows = None
        for f in unread:
            f.result()

    def prefetch(self, cids) -> None:
        """Hint that the next ``gather`` will want these members: schedule
        the shards the promote rule would load (not yet resident, not
        already in flight) and the residual row-path block on the worker.
        A wrong or stale prediction degrades to the synchronous behavior
        (the mismatched row block is dropped and counted in
        ``prefetch_wasted``)."""
        cids = np.asarray(cids, np.int64)
        if cids.size == 0:
            return
        pool = self._ensure_pool()
        miss = []
        for sid, poss in self._plan(cids, self.shard_size):
            if sid in self._cache:
                continue
            if len(poss) >= self.promote:
                if sid not in self._pending:
                    self._pending[sid] = pool.submit(
                        self._stage, self._shard_cids(sid))
                    self.prefetch_issued += len(poss)
            else:
                miss.extend(poss.tolist())
        if miss:
            row_cids = cids[miss]
            key = tuple(int(c) for c in row_cids)
            if self._pending_rows is not None:
                if self._pending_rows[0] == key:
                    return
                self._pending_rows[1].result()   # a failure still surfaces
                self.prefetch_wasted += 1
            self._pending_rows = (key, pool.submit(self._stage, row_cids))
            self.prefetch_issued += len(miss)
        self._note_bytes()

    def _drain_prefetch(self) -> None:
        """Integrate completed shard prefetches into the LRU (main thread:
        the worker never touches ``_cache``)."""
        done = [sid for sid, f in self._pending.items() if f.done()]
        for sid in done:
            entry = self._adopt(self._pending.pop(sid).result())
            if sid not in self._cache:
                self._install_shard(sid, entry)
                self._prefetched_fresh.add(sid)

    def gather(self, cids) -> Tuple[torch.Tensor, torch.Tensor]:
        """Members' rows as device ``(B, n_max, ...)`` float32 and ``(B,
        n_max)`` int32 tensors, one gather per touched cached shard plus at
        most one row-path upload, restored to input order."""
        cids = np.asarray(cids, np.int64)
        B = cids.shape[0]
        self._drain_prefetch()
        parts_x, parts_y, positions, miss = [], [], [], []
        for sid, poss in self._plan(cids, self.shard_size):
            poss = poss.tolist()
            entry = self._cache.get(sid)
            if entry is None and sid in self._pending:
                # in-flight prefetch for a shard this wave needs: wait for
                # the worker instead of re-materializing
                entry = self._adopt(self._pending.pop(sid).result())
                self._install_shard(sid, entry)
                self._prefetched_fresh.add(sid)
            if entry is None and len(poss) >= self.promote:
                entry = self._load_shard(sid)
            if entry is None:
                miss.extend(poss)
                self.row_fetches += len(poss)
                continue
            self._cache.move_to_end(sid)
            if sid in self._prefetched_fresh:
                self._prefetched_fresh.discard(sid)
                self.prefetch_hits += len(poss)
            self.hits += len(poss)
            rows = torch.as_tensor(cids[poss] - sid * self.shard_size,
                                   device=self.device)
            parts_x.append(entry[0][rows])
            parts_y.append(entry[1][rows])
            positions.extend(poss)
        block = 0
        if miss:
            pr, self._pending_rows = self._pending_rows, None
            if pr is not None and pr[0] == tuple(int(c) for c in cids[miss]):
                x_m, y_m = self._adopt(pr[1].result())
                self.prefetch_hits += len(miss)
            else:
                if pr is not None:
                    pr[1].result()       # a worker's failure still surfaces
                    self.prefetch_wasted += 1
                x_m, y_m = self._upload(cids[miss])
            parts_x.append(x_m)
            parts_y.append(y_m)
            positions.extend(miss)
            block = x_m.nbytes + y_m.nbytes
        self._note_bytes(block)
        x = parts_x[0] if len(parts_x) == 1 else torch.cat(parts_x)
        y = parts_y[0] if len(parts_y) == 1 else torch.cat(parts_y)
        if positions != list(range(B)):
            inv = np.empty(B, np.int64)
            inv[np.asarray(positions)] = np.arange(B)
            inv_t = torch.as_tensor(inv, device=self.device)
            x, y = x[inv_t], y[inv_t]
        return x, y
