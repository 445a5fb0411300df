"""Cohort client engine: a wave of clients trains as one batch of members.

The port of the reference's ``repro.federated.cohort.CohortEngine`` (the
monolithic data slab on one device). All clients whose completions drain
together train at once: every parameter and activation carries a leading
member axis B (the reference's ``vmap`` axis, written out), and a Python
loop over the local SGD steps replaces the reference's ``lax.scan``. Each
step gathers the members' batches from the device slab, takes one autograd
pass over the sum of the member losses (members are independent, so each
member's gradient is exact) and moves every member by its own learning
rate. The member-batched dense products go through
``models.member_math.member_dot`` in the engine's ``member_kernel`` mode:
``"grouped"`` runs them through the ``grouped_matmul`` kernel, forward and
backward.

Batch schedules come from the same ``epoch_batch_indices`` stream as the
sequential client, padded to a fixed ``(num_steps, bs_pad)`` frame: ragged
batch tails are masked inside the loss (``registry.masked_batch``), and a
padded step has learning rate 0, so it is an exact no-op. The engine ends a
wave after the last step on which any member has a non-zero learning rate;
the steps it skips are such no-ops. Wave sizes pad up to the ``bucket_size``
grid with zero-parameter members at learning rate 0, as in the reference:
on client 0's data in ``CohortEngine``, on zero rows in
``StreamingCohortEngine`` (the engine over a ``data.loader.ClientSlabStore``
for populations too large to stack, which trains each wave on the rows
the store gathers for it).

With a mesh (``CohortEngine(..., mesh=, rules=)``, one process a rank) a
wave trains data-parallel over the mesh axis that the rules map
``cohort`` onto: rank r trains its contiguous share of the padded wave's
members, and every rank then all-gathers the members' new parameters.
Each rank holds the whole data slab and runs the wave's step count, and
members are independent, so a member's new parameters can depend on the
split only through the width of the calls that batch the members. The
``grouped_matmul`` kernel's sums do not depend on it (``split_k``);
cuDNN picks its grouped convolution's algorithm by the group count, and
on the H100 a member's forward and input gradient came out the same bits
at 1, 4, 8 and 12 members but not at 2. So a wave splits only into
shares of whole buckets (multiples of ``bucket_size(1)``, 4 members: the
widths a single-device wave has); otherwise every rank trains the whole
wave. The reference splits whenever n divides the padded wave.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import sharding
from repro_torch.common.tree import (FlatSpec, tree_leaves, tree_sq_norm,
                                     tree_sub, tree_unflatten_like)
from repro_torch.data.loader import (ClientSlabStore, StackedClients,
                                     epoch_batch_indices)
from repro_torch.federated.client import _head
from repro_torch.models import member_math, registry
from repro_torch.models.config import ModelConfig


def bucket_size(B: int, data_kind: str = "tokens") -> int:
    """Pad a wave of B members up to the family's bucket grid: multiples
    of 4 for ``image`` data; {4, 6, 8, 12, 16, 24, ...} (powers of two and
    1.5x powers of two) for ``tokens``. The reference's grid, which bounds
    its compiled-program count; the port keeps it so that waves, padding
    and launch shapes match the reference's."""
    if data_kind == "image":
        return -(-B // 4) * 4
    if B <= 4:
        return 4
    p = 1 << (B - 1).bit_length()          # next power of two >= B
    return 3 * p // 4 if 3 * p // 4 >= B else p


class CohortEngine:
    """Local training for a whole wave of members on one device.

    Built once per run (model, stacked data, epochs, batch size, prox,
    align, member kernel, mesh); ``cohort_update`` then trains one wave.
    ``steps_run`` counts the local steps the engine executed, over all
    waves, and ``split_waves`` the waves it trained split over a mesh.
    """
    # the mesh axis a wave's members split over (None: single device, or
    # rules that map ``cohort`` onto no mesh axis)
    _cohort: Optional[sharding.AxisGroup] = None

    def __init__(self, cfg: ModelConfig, stacked: StackedClients,
                 spec: FlatSpec, *, local_epochs: int = 5,
                 batch_size: int = 64, prox: float = 0.0, align: float = 0.0,
                 member_kernel: str = "vmap", device="cpu", mesh=None,
                 rules: Optional[sharding.LogicalRules] = None):
        self._configure(cfg, spec, stacked.sizes, local_epochs=local_epochs,
                        batch_size=batch_size, prox=prox, align=align,
                        member_kernel=member_kernel, device=device)
        self.x, self.y = stacked.to_device(self.device)
        if mesh is not None:
            self._cohort = sharding.mesh_axis(mesh, rules, "cohort")

    def _share(self, n: int) -> Optional[slice]:
        """This rank's contiguous share of n members when they split over
        the cohort axis of two or more ranks into shares of whole buckets,
        else None (every rank takes all n)."""
        ax = self._cohort
        if ax is None or ax.size == 1 or \
                n % (ax.size * bucket_size(1, self._data_kind)):
            return None
        m = n // ax.size
        return slice(ax.rank * m, (ax.rank + 1) * m)

    def map_members(self, fn: Callable, rows: torch.Tensor) -> torch.Tensor:
        """``fn`` of (B, ...) member rows -> (B, ...) results, member by
        member (FedPSA's wave sketches), under the wave's own rule: each
        rank applies ``fn`` to its share of the B members and the shares
        are all-gathered when they are whole buckets; otherwise every rank
        applies it to all B."""
        share = self._share(int(rows.shape[0]))
        if share is None:
            return fn(rows)
        return sharding.all_gather_cat(fn(rows[share]), self._cohort)

    def _configure(self, cfg: ModelConfig, spec: FlatSpec, sizes, *,
                   local_epochs: int, batch_size: int, prox: float,
                   align: float, member_kernel: str, device) -> None:
        fam = registry.get_family(cfg)
        if member_kernel not in member_math.MODES:
            raise ValueError(f"member_kernel must be one of "
                             f"{member_math.MODES}, got {member_kernel!r}")
        self._fam = fam
        self._data_kind = fam.data_kind
        self.cfg = cfg
        self.spec = spec
        self.local_epochs = int(local_epochs)
        self.batch_size = int(batch_size)
        self.prox = float(prox)
        self.align = float(align)
        self.member_kernel = member_kernel
        self.device = torch.device(device)
        self.sizes = np.asarray(sizes, np.int64)
        # per-client steps under the drop-last rule; waves run in the
        # global max frame and mask the tail
        bs_c = np.minimum(self.batch_size, self.sizes)
        self.steps_per_client = (self.local_epochs
                                 * (self.sizes // bs_c)).astype(int)
        self.num_steps = int(self.steps_per_client.max())
        self.bs_pad = int(bs_c.max())
        self.steps_run = 0
        self.split_waves = 0

    def _schedules(self, cids: np.ndarray, seeds: np.ndarray):
        """Batch schedules for a cohort, padded to the engine's fixed
        (num_steps, bs_pad) frame. Returns (idx, valid f32 masks, counts =
        per-step valid totals clamped to >= 1, nvalid per-step raw totals
        for lr gating)."""
        B = len(cids)
        idx = np.zeros((B, self.num_steps, self.bs_pad), np.int64)
        valid = np.zeros((B, self.num_steps, self.bs_pad), np.float32)
        nvalid = np.zeros((B, self.num_steps), np.float32)
        for i, (c, s) in enumerate(zip(cids, seeds)):
            sched = epoch_batch_indices(int(self.sizes[c]), self.local_epochs,
                                        self.batch_size, int(s))
            st, bs = sched.shape
            idx[i, :st, :bs] = sched
            valid[i, :st, :bs] = 1.0
            nvalid[i, :st] = bs
        counts = np.maximum(nvalid, 1.0)
        return idx, valid, counts, nvalid

    def cohort_update(self, params_stack: torch.Tensor, cids: Sequence[int],
                      lrs: Sequence[float], seeds: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train the cohort; returns (deltas, new_params), both (B, d).

        ``params_stack`` (B, d) holds each member's dispatch snapshot (its
        anchor for prox/align); ``lrs``/``seeds`` are per-member, what the
        sequential loop would have used for that dispatch."""
        return self._update(params_stack, cids, lrs, seeds, lanes=1)

    def sweep_update(self, params_stack: torch.Tensor, cids: Sequence[int],
                     lrs: Sequence[float], seeds_per_lane
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train one wave for all S sweep lanes as one wave of S*B members.

        ``params_stack`` is the ``(S, B, d)`` stack of per-lane dispatch
        snapshots; ``cids``/``lrs`` are shared across lanes (the event
        timeline is lane-invariant); ``seeds_per_lane`` is ``(S, B)``.
        Returns ``(deltas, new_params)``, both ``(S, B, d)``. Members are
        independent, so lane s is ``cohort_update`` on that lane's
        snapshots and seeds; the wave pads to ``bucket_size(S*B)`` (the
        grouped kernel's G) and runs the same local steps as one lane
        alone, so it adds no launches. The lanes index the wave's B clients'
        rows, which are gathered once."""
        S, B, d = (int(n) for n in params_stack.shape)
        deltas, w = self._update(
            params_stack.reshape(S * B, d), cids, lrs,
            np.asarray(seeds_per_lane).reshape(S * B), lanes=S)
        return deltas.view(S, B, d), w.view(S, B, d)

    def _wave_rows(self, cids: np.ndarray, lanes: int, pad: int):
        """``(x, y, rows)``: the slab the wave's members index, and each
        padded member's row in it (the wave's clients once per lane, then
        the pads on client 0)."""
        rows = np.concatenate([np.tile(cids, lanes),
                               np.zeros(pad, np.int64)])
        return self.x, self.y, rows

    def _update(self, params_stack: torch.Tensor, cids, lrs, seeds, *,
                lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train ``lanes`` copies of a wave of B clients as one wave of
        ``lanes * B`` members (``params_stack`` and ``seeds`` lane-major);
        returns (deltas, new_params), both ``(lanes * B, d)``."""
        n = int(params_stack.shape[0])
        if n < 1:
            raise ValueError("cohort_update needs at least one member")
        cids = np.asarray(cids, np.int64)
        idx, valid, counts, nvalid = self._schedules(np.tile(cids, lanes),
                                                     np.asarray(seeds))
        # per-(member, step) learning rate: the member's lr on real steps,
        # 0 on padded steps (making them exact no-ops)
        lr_steps = (np.tile(np.asarray(lrs, np.float64), lanes)[:, None]
                    * (nvalid > 0.0)).astype(np.float32)
        pad = bucket_size(n, self._data_kind) - n
        if pad > 0:
            def padded(a, fill=0):
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

            params_stack = torch.cat([params_stack, params_stack.new_zeros(
                (pad, params_stack.shape[1]))])
            idx, valid, lr_steps = map(padded, (idx, valid, lr_steps))
            counts = padded(counts, 1)
        live = np.flatnonzero((lr_steps > 0.0).any(axis=0))
        n_steps = int(live[-1]) + 1 if live.size else 0
        x, y, rows = self._wave_rows(cids, lanes, pad)
        share = self._share(n + pad)
        if share is None:
            w = self._train(params_stack, x, y, rows, idx, valid, counts,
                            lr_steps, n_steps)
        else:
            # the whole wave's step count on every rank: a rank's members
            # run their padded steps at learning rate 0, as on one device
            self.split_waves += 1
            w = sharding.all_gather_cat(self._train(
                params_stack[share], x, y, rows[share], idx[share],
                valid[share], counts[share], lr_steps[share], n_steps),
                self._cohort)
        return (w - params_stack)[:n], w[:n]

    def _train(self, params_stack, x, y, rows, idx, valid, counts, lr_steps,
               n_steps: int) -> torch.Tensor:
        """Run local steps 0 .. n_steps-1 of the padded wave, member i on
        ``x[rows[i]]``/``y[rows[i]]``; (Bp, d)."""
        dev = self.device
        fam, cfg = self._fam, self.cfg
        anchor = self.spec.unflatten(params_stack)
        row_t = torch.as_tensor(rows, device=dev)[:, None]
        idx_t = torch.as_tensor(idx, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        counts_t = torch.as_tensor(counts, device=dev)
        lr_t = torch.as_tensor(lr_steps, device=dev)
        leaves = tree_leaves(anchor)
        with member_math.routing(self.member_kernel):
            for s in range(n_steps):
                bi = idx_t[:, s]
                batch = fam.masked_batch(x[row_t, bi], y[row_t, bi],
                                         valid_t[:, s], counts_t[:, s])
                req = [l.detach().requires_grad_(True) for l in leaves]
                p = tree_unflatten_like(anchor, req)
                loss = torch.sum(fam.client_loss(p, batch, cfg, members=True))
                if self.prox > 0.0:
                    loss = loss + 0.5 * self.prox * tree_sq_norm(
                        tree_sub(p, anchor))
                if self.align > 0.0:
                    loss = loss + 0.5 * self.align * tree_sq_norm(
                        tree_sub(_head(p), _head(anchor)))
                grads = torch.autograd.grad(loss, req)
                lr = lr_t[:, s]
                with torch.no_grad():
                    leaves = [l - lr.view((-1,) + (1,) * (l.dim() - 1)) * g
                              for l, g in zip(leaves, grads)]
                self.steps_run += 1
        return self.spec.flatten(tree_unflatten_like(anchor, leaves),
                                 members=True)


class StreamingCohortEngine(CohortEngine):
    """The cohort engine over streamed client slabs (population scale).

    The same member program as ``CohortEngine``, except that the data
    arrives per wave: instead of indexing a resident ``(C, n_max, ...)``
    slab by client id, each wave trains on the ``(B, n_max, ...)`` rows
    that its ``data.loader.ClientSlabStore`` gathers (cached device shards
    and on-demand row uploads), gathered once for all lanes of a sweep.
    Members train on exactly the rows the monolithic slab holds for them
    and the batch schedules come from the same ``epoch_batch_indices``
    stream, so the two engines agree; pads train on zero rows at learning
    rate 0. Memory is bounded by the store's shard geometry, not by C.
    """

    def __init__(self, cfg: ModelConfig, store: ClientSlabStore,
                 spec: FlatSpec, *, local_epochs: int = 5,
                 batch_size: int = 64, prox: float = 0.0, align: float = 0.0,
                 member_kernel: str = "vmap", device="cpu"):
        self._configure(cfg, spec, store.sizes, local_epochs=local_epochs,
                        batch_size=batch_size, prox=prox, align=align,
                        member_kernel=member_kernel, device=device)
        self.store = store

    def _wave_rows(self, cids: np.ndarray, lanes: int, pad: int):
        """The wave's gathered rows (int32 labels, and int32 tokens, widened
        here, on the current stream), a zero row after them for the pads,
        and each member's row: the B clients' once per lane, then the
        pads'."""
        x, y = self.store.gather(cids)
        if self._data_kind == "tokens":
            x = x.long()
        B = len(cids)
        rows = np.tile(np.arange(B, dtype=np.int64), lanes)
        if pad > 0:
            x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
            y = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
            rows = np.concatenate([rows, np.full(pad, B, np.int64)])
        return x, y.long(), rows
