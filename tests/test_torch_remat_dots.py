"""``remat="dots"`` in the port, on the CPU: JAX's
``dots_with_no_batch_dims_saveable`` policy as a selective
``torch.utils.checkpoint`` (``models.model._dots_policy``).

* Loss and every gradient bit-equal to ``remat="none"`` and ``"full"`` on
  ``fed-lm-smoke``, ``phi4-mini-3.8b-smoke`` with and without
  ``sliding_window=8`` and ``llama3-405b-smoke`` at 6 layers in 3
  ``scan_groups`` (a selective checkpoint inside a selective checkpoint),
  for one model (``members=False``) and a wave of 3 members under both
  member kernels.
* What it keeps: the backward's recompute issues no ``aten.mm`` (the
  shared-weight products' outputs are saved), where ``"full"`` recomputes
  them; the member-batched products (``bmm``) are recomputed under both.
* A cohort fed-lm FedPSA run under ``"dots"`` gives the ``"none"`` run's
  digests bit for bit.
* The recompute keeps the forward's member kernel when the backward runs
  on another thread (as autograd runs a CUDA backward).

``tests/test_torch_lm_train.py::test_loss_and_grad_match_reference`` holds
the ``"dots"`` loss and gradients to the reference's ``"dots"``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.tree import FlatSpec, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params
from repro_torch.core.psa import PSAConfig
from repro_torch.federated import SimConfig, run_algorithm
from repro_torch.launch.train import build_task
from repro_torch.models import member_math as tmm
from repro_torch.models import model as TM
from repro_torch.models import registry as treg
from torch_dist import FEDLM_INIT, FEDLM_PSA, FEDLM_SIM, FEDLM_WORLD
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = [
    ("fed-lm-smoke", {}),
    ("phi4-mini-3.8b-smoke", {}),
    ("phi4-mini-3.8b-smoke", {"sliding_window": 8}),
    ("llama3-405b-smoke", {"num_layers": 6, "scan_groups": 3}),
]
# (members, member kernel)
WAYS = [(False, "vmap"), (True, "vmap"), (True, "grouped")]


class _OpCounts(TorchDispatchMode):
    """Counts of the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, members: bool, mode: str, counts=None):
    """The loss and its gradients at seeded inits: one model on a (2, 12)
    token batch, or a wave of 3 members (each its own init) on (3, 2, 12)
    with one masked row."""
    rng = np.random.default_rng(1)
    fam = treg.get_family(cfg)
    inits = [TM.init_params(torch.Generator().manual_seed(s), cfg)
             for s in range(3 if members else 1)]
    counts = counts or _OpCounts()
    if members:
        spec = FlatSpec(inits[0])
        w = torch.stack([spec.flatten(p) for p in inits]).requires_grad_(True)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 12)))
        vm = torch.ones(3, 2)
        vm[2, 1] = 0.0
        batch = fam.masked_batch(toks, toks.clone(), vm, vm.sum(1))
        leaves = [w]
        with tmm.routing(mode), counts:
            loss = fam.client_loss(spec.unflatten(w), batch, cfg,
                                   members=True).sum()
            grads = torch.autograd.grad(loss, leaves)
    else:
        leaves = tree_leaves(inits[0])
        for leaf in leaves:
            leaf.requires_grad_(True)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
        with counts:
            loss = TM.loss_fn(inits[0], {"tokens": toks, "labels": toks},
                              cfg)
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads]


@pytest.mark.parametrize("members,mode", WAYS,
                         ids=["one", "members-vmap", "members-grouped"])
@pytest.mark.parametrize("arch,over", CONFIGS,
                         ids=["fed", "phi", "phi-w8", "llama-g3"])
def test_dots_is_bit_equal_to_none_and_full(arch, over, members, mode):
    base = dataclasses.replace(tget(arch), **over)
    l0, g0 = _loss_and_grads(dataclasses.replace(base, remat="none"),
                             members, mode)
    for remat in ("full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        loss, grads = _loss_and_grads(cfg, members, mode)
        assert torch.equal(loss, l0), remat
        assert len(grads) == len(g0)
        for a, b in zip(grads, g0):
            assert torch.equal(a, b), remat


def test_dots_saves_the_products_without_a_batch_axis():
    """fed-lm-smoke (2 layers, 7 products each, and the unembedding): the
    forward issues 15 ``mm``s and the backward 30. ``"full"`` recomputes 6
    a layer (the last one, the FFN's output product, is not needed by
    the backward); ``"dots"`` recomputes none. A wave's member-batched
    products (``bmm``) are recomputed under ``"dots"`` as under
    ``"full"``."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    base = tget("fed-lm-smoke")
    n = {}
    for remat in ("none", "full", "dots"):
        for members in (False, True):
            c = _OpCounts()
            _loss_and_grads(dataclasses.replace(base, remat=remat), members,
                            "vmap", c)
            n[remat, members] = (c.n.get(mm, 0), c.n.get(bmm, 0))
    assert n["none", False][0] == 45
    assert n["full", False][0] == 45 + 2 * 6
    assert n["dots", False][0] == 45
    assert n["dots", False][1] == n["full", False][1] > n["none", False][1]
    assert n["dots", True] == n["full", True]
    assert n["full", True][1] > n["none", True][1]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_keeps_the_forward_member_kernel(remat):
    """The recompute runs inside the backward, which autograd runs on its
    own thread for a CUDA device, outside the caller's ``routing`` block:
    it must still send the member products to ``grouped_matmul``. Here the
    backward runs on another thread: the wave's gradient is bit-equal to
    the one-thread backward's, and the recompute's products are grouped
    launches (forward F, backward 2 F dx/dW products plus the recompute's)."""
    import threading
    cfg = dataclasses.replace(tget("fed-lm-smoke"), remat=remat)
    real = tmm.grouped_matmul
    calls = []

    def counted(*a, **k):
        calls.append(threading.get_ident())
        return real(*a, **k)

    def wave_grad(on_thread: bool):
        fam = treg.get_family(cfg)
        inits = [TM.init_params(torch.Generator().manual_seed(s), cfg)
                 for s in range(3)]
        spec = FlatSpec(inits[0])
        w = torch.stack([spec.flatten(p) for p in inits]).requires_grad_(True)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (3, 2, 12)))
        vm = torch.ones(3, 2)
        batch = fam.masked_batch(toks, toks.clone(), vm, vm.sum(1))
        with tmm.routing("grouped"):
            loss = fam.client_loss(spec.unflatten(w), batch, cfg,
                                   members=True).sum()
            forward = len(calls)
            if not on_thread:
                return torch.autograd.grad(loss, [w])[0], forward
        out = []
        t = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, [w])[0]))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and out
        return out[0], forward

    tmm.grouped_matmul = counted
    try:
        g_one, fwd = wave_grad(False)
        n_one = len(calls)
        calls.clear()
        g_thread, fwd_t = wave_grad(True)
        n_thread = len(calls)
    finally:
        tmm.grouped_matmul = real
    assert torch.equal(g_one, g_thread)
    assert fwd == fwd_t > 0
    assert n_thread == n_one > 3 * fwd      # the recompute's products too


def test_unknown_remat_raises():
    cfg = dataclasses.replace(tget("fed-lm-smoke"), remat="offload")
    with pytest.raises(ValueError, match="remat must be one of"):
        TM.init_params(torch.Generator().manual_seed(0), cfg)


def test_cohort_fedlm_run_under_dots_is_the_none_run():
    W = FEDLM_WORLD
    cfg, clients, test, calib = build_task(
        "fed-lm-smoke", W["samples"], W["alpha"], W["clients"], W["seed"],
        seq_len=W["seq"])
    assert cfg.remat == "none"
    runs = {}
    for remat in ("none", "dots"):
        runs[remat] = run_algorithm(
            "fedpsa", dataclasses.replace(cfg, remat=remat),
            load_npz_params(FEDLM_INIT), clients, test,
            SimConfig(device="cpu", record_trajectory=True,
                      **{**FEDLM_SIM, "horizon": 3_000.0}),
            psa_cfg=PSAConfig(**FEDLM_PSA), calib_batch=calib)
    a, b = runs["none"], runs["dots"]
    assert a.engine == b.engine == "cohort" and a.dispatches > 0
    assert a.digests == b.digests
    assert a.accuracies == b.accuracies
    np.testing.assert_equal(a.server_log, b.server_log)
