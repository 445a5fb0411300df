"""The port's LM training path against the JAX reference, on the CPU: the
attention backward, ``loss_fn`` and its gradient, member-batched losses,
remat and the bf16 local SGD step (the LM world, its data and the fed-lm
goldens are in ``tests/test_torch_fedlm.py``).

Every input is made with numpy from a seed and handed to both sides; the
reference's parameters are its own init (``fed-lm-smoke``'s is the legacy-
threefry init the golden was made with, committed as
``tests/torch_fixtures/fed_lm_smoke_init_seed0.npz``), converted with
``convert.params_from_numpy``. Tolerances:

* the attention backward, f32: within 2e-5 x max|ref| of ``jax.grad`` of
  the reference's ``chunked_attention`` (the same function; chunked online
  softmax against a materialised one differ in rounding only); bf16:
  within 2^-5 x max|ref| (the reference rounds p, and through its autodiff
  dP and dS, to bf16 at each chunk's products where the port computes them
  in f32: a few bf16 roundings, 2^-8 each, of terms up to max|ref|);
* ``loss_fn`` in f32: the loss within rtol 1e-5, each gradient leaf within
  1e-5 x max(1, max|ref leaf|) (summation order through two or four
  layers);
* member-batched losses against per-member losses: rtol 1e-6, gradients
  1e-6 x max(1, max|g|) (the same products, batched); masked rows bit-exact
  no-ops;
* bf16 local SGD against the reference's: leaf dtypes equal, values within
  2^-6 x max|ref| (bf16 products in two frameworks' orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.federated import client as rclient
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import registry as rreg
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.federated import client as tclient
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import member_math as tmm
from repro_torch.models import model as TM
from repro_torch.models import registry as treg
from torch_threads import one_torch_thread  # noqa: F401

FED = "fed-lm-smoke"
PHI = "phi4-mini-3.8b-smoke"


def _ref_init(arch, seed=0, **over):
    return _ref_init_cached(arch, seed, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _ref_init_cached(arch, seed, over):
    """The reference's init (legacy threefry), as numpy leaves; callers
    convert, never write."""
    cfg = rget(arch)
    if over:
        cfg = dataclasses.replace(cfg, **dict(over))
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _pair(arch, **over):
    r, t = rget(arch), tget(arch)
    if over:
        r, t = dataclasses.replace(r, **over), dataclasses.replace(t, **over)
    return r, t


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_tree(got, want, tol):
    """Each leaf of ``got`` (torch) within tol x max(1, max|want leaf|)."""
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), err


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,H,Hkv,causal", [
    ("float32", 6, 2, True), ("float32", 4, 4, False),
    ("bfloat16", 6, 2, True), ("bfloat16", 4, 4, False)])
def test_attention_backward_matches_jax_grad(dtype, H, Hkv, causal):
    """The port's attention gradient (FlashAttention's plain backward on
    the CPU) against jax.grad of the reference's chunked_attention, with
    q_chunk and kv_chunk below S so the reference really chunks."""
    B, S, hd = 2, 40, 16
    rng = np.random.default_rng(H + 10 * causal)
    q, do = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.dtype(dtype)

    def f(q_, k_, v_):
        out = RL.chunked_attention(q_, k_, v_, causal=causal, q_chunk=16,
                                   kv_chunk=8)
        return jnp.sum(out.astype(jnp.float32) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt)
                                            for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    tol = 2e-5 if dtype == "float32" else 2.0 ** -5
    for g, w in zip(got, want):
        assert g.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


def test_backward_bf16_limit_admits_the_kernel_rounding():
    """The kernel's bf16 limit (``bwd_bf16_limit``) holds for its documented
    arithmetic, emulated here: f32 math, one rounding of each output to
    bf16; against the float64 backward it exceeds the rounding alone."""
    B, S, H, Hkv, hd = 1, 48, 6, 2, 32
    rng = np.random.default_rng(7)
    q, o, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).bfloat16() for _ in range(3))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, hd)).astype(
        np.float32)).bfloat16() for _ in range(2))
    o, lse = tfa._plain_forward(q, k, v, True)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                        dtype=torch.float64)
    absref = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                           dtype=torch.float64, absolute=True)
    for g, r, a, n in zip(got, ref, absref, (S, 3 * S, 3 * S)):
        assert g.dtype == torch.bfloat16
        diff = (g.double() - r).abs()
        assert bool((diff <= tfa.bwd_bf16_limit(r, a, n, hd)).all())
        assert bool((a >= r.abs() - 1e-12).all())
        assert float(diff.max()) > 0


# ---------------------------------------------------------------------------
# loss_fn, its gradient, members, masking
# ---------------------------------------------------------------------------

def _ref_value_and_grad(rcfg, rp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(lambda p: RM.loss_fn(p, jb, rcfg, R))(rp)


def _port_value_and_grad(tcfg, rp, batch, members=False):
    p = params_from_numpy(rp)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    loss = TM.loss_fn(p, tb, tcfg, members=members)
    grads = torch.autograd.grad(loss.sum(), leaves)
    from repro_torch.common.tree import tree_unflatten_like
    return loss, tree_unflatten_like(p, list(grads))


@pytest.mark.parametrize("arch,over", [
    (FED, {}), (PHI, {}), (FED, {"num_kv_heads": 1}),
    (FED, {"tie_embeddings": True}), (PHI, {"sliding_window": 8}),
    (FED, {"sliding_window": 8}), (FED, {"remat": "dots"}),
    (PHI, {"remat": "dots", "sliding_window": 8})])
def test_loss_and_grad_match_reference(arch, over):
    rcfg, tcfg = _pair(arch, **over)
    rp = _ref_init(arch, 1, **over)
    toks = _tokens(rcfg, (3, 20), 3)
    labels = toks.copy()
    labels[1, 5:9] = -1                  # masked targets
    batch = {"tokens": toks, "labels": labels}
    want_l, want_g = _ref_value_and_grad(rcfg, rp, batch)
    got_l, got_g = _port_value_and_grad(tcfg, rp, batch)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    _close_tree(got_g, want_g, 1e-5)
    if over.get("tie_embeddings"):
        assert "unembed" not in rp["embed"]
        # prefill logits of the tied model
        _, want = RM.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, R)
        _, got = TM.prefill(params_from_numpy(rp),
                            {"tokens": torch.from_numpy(toks).long()}, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_remat_full_gives_the_same_gradient():
    """Checkpointed superblocks recompute the same values: loss and
    gradients bit-equal to remat "none"."""
    _, tcfg = _pair(FED)
    rp = _ref_init(FED)
    batch = {"tokens": _tokens(tcfg, (2, 16), 4)}
    batch["labels"] = batch["tokens"]
    l0, g0 = _port_value_and_grad(tcfg, rp, batch)
    l1, g1 = _port_value_and_grad(dataclasses.replace(tcfg, remat="full"),
                                  rp, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_eval_accuracy_matches_reference():
    rcfg, tcfg = _pair(FED)
    rp = _ref_init(FED)
    toks = _tokens(rcfg, (6, 16), 8)
    want = rreg.get_family("dense").eval_accuracy(
        rp, rreg.get_family("dense").batch_fn(toks, toks), rcfg, R)
    fam = treg.get_family(tcfg)
    got = fam.eval_accuracy(params_from_numpy(rp),
                            fam.batch_fn(toks, toks, "cpu"), tcfg)
    np.testing.assert_allclose(float(got), float(want), atol=1e-7)
    want = RM.forward_logits(rp, {"tokens": jnp.asarray(toks)}, rcfg, R)
    got = TM.forward_logits(params_from_numpy(rp),
                            {"tokens": torch.from_numpy(toks).long()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", tmm.MODES)
def test_member_losses_are_the_per_member_losses(mode):
    """client_loss(members=True) on a wave of 3 members (their own params
    and tokens) is each member's loss_fn, with gradients; a masked row is
    an exact no-op: its content never changes the loss or the gradient."""
    _, tcfg = _pair(FED)
    fam = treg.get_family(tcfg)
    rps = [_ref_init(FED, s) for s in range(3)]
    toks = _tokens(tcfg, (3, 4, 16), 11)
    vm = np.ones((3, 4), np.float32)
    vm[1, 2:] = 0.0                       # member 1: two masked rows
    singles, grads = [], []
    for b in range(3):
        keep = vm[b] > 0
        batch = {"tokens": toks[b][keep], "labels": toks[b][keep]}
        loss, g = _port_value_and_grad(tcfg, rps[b], batch)
        singles.append(float(loss))
        grads.append(g)

    def wave(tok):
        spec = FlatSpec(params_from_numpy(rps[0]))
        w = torch.stack([spec.flatten(params_from_numpy(p)) for p in rps])
        leaf = w.clone().requires_grad_(True)
        x = torch.from_numpy(tok.astype(np.int64))
        batch = fam.masked_batch(x, x.clone(), torch.from_numpy(vm),
                                 torch.from_numpy(vm.sum(1)))
        with tmm.routing(mode):
            loss = fam.client_loss(spec.unflatten(leaf), batch, tcfg,
                                   members=True)
            g = torch.autograd.grad(loss.sum(), leaf)[0]
        return loss, g, spec

    loss, g, spec = wave(toks)
    assert tuple(loss.shape) == (3,)
    np.testing.assert_allclose(loss.detach().numpy(), singles, rtol=1e-6)
    for b in range(3):
        gb = spec.unflatten(g[b])
        for a, w in zip(tree_leaves(gb), tree_leaves(grads[b])):
            err = float((a - w).abs().max())
            assert err <= 1e-6 * max(1.0, float(w.abs().max())), err
    garbage = toks.copy()
    garbage[1, 2:] = (garbage[1, 2:] + 7) % tcfg.vocab_size
    loss2, g2, _ = wave(garbage)
    assert torch.equal(loss, loss2) and torch.equal(g, g2)


def test_bf16_local_sgd_promotes_like_the_reference():
    """The reference steps p - lr * g.astype(p.dtype) with an f32 lr: JAX
    promotes a bf16 leaf to f32 in its first step. The port's local_update
    does the same: two steps of a bf16 fed-lm-smoke, leaf dtypes and
    values held to the reference's."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    rcfg, tcfg = _pair(FED, **over)
    rp = _ref_init(FED, 2, **over)
    toks = _tokens(rcfg, (4, 24), 12)
    ds_r = rdata.ClientDataset(rdata.SyntheticClassification(
        x=toks, y=toks, num_classes=rcfg.vocab_size))
    ds_t = tdata.ClientDataset(tdata.SyntheticClassification(
        x=toks, y=toks, num_classes=tcfg.vocab_size))
    kw = dict(epochs=1, batch_size=2, lr=0.05, seed=3)
    rd, rw = rclient.local_update(rp, rcfg, ds_r, **kw)
    p0 = params_from_numpy(rp)
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree_leaves(p0))
    td, tw = tclient.local_update(p0, tcfg, ds_t, **kw)
    for got, want in ((td, rd), (tw, rw)):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert str(g.dtype).split(".")[1] == str(w.dtype) == "float32"
    _close_tree(tw, rw, 2.0 ** -6)
    d = np.concatenate([np.asarray(x, np.float32).ravel()
                        for x in jax.tree_util.tree_leaves(rd)])
    got = np.concatenate([x.float().numpy().ravel() for x in tree_leaves(td)])
    assert np.abs(got - d).max() <= 2.0 ** -6 * np.abs(d).max()


@pytest.mark.gpu
def test_flash_attention_bwd_cuda_matches_plain_on_card():
    """The backward kernels against their plain version on the card: f32
    within 2e-5 x max(1, max|plain|); bf16 elementwise against the float64
    backward, within ``bwd_bf16_tc_limit`` on the tensor-core kernels (hd
    <= 128) and ``bwd_bf16_limit`` on the CUDA-core ones (hd 256); GQA and
    not, causal and not, Sq != Sk, the full width's heads at S = 256, a
    strided dO; repeated runs bit-equal (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for B, Sq, Sk, H, Hkv, hd, causal in [(3, 40, 40, 6, 2, 16, True),
                                          (2, 70, 70, 4, 4, 64, False),
                                          (1, 33, 50, 4, 2, 128, True),
                                          (1, 65, 65, 2, 1, 256, True),
                                          (2, 256, 256, 24, 8, 128, True)]:
        for dt in (torch.float32, torch.bfloat16):
            q, do = (torch.from_numpy(rng.standard_normal(
                (B, Sq, H, hd)).astype(np.float32)).to(dev, dt)
                for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Sk, Hkv, hd)).astype(np.float32)).to(dev, dt)
                for _ in range(2))
            o, lse = tfa._forward(q, k, v, causal, with_lse=True)
            dos = do.transpose(1, 2).contiguous().transpose(1, 2)
            got = tfa.flash_attention_bwd(q, k, v, o, dos, lse, causal)
            again = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            if dt == torch.float32:
                want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                     causal)
                for a, w in zip(got, want):
                    tol = 2e-5 * max(1.0, float(w.abs().max()))
                    assert float((a - w).abs().max()) <= tol
                continue
            ref = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal,
                                                dtype=torch.float64)
            absref = tfa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal, dtype=torch.float64,
                absolute=True)
            G = H // Hkv
            limit = (tfa.bwd_bf16_tc_limit if tfa.bwd_route(dt, hd) == "tc"
                     else tfa.bwd_bf16_limit)
            for a, r, ab, n in zip(got, ref, absref, (Sk, G * Sq, G * Sq)):
                assert a.dtype == dt
                lim = limit(r, ab, n, hd)
                assert bool(((a.double() - r).abs() <= lim).all())
