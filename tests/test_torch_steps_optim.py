"""The port's optimizers, schedules and step builders against the JAX
reference, on the CPU, and its pretrain example.

* ``optim``: every optimizer's updates and state over 5 steps on one numpy
  tree of f32 leaves, and ``apply_updates``, within rtol 1e-6 (atol 1e-9);
  ``clip_by_global_norm`` (clipped and not) within rtol 1e-6; the four
  schedules at a list of steps within rtol 1e-6 (host floats holding the
  float32 values).
* ``launch.steps``: every ``make_step`` mode on both frontends and
  ``fed-lm-smoke`` (f32, the reference's init converted), including
  ``grad_accum=2``: the train step's loss within rtol 1e-5 and new
  parameters within 1e-6 x max(1, max|ref|), prefill, decode and encode
  logits within rtol/atol 1e-4; and the sketch step within 1e-4 of
  max|ref sketch| (plus 1e-6: the sketch sums about a million signed terms
  in another order).
* ``repro_torch.examples.pretrain_lm`` at ``--preset tiny`` for 2 rounds
  on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ropt
from repro.common.sharding import SINGLE_DEVICE_RULES as R
from repro.configs import get_config as rget
from repro.launch import steps as RS
from repro.models import model as RM
from repro_torch import optim as topt
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as TS
from torch_threads import one_torch_thread  # noqa: F401

RTOL = dict(rtol=1e-6, atol=1e-9)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
            "z": rng.standard_normal((2, 2, 5)).astype(np.float32)}


def _close(got, want, **tol):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), **tol)


OPTS = {"sgd": lambda m: m.sgd(),
        "sgd_momentum": lambda m: m.sgd_momentum(0.9),
        "sgd_nesterov": lambda m: m.sgd_momentum(0.8, nesterov=True),
        "adamw": lambda m: m.adamw(),
        "adamw_wd": lambda m: m.adamw(b1=0.8, b2=0.99, weight_decay=0.01)}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    ropt_, topt_ = OPTS[name](ropt), OPTS[name](topt)
    rp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = params_from_numpy(_tree(0))
    rs, ts = ropt_.init(rp), topt_.init(tp)
    rsched = ropt.warmup_cosine(0.05, 2, 5)
    tsched = topt.warmup_cosine(0.05, 2, 5)
    for step in range(5):
        g = _tree(10 + step)
        ru, rs = ropt_.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp,
                              rsched(step))
        tu, ts = topt_.update(params_from_numpy(g), ts, tp, tsched(step))
        _close(tu, ru, **RTOL)
        if name.startswith("adamw"):
            assert ts["t"] == int(rs["t"]) == step + 1
            _close(ts["m"], rs["m"], **RTOL)
            _close(ts["v"], rs["v"], **RTOL)
        elif name != "sgd":
            _close(ts, rs, **RTOL)
        assert all(x.dtype == torch.float32 for x in tree_leaves(tu))
        rp, tp = ropt.apply_updates(rp, ru), topt.apply_updates(tp, tu)
        _close(tp, rp, **RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    rg, rn = ropt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      max_norm)
    tg, tn = topt.clip_by_global_norm(params_from_numpy(g), max_norm)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    _close(tg, rg, **RTOL)
    if max_norm > float(rn):
        _close(tg, g, rtol=0, atol=0)


SCHEDULES = {"constant_lr": (0.1,), "exponential_decay": (0.05, 0.999),
             "cosine_decay": (3e-3, 100, 0.1),
             "warmup_cosine": (3e-3, 20, 80, 0.1)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_reference(name):
    r = getattr(ropt, name)(*SCHEDULES[name])
    t = getattr(topt, name)(*SCHEDULES[name])
    for step in (0, 1, 2, 5, 19, 20, 21, 50, 79, 80, 99, 100, 150, 1000):
        got = t(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(r(step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# launch.steps
# ---------------------------------------------------------------------------

VLM, AUDIO, FED = "internvl2-1b-smoke", "hubert-xlarge-smoke", "fed-lm-smoke"
# "decode" runs make_step("prefill") first and holds both
STEP_CASES = [(VLM, "train", 1), (VLM, "train", 2), (VLM, "decode", 1),
              (AUDIO, "train", 1), (AUDIO, "train", 2), (AUDIO, "encode", 1),
              (FED, "train", 1), (FED, "train", 2), (FED, "decode", 1),
              (FED, "encode", 1)]


def _inputs(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 1:3] = -1
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32), "labels": labels}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(batch: dict, keys=None):
    keys = keys or list(batch)
    return ({k: jnp.asarray(batch[k]) for k in keys},
            {k: torch.from_numpy(batch[k].astype(np.int64)
                                 if batch[k].dtype == np.int32 else batch[k])
             for k in keys})


def _world(arch: str, grad_accum: int = 1):
    rcfg = dataclasses.replace(rget(arch), grad_accum=grad_accum)
    tcfg = dataclasses.replace(tget(arch), grad_accum=grad_accum)
    rp = jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(7), rcfg))
    return rcfg, tcfg, rp, params_from_numpy(rp)


@pytest.mark.parametrize("arch,mode,accum", STEP_CASES)
def test_make_step_matches_reference(arch, mode, accum):
    rcfg, tcfg, rp, tp = _world(arch, accum)
    rstep, tstep = jax.jit(RS.make_step(mode, rcfg, R)), TS.make_step(mode,
                                                                     tcfg)
    batch = _inputs(rcfg, 4, 8, 1)
    if mode == "train":
        jb, tb = _both(batch)
        r_new, r_loss = rstep(rp, jb, 0.1)
        t_new, t_loss = tstep(tp, tb, 0.1)
        np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)
        for g, w in zip(tree_leaves(t_new), jax.tree_util.tree_leaves(r_new)):
            w = np.asarray(w, np.float32)
            assert g.dtype == torch.float32
            assert np.abs(g.numpy() - w).max() <= 1e-6 * max(1.0,
                                                             np.abs(w).max())
        if accum == 2:      # accumulation is not one step on the whole batch
            whole, _ = TS.make_train_step(dataclasses.replace(
                tcfg, grad_accum=1))(tp, tb, 0.1)
            assert not all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(whole), tree_leaves(t_new)))
        return
    keys = [k for k in ("tokens", "patches", "features") if k in batch]
    jb, tb = _both(batch, keys)
    with torch.no_grad():
        if mode == "encode":
            np.testing.assert_allclose(tstep(tp, tb).numpy(),
                                       np.asarray(rstep(rp, jb)), rtol=1e-4,
                                       atol=1e-4)
            return
        rcache, rlog = jax.jit(RS.make_step("prefill", rcfg, R))(rp, jb)
        tcache, tlog = TS.make_step("prefill", tcfg)(tp, tb)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=1e-4,
                                   atol=1e-4)
        if mode == "decode":
            # the prefill's cache holds S positions (P + S with patches):
            # decode writes the last token's slot again, as both sides do
            pos = rcache["p0"]["k"].shape[2] - 1
            tok = np.argmax(np.asarray(rlog), -1)[:, None].astype(np.int32)
            _, rl = rstep(rp, rcache, jnp.asarray(tok), jnp.int32(pos))
            _, tl = tstep(tp, tcache, torch.from_numpy(tok.astype(np.int64)),
                          pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("arch", [VLM, AUDIO, FED])
def test_sketch_step_matches_reference(arch):
    rcfg, tcfg, rp, tp = _world(arch)
    batch = _inputs(rcfg, 2, 8, 3)
    jb, tb = _both(batch)
    want = np.asarray(jax.jit(RS.make_sketch_step(rcfg, R, k=16, seed=42))(
        rp, jb))
    got = TS.make_sketch_step(tcfg, k=16, seed=42)(tp, tb)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-6)


def test_make_step_unknown_mode_raises():
    with pytest.raises(ValueError, match="sketch"):
        TS.make_step("sketch", tget(FED))


def test_pretrain_example_tiny_on_cpu(capsys):
    """The example's loop end to end: 2 aggregations of a buffer of 2, so 4
    receives of 4 local AdamW steps each, finite losses."""
    from repro_torch.examples import pretrain_lm
    res = pretrain_lm.main(["--preset", "tiny", "--rounds", "2", "--device",
                            "cpu", "--seq", "32", "--batch", "4"])
    assert (res["versions"], res["receives"], res["local_steps"]) == (2, 4, 16)
    assert np.all(np.isfinite(res["losses"]))
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(res["params"]))
    out = capsys.readouterr().out
    assert "[pretrain] pretrain-tiny" in out and "perplexity" in out
