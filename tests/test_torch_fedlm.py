"""The fed-lm world in the port against the JAX reference, on the CPU.

The federated LM fine-tuning scenario (``configs/fed_lm.py``, the
reference's ``tests/test_golden.py`` constants): its config, the token
corpus, the document partition, the LM world of ``build_task(...,
seq_len=16)`` and its calibration batch, output for output; the committed
legacy-threefry init against the JAX init; then ``run_algorithm`` with
``fedasync`` and ``fedpsa`` on the sequential engine and on the cohort
engine with both member kernels, and ``fedasync`` over streamed client
shards, reproducing ``tests/golden/fed-lm-smoke.json`` at the golden
suite's ``RTOL=1e-4, ATOL=1e-3`` with versions, dispatches, dropped and
launched exact; the three paths that raised until the port covered
them (a sweep, the mesh and ``remat="dots"`` on a token family) run to
their end; and the train CLI on the CPU. numpy copies are held exactly. (The reference's own fed-lm golden tests fail on the JAX here:
their init is drawn with the partitionable threefry; the port's run from
the committed init holds the golden.)
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import data as rdata
from repro.configs import get_config as rget
from repro.launch.train import build_task as r_build_task
from repro.models import model as RM
from repro_torch import data as tdata
from repro_torch.common.tree import FlatSpec, tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.convert import load_npz_params, params_from_numpy
from repro_torch.core.psa import PSAConfig
from repro_torch.federated.simulator import SimConfig, run_algorithm
from repro_torch.launch.train import build_task as t_build_task
from repro_torch.models import model as TM
from repro_torch.models import registry as treg
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                       "fed_lm_smoke_init_seed0.npz")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fed-lm-smoke.json")
FED = "fed-lm-smoke"
PHI = "phi4-mini-3.8b-smoke"
# tests/test_golden.py's fed-lm world (the constants the golden was made with)
WORLD = dict(samples=240, clients=6, alpha=0.3, seed=0, seq=16)
SIM = dict(num_clients=6, horizon=6_000.0, eval_every=3_000.0, seed=0,
           local_epochs=2, batch_size=8)
PSA = dict(queue_len=10)
RTOL, ATOL = 1e-4, 1e-3
ENGINES = [("sequential", "vmap"), ("cohort", "vmap"), ("cohort", "grouped")]


def _reference_init():
    with jax.threefry_partitionable(False):
        p = RM.init_params(jax.random.PRNGKey(WORLD["seed"]), rget(FED))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def world():
    W = WORLD
    return t_build_task(FED, W["samples"], W["alpha"], W["clients"],
                        W["seed"], seq_len=W["seq"])


def _run(world, name, **sim):
    cfg, clients, test, calib = world
    kw = (dict(psa_cfg=PSAConfig(**PSA), calib_batch=calib)
          if name == "fedpsa" else {})
    return run_algorithm(name, cfg, load_npz_params(FIXTURE), clients, test,
                         SimConfig(device="cpu", record_trajectory=True,
                                   **{**SIM, **sim}), **kw)


def _check_golden(res, golden):
    got, want = np.asarray(res.digests), np.asarray(golden["digests"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key in ("versions", "dispatches", "dropped", "launched"):
        assert getattr(res, key) == golden["final"][key], key
    np.testing.assert_allclose(res.final_accuracy,
                               golden["final"]["final_accuracy"], atol=2e-3)
    np.testing.assert_allclose(res.aulc, golden["final"]["aulc"], atol=2e-3)


@pytest.mark.parametrize("engine,mk", ENGINES)
@pytest.mark.parametrize("name", ["fedasync", "fedpsa"])
def test_fed_lm_matches_golden(world, name, engine, mk):
    with open(GOLDEN) as fh:
        golden = json.load(fh)["policies"][name]
    res = _run(world, name, engine=engine, member_kernel=mk)
    assert res.engine == engine
    _check_golden(res, golden)
    assert res.local_steps > 0
    if engine == "cohort":
        assert res.cohorts > 0


def test_fed_lm_streamed_shards_match_golden(world):
    """The cohort engine over streamed client shards (the list source's
    token rows, 2-client shards) holds the golden too."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)["policies"]["fedasync"]
    res = _run(world, "fedasync", engine="cohort", shard_size=2,
               shard_promote=2)
    _check_golden(res, golden)


@pytest.mark.parametrize("case", ["sweep", "mesh"])
def test_token_sweeps_and_mesh_raise(world, case, tmp_path):
    """Sweep lanes and the mesh over a token family, which raised until the
    port covered them, run to their end: a 2-lane fedbuff sweep whose lane
    0 is the standalone run bit for bit, and a fedbuff run on a one-rank
    gloo mesh that is the single-device run bit for bit. A sweep on a mesh
    still raises, as for the image models."""
    from repro_torch.federated import SweepConfig, run_sweep
    from torch_dist import Ranks
    cfg, clients, test, calib = world
    sim = SimConfig(device="cpu", record_trajectory=True, **SIM)
    solo = run_algorithm("fedbuff", cfg, load_npz_params(FIXTURE), clients,
                         test, sim)
    assert solo.versions > 0
    if case == "sweep":
        res = run_sweep("fedbuff", cfg, load_npz_params(FIXTURE), clients,
                        test, sim, SweepConfig(data_seeds=[0, 7]))
        assert res.versions == solo.versions
        assert res.digests[0] == solo.digests
        assert res.digests[1] != solo.digests
        with pytest.raises(ValueError, match="single-device"):
            run_sweep("fedbuff", cfg, load_npz_params(FIXTURE), clients,
                      test, dataclasses.replace(sim, mesh=object()),
                      SweepConfig(num_lanes=2))
    else:
        case = ("golden", "fedbuff", "cohort", "vmap", 0)
        (rank0,) = Ranks(1, "fedlm_program", {"cases": [case]},
                         tmp_path).results()
        res = rank0[case]
        assert res["digests"] == solo.digests
        assert res["versions"] == solo.versions
        assert res["final_accuracy"] == solo.final_accuracy


# ---------------------------------------------------------------------------
# configs, data, world
# ---------------------------------------------------------------------------

def test_fed_lm_config_matches_reference():
    r, t = rget(FED), tget(FED)
    ported = {f.name for f in dataclasses.fields(t)}
    assert {"q_chunk", "kv_chunk", "remat", "grad_accum",
            "num_prefix_tokens"} <= ported
    for f in dataclasses.fields(r):
        if f.name in ported:
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for prop in ("num_superblocks", "vocab_padded", "is_encoder_only",
                 "has_decode"):
        assert getattr(t, prop) == getattr(r, prop), prop
    # the smoke reduction carries the LM fields as the reference sets them
    for f in ("remat", "q_chunk", "kv_chunk", "num_prefix_tokens"):
        assert getattr(tget(PHI), f) == getattr(rget(PHI), f), f
    assert getattr(tget("phi4-mini-3.8b"), "remat") == "full"
    assert TM.count_params(t) == RM.count_params(r) == (6224, 6224)
    assert TM.count_params(tget("phi4-mini-3.8b")) == \
        RM.count_params(rget("phi4-mini-3.8b"))


@pytest.mark.parametrize("case", ["internvl2-1b", "hubert-xlarge",
                                  "vlm_family", "remat_dots"])
def test_unported_token_configs_raise(case):
    """The frontends (vision, audio) raise, naming the ROADMAP item; the
    fed-lm ssm and moe scenarios, which raised here until the port covered
    them, are held to the reference in ``tests/test_torch_fedlm_ssm.py`` and
    ``tests/test_torch_fedlm_moe.py``. ``remat="dots"``, which raised until
    the port covered it, runs to the "none" loss
    (``tests/test_torch_remat_dots.py`` holds its gradients)."""
    if case in ("internvl2-1b", "hubert-xlarge"):
        for arch in (case, case + "-smoke"):
            with pytest.raises(NotImplementedError, match="item 10c"):
                tget(arch)
        for arch in ("fed-lm-ssm-smoke", "fed-lm-moe-smoke"):
            assert tget(arch).name == arch
    elif case == "vlm_family":
        with pytest.raises(NotImplementedError, match="item 10c"):
            treg.get_family("vlm")
        assert treg.get_family("moe").data_kind == "tokens"
    else:
        p = load_npz_params(FIXTURE)
        batch = {"tokens": torch.arange(8).view(2, 4) % 7,
                 "labels": torch.arange(8).view(2, 4) % 5}
        losses = [TM.loss_fn(p, batch, dataclasses.replace(tget(FED),
                                                           remat=remat))
                  for remat in ("none", "dots")]
        assert torch.isfinite(losses[0]) and torch.equal(*losses)


@pytest.mark.parametrize("vocab,seed,n", [(32, 0, 3000), (512, 3, 2000)])
def test_lm_corpus_matches_reference(vocab, seed, n):
    got = tdata.make_lm_corpus(n, vocab=vocab, seed=seed)
    want = rdata.make_lm_corpus(n, vocab=vocab, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha,doc_len", [(0.0, 0), (0.3, 0), (0.9, 48)])
def test_document_partition_matches_reference(alpha, doc_len):
    toks = rdata.make_lm_corpus(4000, vocab=64, seed=1)
    got = tdata.document_partition(toks, 5, 16, doc_len=doc_len, alpha=alpha,
                                   seed=2)
    want = rdata.document_partition(toks, 5, 16, doc_len=doc_len,
                                    alpha=alpha, seed=2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("source", ["gaussian", "real"])
def test_build_lm_task_matches_reference(source):
    """The LM world (fed-lm-smoke at seq 16, the golden's) and its token
    calibration batch, output for output."""
    r = r_build_task(FED, 240, 0.3, 6, 0, source, seq_len=16)
    t = t_build_task(FED, 240, 0.3, 6, 0, source, seq_len=16)
    np.testing.assert_array_equal(t[2].x, r[2].x)
    np.testing.assert_array_equal(t[2].y, r[2].y)
    assert len(t[1]) == len(r[1])
    for a, b in zip(t[1], r[1]):
        assert a.kind == "tokens" and a.data.x.dtype == b.data.x.dtype
        np.testing.assert_array_equal(a.data.x, b.data.x)
        np.testing.assert_array_equal(a.data.y, b.data.y)
        got = list(a.epochs(2, 8, 5))
        want = list(b.epochs(2, 8, 5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"tokens", "labels"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert set(t[3]) == set(r[3]) == {"tokens", "labels"}
    for k in r[3]:
        assert t[3][k].dtype == r[3][k].dtype
        np.testing.assert_array_equal(t[3][k], r[3][k])
    # the cohort slab: token rows, zero padding, the reference's layout
    ts = tdata.StackedClients.from_datasets(t[1])
    from repro.data.loader import StackedClients as RStacked
    rs = RStacked.from_datasets(r[1])
    assert ts.kind == rs.kind == "tokens"
    np.testing.assert_array_equal(ts.x, rs.x)
    np.testing.assert_array_equal(ts.y, rs.y)
    np.testing.assert_array_equal(ts.sizes, rs.sizes)


def test_npz_fixture_is_the_reference_init():
    """The committed init is the reference's fed-lm-smoke init under JAX's
    legacy threefry (the golden's), and the converted tree keeps the
    reference's leaves in jax.tree_util order: FlatSpec's flat vector is
    the reference's ravel_pytree, leaf for leaf."""
    from jax.flatten_util import ravel_pytree
    want = _reference_init()
    got = load_npz_params(FIXTURE)
    conv = params_from_numpy(want)
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert FlatSpec(got)._paths == FlatSpec(conv)._paths == tuple(paths)
    for g, c, w in zip(tree_leaves(got), tree_leaves(conv),
                       jax.tree_util.tree_leaves(want)):
        assert g.dtype == c.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(c.numpy(), w)
    flat, _ = ravel_pytree(want)
    np.testing.assert_array_equal(FlatSpec(got).flatten(got).numpy(),
                                  np.asarray(flat))
    assert FlatSpec(got).size == 6224




def test_train_cli_fed_lm_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", FED, "--seq", "16", "--device", "cpu",
                "--alg", "fedasync", "--samples", "240", "--clients", "6",
                "--alpha", "0.3", "--horizon", "1500", "--out",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "final=" in out
    (path,) = tmp_path.iterdir()
    import json
    rec = json.loads(path.read_text())
    assert rec["model"] == FED and rec["engine"] == "cohort"
    assert 0.0 <= rec["final_accuracy"] <= 1.0 and rec["dispatches"] > 0


if __name__ == "__main__":
    # rewrite the init fixture from the reference (legacy threefry)
    flat = {}

    def _walk(tree, prefix):
        if isinstance(tree, dict):
            for key, val in tree.items():
                _walk(val, prefix + (key,))
        else:
            flat[".".join(prefix)] = np.asarray(tree, np.float32)

    _walk(_reference_init(), ())
    np.savez(FIXTURE, **flat)
