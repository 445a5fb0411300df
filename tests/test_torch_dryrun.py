"""The op-level cost counter against the reference's HLO cost analysis, the
kernels' cost formulas, the dry run against the reference's dry run, and
remat under sharding rules.

``launch.op_cost`` mirrors ``tests/test_hlo_cost.py``: a product's flops by
its formula, exactly as the reference counts them; a loop of n products n
times one; a backward more than 1.5 times its forward; ``exp``'s
transcendentals. Every kernel's ``meta`` route reports its formula, and
``flash_attention``'s at the serve shape is the 2.063e11 operations of
PERF.md's bound. A folded time loop counts what the unrolled one counts.

The dry runs (``repro_torch.launch.dryrun`` and ``repro.launch.dryrun``,
each CLI in a process of its own: the fake process group and XLA's device
count are process-global) agree on ``world`` and
``argument_size_in_bytes``. Their flops differ in attention by design: the
reference's ``chunked_attention`` computes every (query chunk, key chunk)
block, Sq x Sk pairs a head, and under ``remat="full"`` runs its forward
three times (the step, the superblock's recompute, ``remat_chunks``'s) and
two products' worth of backward; the port's kernels compute the causal
pairs once a pass (the forward twice, the backward 2.5 times one forward).
The rest of the step is held within 10% (the pure data-parallel
internvl2-1b) and 25% (codeqwen1.5-7b) of the reference's; the raw ratios
are printed (PERF.md records them).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import buffer_agg as ba
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import sens_sketch as sk
from repro_torch.launch import op_cost
from repro_torch.models import ssm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARTIFACT = os.path.join(ROOT, "artifacts", "dryrun",
                        "internvl2-1b__train_4k__pod.json")


def _jax_flops(fn, *shapes):
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_cost import analyze
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(jax.jit(fn).lower(*specs).compile().as_text(), 1)


def test_matmul_flops_match_hlo_cost():
    a, b = torch.empty(256, 512), torch.empty(512, 128)
    got = op_cost.count(torch.mm, a, b)
    want = 2 * 256 * 512 * 128
    assert got["flops_per_device"] == want
    ref = _jax_flops(lambda x, y: x @ y, (256, 512), (512, 128))
    assert abs(ref["flops_per_device"] - want) / want < 0.01
    assert got["unparsed_loops"] == 0
    # eager's traffic model: both operands read, the result written
    assert got["bytes_per_device"] == 4 * (256 * 512 + 512 * 128 + 256 * 128)


@pytest.mark.parametrize("n", [3, 17])
def test_loop_counts_each_product(n):
    c, xs = torch.randn(64, 64), torch.randn(n, 64, 64)

    def f():
        h = c
        for i in range(n):
            h = h @ xs[i]
        return h
    got = op_cost.count(f)
    assert got["flops_per_device"] == n * 2 * 64 ** 3
    assert got["unparsed_loops"] == 0


def test_backward_counts_more_than_forward():
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(32, 64)

    def loss():
        return torch.sum(torch.tanh(x @ w) ** 2)
    fwd = op_cost.count(loss)
    bwd = op_cost.count(lambda: torch.autograd.grad(loss(), w))
    assert bwd["flops_per_device"] > 1.5 * fwd["flops_per_device"]


def test_transcendentals_counted():
    got = op_cost.count(torch.exp, torch.empty(1000))
    assert got["transcendentals"] >= 1000
    assert got["flops_per_device"] == 1000


def _kernel(result, name):
    assert list(result["kernels"]) == [name]
    return result["kernels"][name]


def test_kernel_meta_routes_report_their_formulas():
    m = "meta"
    # flash_attention at the serve shape: 4 hd flops a causal pair and head
    B, S, H, Hkv, hd = 8, 2048, 24, 8, 128
    q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device=m)
    k = torch.empty(B, S, Hkv, hd, dtype=torch.bfloat16, device=m)
    r = op_cost.count(fa.flash_attention, q, k, k, causal=True)
    got = _kernel(r, "flash_attention")
    assert got["count"] == 1
    assert abs(got["flops"] - 2.063e11) / 2.063e11 < 1e-3
    assert got["flops"] == 4 * hd * B * H * S * (S + 1) // 2
    assert got["flops"] / 989e12 * 1e6 == pytest.approx(208.6, abs=0.05)
    assert got["bytes"] == 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    assert fa.flash_attention.launches == 0
    # its backward: 2.5 times the forward's operations, the lse read
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, device=m)
    r = op_cost.count(fa.flash_attention_bwd, q, k, k, o, o, lse, True)
    bwd = _kernel(r, "flash_attention_bwd")
    assert bwd["flops"] == 2.5 * got["flops"]
    assert bwd["bytes"] == 2 * (4 * B * S * H * hd + 4 * B * S * Hkv * hd) \
        + 4 * B * H * S
    out = fa.flash_attention_bwd(q, k, k, o, o, lse, True)
    assert [tuple(t.shape) for t in out] == [tuple(q.shape), tuple(k.shape),
                                             tuple(k.shape)]
    # a window counts the band's pairs
    r = op_cost.count(fa.flash_attention, q, k, k, causal=True, window=512)
    assert _kernel(r, "flash_attention")["flops"] == \
        4 * hd * B * H * fa.band_pairs(S, S, True, 512)
    # grouped_matmul: 2 G M N K
    a = torch.empty(4, 64, 4096, device=m)
    b = torch.empty(4, 4096, 384, device=m)
    r = op_cost.count(gm.grouped_matmul, a, b)
    assert _kernel(r, "grouped_matmul")["flops"] == 2 * 4 * 64 * 384 * 4096
    assert tuple(gm.grouped_matmul(a, b).shape) == (4, 64, 384)
    # buffer_agg: (L + 2) d words, 2 L d flops
    L, d = 5, 1_756_426
    r = op_cost.count(ba.buffer_agg, torch.empty(L, device=m),
                      torch.empty(d, device=m), torch.empty(L, d, device=m))
    got = _kernel(r, "buffer_agg")
    assert got["flops"] == 2 * L * d
    assert got["bytes"] == 4 * (L * d + 2 * d + L)
    # sens_sketch: 12 bytes an element, 9 k integer operations an element
    n, kk = 1_572_864, 16
    t = torch.empty(n, device=m)
    r = op_cost.count(sk.sens_sketch, t, t, t, k=kk)
    got = _kernel(r, "sens_sketch")
    assert got["bytes"] == 12 * n + 4 * kk
    assert got["int_ops"] == sk.INT_OPS_PER_ELEM_ROW * kk * n
    assert tuple(sk.sens_sketch(t, t, t, k=kk).shape) == (kk,)


@pytest.mark.parametrize("S", [3, 9])
@pytest.mark.parametrize("mix", ["mamba", "mlstm", "slstm"])
def test_folded_time_loop_counts_the_unrolled_loop(mix, S):
    """A recurrence's time loop on meta tensors, counted from two steps
    (``op_cost.fold``), counts what the unrolled loop counts on CPU
    tensors, forward and backward: flops, bytes and transcendentals, with
    the weights as leaves."""
    cfg = get_config("fed-lm-ssm-smoke")
    init = getattr(ssm, f"init_{mix}")(torch.Generator().manual_seed(0), cfg,
                                       "cpu")
    fwd = getattr(ssm, f"{mix}_forward")

    def run(device, grad):
        params = {k: v.detach().to(device).requires_grad_(
            v.is_floating_point()) for k, v in init.items()}
        leaves = [p for p in params.values() if p.requires_grad]
        x = torch.zeros(2, S, cfg.d_model, device=device,
                        requires_grad=grad)
        with op_cost.OpCounter() as c:
            y = fwd(params, x, cfg)
            if grad:
                torch.autograd.grad(y.float().sum(), [x] + leaves)
        r = c.result()
        return (r["flops_per_device"], r["bytes_per_device"],
                r["transcendentals"])
    for grad in (False, True):
        assert run("meta", grad) == run("cpu", grad), grad


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_folded_train_step_counts_the_unrolled_step(remat):
    """A whole train step of the recurrent family (xlstm's mLSTM and sLSTM
    mixers) under each remat: the folded count on meta tensors equals the
    unrolled count on CPU tensors (a checkpoint's recompute runs the fold
    inside the backward, where no hook is set)."""
    import dataclasses
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("xlstm-350m-smoke"), remat=remat)
    step = steps.make_train_step(cfg)
    got = []
    for device in ("cpu", "meta"):
        params = model.init_params(
            torch.Generator().manual_seed(0) if device == "cpu" else None,
            cfg, device)
        tok = torch.zeros(2, 7, dtype=torch.int32, device=device)
        with op_cost.OpCounter() as c:
            step(params, {"tokens": tok, "labels": tok}, 1e-3)
        got.append((c.flops, c.bytes, c.transcendentals))
    assert got[0] == got[1]
    assert got[0][0] > 0


# ---------------------------------------------------------------------------
# the dry runs, each CLI in its own process
# ---------------------------------------------------------------------------

def _start(pkg: str, out: str, *argv: str) -> subprocess.Popen:
    """One package's dry-run CLI in a process of its own, started."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launch.dryrun", *argv, "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)


def _finish(proc: subprocess.Popen) -> subprocess.CompletedProcess:
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _cli(pkg: str, out: str, *argv: str) -> subprocess.CompletedProcess:
    return _finish(_start(pkg, out, *argv))


def _reference_attention_flops(rec: dict) -> float:
    """The reference's attention products in a train_4k step at its
    per-device shape: Sq x Sk pairs a head (every chunk pair), 4 hd flops a
    pair, five passes (three forwards under remat "full" and
    ``remat_chunks``, a backward of two)."""
    cfg = get_config(rec["arch"])
    shards = {"data": 16, "model": 16, "pod": 2}

    def n(assign):
        if assign is None:
            return 1
        return math.prod(shards[a] for a in
                         (assign if isinstance(assign, list) else [assign]))
    B = rec["global_batch"] // n(rec["rules"]["batch"])
    H = cfg.num_heads // n(rec["rules"]["heads"])
    S = rec["seq_len"]
    return 5 * 4 * S * S * H * cfg.head_dim * B * cfg.num_layers


@pytest.mark.parametrize("arch,tol", [("internvl2-1b", 0.10),
                                      ("codeqwen1.5-7b", 0.25)])
def test_dryrun_matches_reference_dryrun(arch, tol, tmp_path):
    argv = ("--arch", arch, "--shape", "train_4k", "--mesh", "pod")
    name = f"{arch}__train_4k__pod.json"
    recs = {}
    procs = {pkg: _start(pkg, str(tmp_path / pkg), *argv)
             for pkg in ("repro_torch", "repro")}
    for pkg, proc in procs.items():
        r = _finish(proc)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "1 ok, 0 skipped, 0 errors" in r.stdout
        with open(os.path.join(str(tmp_path / pkg), name)) as fh:
            recs[pkg] = json.load(fh)
    port, ref = recs["repro_torch"], recs["repro"]
    assert port["status"] == ref["status"] == "ok"
    assert port["world"] == ref["world"] == 256
    assert port["unparsed_loops"] == 0
    for key in ref:
        if key not in ("xla_cost_analysis", "lower_s", "compile_s",
                       "hlo_lines", "analyze_s"):
            assert key in port, key
    assert port["rules"] == ref["rules"]
    assert port["params_total"] == ref["params_total"]
    assert port["memory_analysis"]["argument_size_in_bytes"] == \
        ref["memory_analysis"]["argument_size_in_bytes"]
    if arch == "internvl2-1b":
        with open(ARTIFACT) as fh:
            committed = json.load(fh)
        assert port["memory_analysis"]["argument_size_in_bytes"] == \
            committed["memory_analysis"]["argument_size_in_bytes"] \
            == 1_261_457_156
    # the port's attention: the causal pairs, twice forward, once backward
    cfg = get_config(arch)
    kern = port["kernels"]
    attn = kern["flash_attention"]["flops"] + kern["flash_attention_bwd"][
        "flops"]
    pairs = port["seq_len"] * (port["seq_len"] + 1) // 2
    local = _reference_attention_flops(port) / (
        5 * 4 * port["seq_len"] ** 2)
    assert attn == pytest.approx((2 * 4 + 10) * pairs * local, rel=1e-9)
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    rest = (port["flops_per_device"] - attn) / (
        ref["flops_per_device"] - _reference_attention_flops(ref))
    print(f"{arch}: flops_per_device port/reference {ratio:.4f}; "
          f"outside attention {rest:.4f}")
    assert abs(rest - 1) < tol, (ratio, rest)


def test_dryrun_cli_skips_and_errors(tmp_path):
    out = str(tmp_path / "out")
    r = _cli("repro_torch", out, "--arch", "hubert-xlarge", "--shape",
             "decode_32k")
    assert r.returncode == 0, r.stderr
    assert "0 ok, 1 skipped, 0 errors" in r.stdout
    with open(os.path.join(out, "hubert-xlarge__decode_32k__pod.json")) as fh:
        rec = json.load(fh)
    assert rec["status"] == "skipped" and "encoder-only" in rec["reason"]
    # a batch of 256 does not split into 3 microbatches: an error record
    r = _cli("repro_torch", out, "--arch", "phi4-mini-3.8b", "--shape",
             "train_4k", "--grad-accum", "3", "--tag", "ga3")
    assert r.returncode == 1
    assert "0 ok, 0 skipped, 1 errors" in r.stdout
    with open(os.path.join(
            out, "phi4-mini-3.8b__train_4k__pod__ga3.json")) as fh:
        rec = json.load(fh)
    assert rec["status"] == "error" and "grad_accum=3" in rec["error"]
    assert rec["overrides"] == {"grad_accum": "3"}
    assert "Traceback" in rec["traceback"]


REMAT_PROGRAM = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from types import SimpleNamespace

    torch.manual_seed(0)
    desc = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(1, 1)))
    mesh = dryrun.device_mesh(desc)
    rules = sharding.PRODUCTION_RULES
    seen = []
    orig = sharding.with_logical_constraint

    def spy(x, r, axes):
        seen.append((torch.is_grad_enabled(), r is rules))
        return orig(x, r, axes)
    sharding.with_logical_constraint = spy
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_config("fed-lm-smoke"), remat=remat)
        params = model.init_params(torch.Generator().manual_seed(0), cfg)
        spec = sharding.shard_pytree_spec(rules, model.param_axes(cfg, params))
        p = sharding.distribute(params, spec, mesh, True)
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
        batch = {"tokens": tok, "labels": tok}
        batch = sharding.distribute(batch, {"tokens": ("data", None),
                                            "labels": ("data", None)}, mesh)
        del seen[:]
        with implicit_replication():
            with sharding.logical_rules(rules):
                loss = model.loss_fn(p, batch, cfg)
            n_fwd = len(seen)
            # the backward runs outside the context: a recompute must
            # re-enter the forward's rules
            grads = torch.autograd.grad(loss, [p["embed"]["tok"]])
        out[remat] = {"n_fwd": n_fwd, "n_bwd": len(seen) - n_fwd,
                      "all_rules": all(r for _, r in seen),
                      "grad": grads[0].full_tensor().sum().item(),
                      "loss": loss.full_tensor().item()}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_remat_recompute_reads_the_forwards_rules(tmp_path):
    """On a 1 x 1 fake mesh, a remat "full" step's recompute (run by the
    backward, outside the forward's ``logical_rules``) passes through the
    same constraint sites under the same rules as the forward, and the loss
    and gradient equal remat "none"'s."""
    script = tmp_path / "remat.py"
    script.write_text(REMAT_PROGRAM)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    none, full = out["none"], out["full"]
    assert none["all_rules"] and full["all_rules"]
    assert none["n_bwd"] == 0
    # the recompute runs the superblocks' constraint sites again
    assert full["n_bwd"] > 0
    assert full["n_fwd"] == none["n_fwd"]
    assert full["loss"] == none["loss"]
    np.testing.assert_allclose(full["grad"], none["grad"], rtol=1e-6)
