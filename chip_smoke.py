#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout (it builds the kernels
from ``src/repro_torch/csrc`` and reads the golden digests under
``tests/``). Phases, each of which raises on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` for every kernel source (all in parallel), with ptxas
   register/shared-memory/spill lines, and the ``[sass]`` line: the
   instruction mix of ``sens_sketch``'s hashing per (element, row) and
   its INT32-pipe operations;
3. kernel parity: each kernel against its plain PyTorch version on the
   card at the main paths' shapes and edge shapes: ``sens_sketch`` one
   vector at a time, the shard composition, the whole CIFAR tree and
   waves of 1, 3 and 8 members in one call, asyncfeded's two-row
   magnitude sketch of the CIFAR vector, and the exact-sign case
   (bit-equal); ``buffer_agg`` also over a zero global (fedfa's apply);
   the ``grouped_matmul`` mask (also through its split-K
   second pass) and bf16 promotion, ``flash_attention`` in f32
   (CUDA-core kernel) and bf16 (tensor-core kernel, with the worst
   element's share of its limit) at the serve prefill shapes of
   ``phi4-mini-3.8b``, ``codeqwen1.5-7b``, ``minitron-8b`` and
   ``qwen2-moe-a2.7b`` (``FA_SERVE_SHAPES``), the reference tests' shapes and Sq != Sk, and
   bit-identical repeated runs of the reducing
   kernels; ``flash_attention`` with a sliding window at
   ``FA_WINDOW_SHAPES`` (the long-context shape (1, 16384, 24/8, 128) with
   window 8,192, the full-width (2, 2048, 24/8, 128) with 512, the
   windowed fed-lm run's wave (32, 16, 2/2, 8) with 8, windows below a
   tile and off 64, Sq != Sk, MHA, hd 256, causal=False, rows that see no
   key) against the plain version one kv head at a time, f32 and
   bf16 (each bf16 case's share of ``bf16_limit`` and of its 2^-9 form),
   repeats bit-equal, and a window of at least Sk bit-equal to none;
4. kernel timing: CUDA events around each launch (L2 flushed before each),
   kernel / plain version / one-call library yardstick / computed bound,
   the kernel's share of its bound and its ratio to the library call;
   ``sens_sketch`` at ``fc0.w``, the CIFAR tree in one call and as 10
   one-leaf calls, and a wave of 8, and its probe (the hashing without
   the loads, the SM clock and the blocks' span, other grids); for the
   kernels redesigned for Hopper their registers and shared memory
   (ptxas) and ``grouped_matmul``'s split count and blocks; the windowed
   forward at the long-context shape beside the unwindowed kernel on the
   same inputs, the band's bound and its pair ratio (0.75), and SDPA with
   the band as a boolean mask;
5. golden: every async policy's run on the golden world reproduces
   ``tests/golden/<policy>.json`` on the card (fedpsa, fedbuff, fedasync,
   ca2fl, fedfa, fedpac, asyncfeded), and asyncfeded's cosine and sketch
   metrics the reference's digest streams in ``tests/torch_fixtures/``, on
   the sequential engine and on the cohort engine with both member
   kernels, each run with exact launch counts (``buffer_agg`` once per
   apply, every receive under fedfa; ``sens_sketch`` per sketch);
5b. sweeps: a 3-lane ``run_sweep`` of every policy on the golden world
   (data seeds [0, 0, 1234], ``SWEEP_HYPER`` on lane 1), the policies
   taking the two member kernels in turn: lane 0 holds the golden, lane 1
   or 2 (in turn) the port's standalone run at the lane tolerance (rtol
   1e-5, atol 1e-4),
   with exact launch counts (``buffer_agg`` per lane and apply,
   ``sens_sketch`` once per wave for all lanes plus each lane's refreshes,
   ``grouped_matmul`` as the standalone run's);
5c. resume and FedAvg: fedbuff (both engines) and fedpsa (cohort)
   checkpointed every 1,000 units, pruned to a mid-run snapshot and
   resumed, equal to the unbroken run (fedbuff exactly); ``run_fedavg`` on
   the three engine settings against ``tests/torch_fixtures/
   fedavg_golden_world.json``;
6. main path, sequential engine: FedPSA on ``paper-cifar10-cnn`` at full
   width (d = 1,756,426), with exact kernel launch counts (``sens_sketch``
   once per sketched model: receives + aggregations + 1);
7. main path, cohort engine: the same run with ``engine="cohort",
   member_kernel="grouped"``, with exact launch counts of all three
   kernels (``sens_sketch`` once per wave: waves + aggregations + 1);
7b. the other policies at full width: fedasync, fedpac, ca2fl, fedfa
   and asyncfeded (l2, sketch) on ``paper-cifar10-cnn``, cohort engine
   with ``member_kernel="grouped"``, horizon ``POLICY_HORIZON`` (1,200):
   exact launch counts,
   a finite (d,) global, accuracy in [0, 1], and each run's receives,
   wall, s/receive and peak device memory;
7c. the same window at full width: FedPSA with cuDNN's deterministic flag
   on, off and on (the two runs with it on must be bit-equal; s/receive
   of each), a 3-lane FedPSA sweep (data seeds [0, 0, 1], gamma [5, 1, 5])
   and ``run_fedavg``, with exact launch counts, s/receive, peak device
   memory and lane 0's digest gap to the standalone run;
7d. ``[population]``, the population path (lazy populations, streaming
   client shards, the side-stream prefetch): the path's kernels against
   their plain versions at its shapes (``grouped_matmul`` at G = 256 and
   768, ``sens_sketch`` over waves of 256 and 768 MLP members, its ticket
   buffer zero after growing, ``buffer_agg`` at d = 4,522), timed; (a) the
   smoke presets' fedasync, fedbuff and fedpsa runs (cohort/grouped,
   golden init) against the reference's digests in ``tests/torch_fixtures/
   population_digests.json`` (RTOL/ATOL) with the store's stats exact,
   prefetch on bit-equal to off, launch counts exact and ``grouped_matmul``
   equal to the monolithic engine's over ``pop[c]`` clients, and a
   profiled prefetching run whose kernels all ran on one stream while its
   side stream ran copies only; (b) phase 7c's full-width CIFAR FedPSA run
   through a list source of 8-client shards with prefetch on, within the
   golden tolerance of 7c's monolithic run (bit-equality printed), launch
   counts equal; (c) ``pop-100k`` and ``pop-1m`` at the reference
   population benchmark's load, fedasync and fedpsa, each profiled:
   s/receive, waves, peak host RSS and device memory, the store's bytes
   within the preset's ``resident_mb`` plus one wave's rows, stats, device
   busy share, and pop-1m fedpsa bit-equal with prefetch on and off;
   then pop-1m fedasync and fedpsa unprofiled, prefetch off, then on
   (s/receive of each run; bit-equal);
7e. ``[mesh]``, the mesh-sharded server and the data-parallel cohort
   engine, each job's ranks spawned by this script on the one card (the
   ``--mesh-rank`` entry): first the width probe behind the engine's
   split rule (cuDNN's grouped convolution, shares of 4 and 8 members
   bit-equal to a call of 8 or 16); (a) the golden world, cohort/grouped:
   fedpsa, fedfa and asyncfeded sketch on 1 NCCL rank bit-equal to phase
   5, all nine golden runs on 2 gloo ranks within the golden tolerance,
   fedpsa on 4 gloo ranks (d = 4,522 padded by 2); (b) phase
   7c's full-width window, FedPSA on 1 NCCL and 2 gloo ranks and
   asyncfeded l2 on the 2, each bit-equal to the single-device run (the
   lane tolerance is the gate); every rank's launch counts exact, every
   rank returning the same run, s/receive, each rank's peak memory and the
   collectives a receive; gloo's host time a collective on CUDA tensors;
   (c) full-width waves of 8 and 16 members
   through the cohort engine on 2 gloo ranks with the mesh and without
   it: every rank splits each wave, to the single-device bits, with
   the same launches; (d) the fed-lm world (fedasync, fedpsa, and fedpsa
   with a window of 8; cohort/grouped; fedpsa alone on NCCL) on 1 NCCL
   rank bit-equal to
   ``[fed-lm]``'s single-device runs and on 2 gloo ranks within the golden
   tolerance of the golden and the window fixture, each rank with one
   device's launches, and the 2-rank fedpsa run traced on rank 0 (every
   port kernel on one stream); (e) the fed-lm ssm and moe worlds
   (fedasync under "vmap", fedpsa under "grouped") on the 2 gloo ranks,
   bit-equal to the single-device cohort runs of 9c; then 2 NCCL ranks on
   the one card, which must fail;
8. profile: the first ``PROFILE_HORIZON`` (500) virtual units of both
   main paths, and one serve prefill plus decode, under
   ``torch.profiler``: the device's busy
   share of the wall time and the CUDA kernels by total time (printed; a
   trace with no device events is reported, not failed); it runs last,
   after phase 9, so that no profiler session precedes a timed run;
9. serve main path: ``phi4-mini-3.8b`` at full width (32 layers, bf16,
   random init on the card) through ``repro_torch.launch.serve`` with
   B = 8, prompt 2,048 and 32 generated tokens: ``flash_attention``
   launched exactly 32 times per prefill and 0 times per decode step,
   decode's logits at position S against a prefill of S + 1 tokens, the
   prefill's seconds, decode tokens/s and peak device memory; then the
   same checks and a counted run for ``phi4-mini-3.8b``'s long-context
   variant (window 8,192; B = 1, a prompt of 16,384, so prefill rolls the
   prompt's tail into the 8,192-slot ring, and 32 tokens through it:
   ``serve.generate`` on ``cfg.for_long_context()``) and for
   ``codeqwen1.5-7b`` and ``minitron-8b`` at B = 8, prompt 2,048, gen 32,
   each through ``serve.main``;
9b. ``[fed-lm]``, federated LM fine-tuning on the dense family (the
   small world's parts before ``[mesh]``, which holds its mesh runs to
   them; the full-width ones after the serve runs, before the profiles;
   each sub-phase prints its seconds): the attention backward kernel
   (``flash_attention_bwd``) against its plain version in f32 at the golden
   world's wave shape (32, 16, 2/2, 8) (the CUDA-core kernels) and in bf16
   at the full-width training shape (2, 2048, 24/8, 128) and at edge shapes
   (hd 16 to 128 on the tensor-core kernels, 256 on the CUDA-core ones)
   against the float64 backward (``bwd_bf16_tc_limit`` on the tensor
   cores, ``bwd_bf16_limit`` on the CUDA cores), the forward kernels' lse,
   repeated runs bit-equal, the tensor-core kernels' registers, spill bytes
   (none) and shared memory, and the full-width time beside the plain
   backward, the CUDA-core kernels on the same inputs and the autograd
   backward of ``F.scaled_dot_product_attention`` (L2 flushed); the fed-lm world
   (``fed-lm-smoke``, 6 clients, seq 16) with fedasync and fedpsa on the
   three engine settings against ``tests/golden/fed-lm-smoke.json``
   (RTOL/ATOL, counters exact), exact launch counts of all five kernels
   (``_fedlm_want``), fedpsa cohort/grouped repeated bit-equal, and the
   train CLI (``--arch fed-lm-smoke --seq 16``); then ``local_update`` of
   ``phi4-mini-3.8b`` at full width (bf16, remat "full", random init on the
   card, 4 sequences of 2,048 tokens at batch 2: two steps) twice: 64
   forward and 32 backward attention launches a step and nothing else, a
   finite delta, the two runs bit-equal, seconds a step, peak memory and
   (second run, profiled) the device's busy share and the tensor-core
   backward kernels once each a backward call. With a window: the
   backward at ``FEDLM_BWD_WINDOW`` (the tensor-core kernels at the
   long-context and full-width shapes and at edges against float64, the
   CUDA-core ones in f32, at the windowed fed-lm run's wave shape
   included, and at hd 256; ``FA_WINDOW_SHAPES``' two causal=False shapes
   in both dtypes, one with rows that see no key, whose gradient sends
   do / Sk to every key's dv: ``FA_EMPTY_ROWS``, also timed), its time at
   the long-context
   shape beside the unwindowed backward and SDPA's with the mask, and
   ``fed-lm-smoke`` with a window of 8, fedasync and fedpsa on
   cohort/grouped, against the reference's digests in
   ``tests/torch_fixtures/fed_lm_window8_digests.json`` with exact launch
   counts. Sweeps: 3-lane ``run_sweep``s of fedasync (under ``"vmap"``),
   fedpsa and windowed fedpsa (under ``"grouped"``), lane 0 held
   to the golden (or the window fixture), every lane to the reference's
   lanes (``tests/torch_fixtures/fed_lm_sweep_digests.json``), launches
   exact (``buffer_agg`` S x versions, ``sens_sketch`` waves + S x
   (versions + 1) for fedpsa, ``grouped_matmul`` and the local steps as
   the standalone run's). The other five policies (fedbuff, ca2fl, fedfa,
   fedpac, asyncfeded l2/cosine/sketch) on cohort/grouped against the
   reference's runs in ``tests/torch_fixtures/fed_lm_policies_digests.json``,
   launches exact. Remat "dots" (selective checkpoints under JAX's
   ``dots_with_no_batch_dims_saveable`` rule): at the nested depth of
   ``llama3-405b-smoke`` in 3 scan groups bit-equal to "none" and "full",
   and the full-width step twice under "dots" beside "full", bit-equal to
   it, with its seconds a step and peak memory (at 1 x 2,048 tokens a
   step if it does not fit at 2 x 2,048, after printing the bytes asked
   for).
9c. ``[families]``, the recurrent, MoE and hybrid LM families. Before
   ``[mesh]``: ``grouped_matmul``, ``buffer_agg`` and ``sens_sketch``
   against their plain versions at the fed-lm ssm and moe shapes;
   ``fed-lm-ssm-smoke`` and ``fed-lm-moe-smoke`` (horizon 2,000),
   fedasync on the three engine settings and fedpsa on cohort/grouped,
   against the reference's runs in
   ``tests/torch_fixtures/fed_lm_{ssm,moe}_digests.json`` from its inits
   there, launches exact (``_fedlm_want``); 3-lane sweeps of both
   (data seeds 0, 1, 2; fedasync under ``"vmap"``, fedpsa under
   ``"grouped"``) against the reference's lanes in ``tests/torch_fixtures/
   fed_lm_families_sweep_digests.json`` at the lane tolerance (lane 0 also
   against the sequential fixture), launches exact (their 2-rank runs are
   ``[mesh]``'s (e)). After the full-width fed-lm runs, before the
   profiles: two forward-backward passes of
   an MoE layer bit-equal (f32, bf16, a grouped wave of 3, with dropped
   choices); ``jamba-v0.1-52b`` and ``arctic-480b`` at ``-smoke`` size on
   the card (finite loss and gradients, launches, decode vs prefill) and at
   full size on the meta device; then ``xlstm-350m`` and
   ``qwen2-moe-a2.7b`` at full width (random bf16 init on the card; B = 8,
   prompts 512 and 2,048, 32 tokens through ``serve.generate``): decode vs a prefill
   of one more token (xlstm at ``FAMILY_RECURRENT_GATE_PROMPT``; qwen2-moe
   gated at lossless capacity in f32
   arithmetic at ``FAMILY_GATE_BATCH``, its shipped bf16 gap printed),
   ``flash_attention`` once a prefill per attention layer and never in
   decode, prefill s, decode ms a step, peak memory, and from the profiler
   the launches a prefill (xlstm: the line through
   ``FAMILY_PROFILE_PROMPTS``) and a decode step and the device's busy
   share; a ``{"families": ...}`` JSON line before the kernels line.
9d. ``[frontends]``, the vision and audio frontends (after
   ``[families]``, before the profiles): ``flash_attention`` at
   internvl2-1b's prefill (8, 2304, 14/2, 64, causal: a GQA group of 7),
   hubert-xlarge's encode (8, 2048, 16/16, 80, non-causal: hd 80) and an
   edge (f32 and bf16, repeats bit-equal) and its backward at both train
   shapes and the edge (bf16 against float64; f32 at the edge), each timed
   beside its plain version, SDPA and its bound; ``internvl2-1b`` served
   at full width (B = 8, 256 patches + a prompt of 2,048, 32 tokens
   through ``serve.generate``; decode at position P + S within
   ``SERVE_TOL`` of a prefill of one more token, ``flash_attention`` 24 a
   prefill and 0 a decode step); ``hubert-xlarge`` encoded at full width
   (B = 8, 2,048 frames: 48 launches; its first 2 superblocks in f32
   arithmetic within 2e-5 x max|logit| of the plain attention); both
   trained through ``launch.steps.make_train_step`` at full width (hubert
   B = 4 with grad_accum 2, internvl2 B = 2), two steps twice, the runs
   bit-equal, launches exact; ``make_sketch_step`` on hubert (one
   ``sens_sketch`` launch over d = 946,260,480, held leaf by leaf against
   the chunked plain version, timed against its bound, the layout table's
   build timed); ``repro_torch.examples.pretrain_lm --preset 20m`` for 3
   rounds with exact launches; a ``{"frontends": ...}`` JSON line before
   the kernels line.
9e. ``[legacy]``, the legacy class-based servers (after ``[frontends]``):
   the reference's ``benchmarks/kernel_micro.py`` server-step cell at
   CIFAR full width (``paper-cifar10-cnn``, d = 1,756,426): legacy FedPSA
   against ``servers.make_server("fedpsa")``, both with the simulator's
   ``make_sketch_fn``, 60 arrivals a pass, a warm-up pass then a timed one:
   µs an arrival each, ``speedup_x``, the final parameters within 1e-4,
   launches exact on each side (``sens_sketch`` at init and each
   aggregation on both, ``buffer_agg`` each aggregation on the fused side
   only); then fedasync, fedbuff, ca2fl, fedfa and fedpac legacy against
   their policies on one pass (flags, versions, parameters within 1e-5,
   launches exact).
9f. ``[examples]``: the examples' entry points, ``quickstart.main`` at
   ``EXAMPLE_QUICKSTART_HORIZON`` (two 3-lane sweeps; cut from its own
   30,000) and ``paper_protocol.main`` with ``--horizon
   EXAMPLE_PROTOCOL_HORIZON`` (8 runs, then its ordering, thermometer and
   kappa lines), each with ``--device cuda``, their printed lines logged,
   launches exact in total; a ``{"legacy": ..., "examples": ...}`` JSON
   line before the kernels line.
9g. ``[dryrun]`` (after ``[examples]``, before the profiles): the dry-run
   CLI (``python -m repro_torch.launch.dryrun``, no card visible to it) in
   four processes side by side, ``DRYRUN_CASES`` on the pod mesh, each
   record ``ok`` with its flops, bytes and collectives printed; then the
   phase-9 prefill of ``phi4-mini-3.8b`` (B = 8, 2,048 tokens) counted by
   ``launch.op_cost`` on the card and on meta tensors: flops, bytes and
   ``flash_attention``'s count and cost equal, its flops a launch over the
   bf16 tensor-core peak PERF.md's 208.6 µs, and the measured prefill
   seconds against ``max(flops / 989e12, bytes / 3.35e12)`` as a share of
   that bound; its own ``[time]`` line.

Then it prints one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line. Without a card it exits non-zero
and prints no result. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, as the on-chip
# measurement guide tabulates them) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The data sheet gives no INT32 rate. A Hopper SM has 64 INT32 lanes beside
# its 128 FP32 lanes, and the FP32 peak counts an FMA as two operations, so
# the INT32 pipe's peak is a quarter of the FP32 figure: 16.75 TOP/s.
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
# sens_sketch: integer operations per (element, projection row) that the
# function needs on the INT32 pipe. Inner pcg: (state >> 28) + 4 as one
# LEA.HI, the variable shift, the XOR, word >> 22, and one three-input LOP3
# that also folds in the seed (5). Outer pcg: only bit 31 is read, and
# word >> 22 has a zero top bit, so its last shift and XOR are dead: LEA.HI,
# shift, XOR (3). Sign: one LOP3 moves bit 31 of the hash onto s (1). Not
# on this pipe: the three multiplies (IMAD, FMA pipe), the per-row state add
# ((base + r) * A is base * A plus a constant; either pipe takes it) and the
# FADD into the row's sum. phase_build prints what the built kernel issues.
SKETCH_INT_OPS_PER_ELEM_ROW = 9

GOLDEN_WORLD = dict(model="paper-synthetic-mlp", samples=1_500, classes=10,
                    dim=32, clients=8, alpha=0.3, seed=0)
GOLDEN_SIM = dict(num_clients=8, horizon=6_000.0, eval_every=3_000.0, seed=0)
GOLDEN_PSA = dict(queue_len=10)
RTOL, ATOL = 1e-4, 1e-3
CIFAR_D = 1_756_426
# grouped_matmul launches per local step of the CIFAR CNN on the cohort
# engine under member_kernel="grouped": forward, dW and dx of its three
# dense layers, and the weight gradient of its two convolutions
# (models/member_math.py MemberConv2d)
CNN_GM_PER_STEP = 3 * 3 + 2
# The CIFAR CNN's dense layers (fc0: 4096 -> 384, fc1: 384 -> 192) at the
# batch size 64 of a local step: the grouped_matmul main-path shapes.
FC_SHAPES = {"fc0": (64, 4096, 384), "fc1": (64, 384, 192)}
# The CNN's convolution weight gradients as grouped_matmul products (M, K,
# N) = (C_out, images x H x W, C_in x 5 x 5) at the batch size 64
CONV_WGRAD_SHAPES = {"conv0": (64, 64 * 32 * 32, 3 * 25),
                     "conv1": (64, 64 * 16 * 16, 64 * 25)}
# tests/test_grouped_matmul.py's edge shapes (G, M, K, N)
GM_EDGE_SHAPES = ((1, 8, 16, 16), (3, 130, 200, 96), (5, 1, 7, 3),
                  (4, 32, 256, 64))
# flash_attention: the serve path's prefill shape (phi4-mini-3.8b, B = 8,
# prompt 2,048) as (B, Sq, Sk, H, Hkv, hd, causal), then
# tests/test_flash_attention.py's shapes and a top-left causal Sq != Sk
FA_SERVE = (8, 2048, 2048, 24, 8, 128, True)
# the prefill shapes of the other serve runs at B = 8, prompt 2,048:
# codeqwen1.5-7b (MHA, 32/32), minitron-8b (32/8) and qwen2-moe-a2.7b (MHA,
# 16/16)
FA_SERVE_SHAPES = (FA_SERVE, (8, 2048, 2048, 32, 32, 128, True),
                   (8, 2048, 2048, 32, 8, 128, True),
                   (8, 2048, 2048, 16, 16, 128, True))
FA_EDGE_SHAPES = ((2, 64, 64, 4, 2, 16, True), (1, 128, 128, 8, 8, 32, True),
                  (2, 64, 64, 4, 1, 16, False), (1, 100, 100, 2, 2, 8, True),
                  (1, 33, 33, 4, 2, 64, False), (2, 40, 72, 6, 2, 32, True),
                  (2, 72, 40, 6, 2, 128, True))
# bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, dense): the
# card's rate for flash_attention's bf16 operands (a bf16 x bf16 product is
# exact in f32, so the matrix unit with f32 accumulation does the same work)
BF16_TC_FLOPS_PER_S = 989e12
SERVE = dict(arch="phi4-mini-3.8b", batch=8, prompt=2048, gen=32, seed=0)
# [dryrun]: the dry run's combinations on the pod mesh (pure data
# parallel; heads and mlp over model with embed over data; expert_mlp over
# model; a sequence-sharded decode cache)
DRYRUN_CASES = (("phi4-mini-3.8b", "train_4k"), ("codeqwen1.5-7b", "train_4k"),
                ("qwen2-moe-a2.7b", "prefill_32k"),
                ("phi4-mini-3.8b", "decode_32k"))
# the serve path's other runs: phi4-mini-3.8b's long-context variant
# (window 8,192; a prompt of twice the window, so prefill rolls the prompt's
# tail into the ring, and 32 tokens decoded through the ring) and the two
# other dense configs that fit the card, at the serve shape
SERVE_LONG = dict(arch="phi4-mini-3.8b", batch=1, prompt=16384, gen=32,
                  seed=0, long_context=True)
SERVE_MORE = tuple(dict(SERVE, arch=a) for a in ("codeqwen1.5-7b",
                                                 "minitron-8b"))
# sliding-window attention as (B, Sq, Sk, H, Hkv, hd, causal, window): the
# long-context prefill's shape and the full-width training shape with a
# window of 512, and the windowed fed-lm run's wave (fed-lm-smoke, 32
# sequences of 16, 2/2 heads of 8, window 8); then windows below a tile
# and not a multiple of 64, Sq < Sk
# and Sq > Sk, MHA (32/32), hd 256, causal=False, and causal=False with rows
# that see no key (Sq >= Sk + window: the mean of v, as the reference)
FA_WINDOW = (1, 16384, 16384, 24, 8, 128, True, 8192)
FA_WINDOW_SHAPES = (FA_WINDOW, (2, 2048, 2048, 24, 8, 128, True, 512),
                    (32, 16, 16, 2, 2, 8, True, 8),
                    (2, 300, 300, 8, 2, 64, True, 17),
                    (2, 300, 300, 8, 2, 64, True, 200),
                    (2, 200, 320, 6, 2, 64, True, 100),
                    (2, 320, 200, 6, 2, 128, True, 150),
                    (1, 1024, 1024, 32, 32, 128, True, 300),
                    (1, 300, 300, 4, 2, 256, True, 77),
                    (2, 333, 333, 6, 3, 128, False, 129),
                    (1, 400, 200, 4, 2, 64, False, 50))
# decode logits at position S vs the last logits of a prefill of S + 1
# tokens, in bf16 through 32 layers: max |diff| <= SERVE_TOL * max |prefill|
SERVE_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} x{count} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.splitlines()[0])
    return name, count, smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        log(f"[build] {name}.cu nvcc {rep['seconds']:.2f}s"
            f"{' (cached)' if rep['cached'] else ''}")
        entry = ""
        for line in rep["log"].splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {entry}: {line.strip()}")
    log(f"[build] all sources in {wall:.2f}s (parallel)")
    _sass_mix(_build, "sens_sketch", "sens_sketch_tilesILi16ELi0E", elems=4,
              rows=16)


def _kernel_name(mangled: str) -> str:
    """``name[template args]`` of a mangled kernel in an anonymous
    namespace (``_ZN.._GLOBAL__N__<hash>_<n>_<file>_cu_<hash><len><name>I..E``)."""
    import re
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled[:48]
    rest = mangled[m.end():]
    name, args = rest[:int(m.group(1))], rest[int(m.group(1)):]
    end = args.find("EEv")
    return f"{name}[{args[1:end + 1]}]" if args.startswith("I") and end > 0 else name


# SASS opcodes that issue to the INT32 pipe (the integer ALU: shifts,
# logic, LEA, adds, compares and selects); IMAD, IMAD.HI and VIADD are
# left out (the FMA pipe executes IMAD; VIADD's pipe is not documented).
INT32_PIPE = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "FSEL", "SEL", "PRMT",
              "IABS", "IMNMX", "BMSK", "BREV", "FLO", "POPC", "SGXT")
_BRANCHES = ("BRA", "EXIT", "RET", "CALL", "BSSY", "BSYNC")


def _sass_mix(_build, lib: str, func: str, elems: int, rows: int) -> None:
    """Print the instruction mix of ``func``'s hashing in the built library:
    its largest basic block (the unrolled hashes of ``elems`` elements x
    ``rows`` rows), per (element, row), and the INT32-pipe operations among
    them; then the same over the smallest loop around it (one step:
    both load paths, s and the loop's own instructions)."""
    import re
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target(lib))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = sass[sass.index(func):]
    nxt = body.find("Function :", 1)
    body = body if nxt < 0 else body[:nxt]
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;",
        body)]
    jumps = [(int(a, 16), int(t, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?BRA[^;]*?(0x[0-9a-f]+)", body)]
    targets = {t for _, t in jumps}
    blocks, cur = [], []
    for a, op in ins:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((a, op))
        if op.split(".")[0] in _BRANCHES:
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    hot = max(blocks, key=len)
    lo, hi = hot[0][0], hot[-1][0]
    loops = [(t, a) for a, t in jumps if t <= lo and a >= hi]
    loop = min(loops, key=lambda r: r[1] - r[0]) if loops else (lo, hi)
    pairs = elems * rows

    def mix(ops):
        counts = {}
        for op in ops:
            key = op.split(".")[0]
            counts[key] = counts.get(key, 0) + 1
        per = {k: round(v / pairs, 2) for k, v in sorted(counts.items())}
        return per, round(sum(v for k, v in counts.items()
                              if k in INT32_PIPE) / pairs, 2)

    per, int_ops = mix([op for _, op in hot])
    _, loop_int = mix([op for a, op in ins if loop[0] <= a <= loop[1]])
    log(f"[sass] {func}: hash block {len(hot)} instructions for {elems} "
        f"elements x {rows} rows, {per['FADD'] if 'FADD' in per else 0} FADD "
        f"a pair; per (element, row): {per}; INT32-pipe operations per "
        f"(element, row): {int_ops} in the hash block, {loop_int} over the "
        f"step loop ({sum(loop[0] <= a <= loop[1] for a, _ in ins)} "
        f"instructions)")


def _rand(torch, rng, shape, dev, positive=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if positive else x).to(dev)


def phase_parity(torch, dev):
    """Kernel vs plain version on the card. Returns max |err| per kernel."""
    from repro_torch.kernels import buffer_agg as ba
    rng = np.random.default_rng(0)
    errs = {"buffer_agg": 0.0}
    # buffer_agg: a different summation order from the plain version
    # (fmaf chain vs addcmul) moves a result by a few ulp of its magnitude.
    # (5, CIFAR_D, zero global): fedfa's apply, a zero global every receive
    for L, d, zero in ((5, CIFAR_D, False), (5, CIFAR_D, True), (1, 64, False),
                       (8, 8193, False), (20, 100, False)):
        w = torch.softmax(_rand(torch, rng, (L,), dev), 0)
        g, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
        if zero:
            g = torch.zeros_like(g)
        got = ba.buffer_agg(w, g, u)
        want = ba.buffer_agg_plain(w, g, u)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-6 * (1.0 + float(want.abs().max())) * L
        log(f"[parity] buffer_agg L={L} d={d}{' zero global' if zero else ''} "
            f"max|err|={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"buffer_agg L={L} d={d}: {err} > {tol}")
        errs["buffer_agg"] = max(errs["buffer_agg"], err)

    errs["sens_sketch"] = _parity_sketch(torch, dev, rng)
    errs["grouped_matmul"] = _parity_grouped(torch, dev, rng)
    (errs["flash_attention"], errs["flash_attention_bf16"],
     errs["flash_attention_bf16_share"]) = _parity_flash(torch, dev, rng)
    errs["flash_attention_window"] = _parity_flash_window(torch, dev, rng)
    return errs


def _cifar_spec(torch):
    from repro_torch.configs import get_config
    from repro_torch.common.tree import FlatSpec
    from repro_torch.models.model import init_params
    return FlatSpec(init_params(torch.Generator().manual_seed(0),
                                get_config("paper-cifar10-cnn")))


def _sketch_rows(torch, rng, dev, B: int, d: int):
    """(B, d) theta, g and F (F >= 0) rows."""
    return (_rand(torch, rng, (B, d), dev), _rand(torch, rng, (B, d), dev),
            _rand(torch, rng, (B, d), dev, positive=True))


def _sketch_tol(torch, t, g, f, k: int):
    """Per member: 1e-5 * sum|s| / sqrt(k) + 1e-7 (the kernel and the plain
    version add the same terms in different orders)."""
    s = torch.abs(g * t - 0.5 * f * t * t).double().sum(-1, keepdim=True)
    return 1e-5 * s / math.sqrt(k) + 1e-7


def _parity_sketch(torch, dev, rng) -> float:
    """sens_sketch vs its plain version: one-vector calls at the CIFAR
    leaves' sizes and edge sizes for every k, the 4-shard index_offset
    composition, the whole CIFAR tree in one call, waves of 1, 3 and 8
    members for every k (rows of d = 1,756,426 elements, so every odd
    member's rows are not 16-byte aligned), asyncfeded's magnitude sketch
    (two CIFAR-vector rows over a one-leaf table, g = 1, F = 0),
    bit-identical repeats, and an exact-sign case: theta = 1, F = 0 and integer g in [-3, 3] make every
    partial sum an integer below 2^24, so a single wrong sign shows; the
    kernel must then equal the plain version bit for bit for k in {1, 4,
    16} (scales 1, 1/2, 1/4) and within one ulp for k = 32 (1/sqrt(32) is
    rounded). Returns the worst max |err|."""
    from repro_torch.kernels import sens_sketch as ss
    cifar = _cifar_spec(torch)
    worst = 0.0

    def check(what, got, want, tol):
        nonlocal worst
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"sens_sketch {what}: {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        err = (got - want).abs()
        share = float((err / tol).max())
        log(f"[parity] sens_sketch {what} max|err|={float(err.max()):.3e} "
            f"worst at {share:.3f} of its tolerance")
        if not share <= 1.0:
            raise AssertionError(f"sens_sketch {what}: {share} of tolerance")
        worst = max(worst, float(err.max()))

    cases = [(n, 16) for n in cifar.sizes] + \
        [(d, k) for d in (1, 7, 4097, 20000) for k in ss.KS]
    for d, k in cases:
        t, g, f = (x[0] for x in _sketch_rows(torch, rng, dev, 1, d))
        check(f"d={d} k={k}", ss.sens_sketch(t, g, f, k=k, seed=12345 + d),
              ss.sens_sketch_plain(t, g, f, k=k, seed=12345 + d),
              _sketch_tol(torch, t, g, f, k)[0])

    d = 4096 + 640
    t, g, f = (x[0] for x in _sketch_rows(torch, rng, dev, 1, d))
    bounds = np.linspace(0, d, 5).astype(int)
    parts = sum(ss.sens_sketch(t[lo:hi], g[lo:hi], f[lo:hi], k=16, seed=11,
                               index_offset=int(lo))
                for lo, hi in zip(bounds[:-1], bounds[1:]))
    check("4-shard index_offset composition", parts,
          ss.sens_sketch(t, g, f, k=16, seed=11),
          _sketch_tol(torch, t, g, f, 16)[0])

    for B, ks in ((1, ss.KS), (3, ss.KS), (8, (16,))):
        t, g, f = _sketch_rows(torch, rng, dev, B, cifar.size)
        for k in ks:
            table = ss.layout_table(cifar.sizes, 42, k, str(dev))
            got = ss.sens_sketch_rows(t, g, f, table)
            check(f"CIFAR tree, wave of B={B} k={k} in one call", got,
                  ss.sens_sketch_rows_plain(t, g, f, table),
                  _sketch_tol(torch, t, g, f, k))
            if not torch.equal(got, ss.sens_sketch_rows(t, g, f, table)):
                raise AssertionError(f"sens_sketch B={B} k={k} is not "
                                     f"bit-identical across runs")
        log(f"[parity] sens_sketch CIFAR tree B={B}: repeated runs "
            f"bit-identical")
        del t, g, f

    # asyncfeded metric="sketch": dw and the drift as two rows of one
    # launch over a one-leaf table, g = 1, F = 0 (the magnitude sketch)
    from repro_torch.core import psa as psa_lib
    rows = _rand(torch, rng, (2, cifar.size), dev)
    ones, zeros = psa_lib._unit_rows(cifar.size, rows.device)
    table = ss.vector_table(cifar.size, 42, 0, 16, rows.device)
    got = ss.sens_sketch_rows(rows, ones, zeros, table)
    check("magnitude sketch, two rows of the CIFAR vector in one call", got,
          ss.sens_sketch_rows_plain(rows, ones, zeros, table),
          _sketch_tol(torch, rows, ones, zeros, 16))
    if not torch.equal(got, ss.sens_sketch_rows(rows, ones, zeros, table)):
        raise AssertionError("magnitude sketch is not bit-identical across runs")
    del rows

    B = 3
    g = torch.from_numpy(rng.integers(-3, 4, (B, cifar.size)).astype(
        np.float32)).to(dev)
    t, f = torch.ones_like(g), torch.zeros_like(g)
    for k in ss.KS:
        table = ss.layout_table(cifar.sizes, 42, k, str(dev))
        got = ss.sens_sketch_rows(t, g, f, table)
        want = ss.sens_sketch_rows_plain(t, g, f, table)
        torch.cuda.synchronize()
        # same-sign floats: the distance of their bit patterns is in ulps
        dist = (got.view(torch.int32).long() - want.view(torch.int32).long())
        ulps = int(torch.where(got == want, 0, dist.abs()).max())
        log(f"[parity] sens_sketch exact-sign B={B} k={k}: {ulps} ulp "
            f"({'bit-equal' if ulps == 0 else 'not bit-equal'})")
        if ulps > (1 if k == 32 else 0):
            raise AssertionError(f"sens_sketch exact-sign k={k}: {ulps} ulp "
                                 f"from the plain version")
    return worst


def _gm_rel(torch, got, want) -> tuple:
    """(max |got - want|, that over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (float(want.float().abs().max()) + 1e-30)


def _parity_grouped(torch, dev, rng) -> float:
    """grouped_matmul vs its plain version: the forward, dW and dx products
    of fc0 and fc1 at G = 4 and 8 (dW and dx through the transposed views
    the backward passes), the CNN's convolution weight gradients at G = 4,
    the edge shapes, the valid mask, bf16 promotion
    (the fc0 forward through the split-K second pass), a long K split ten
    ways, and bit-identical repeated runs. Tolerance: max|err| <= 1e-5 *
    max|plain| in f32 (the two sum K terms in different orders)."""
    from repro_torch.kernels import grouped_matmul as gm
    worst = 0.0

    def check(what, a, b, valid=None, tol=1e-5):
        got = gm.grouped_matmul(a, b, valid)
        want = gm.grouped_matmul_plain(a, b, valid)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"grouped_matmul {what}: {got.dtype}"
                                 f"{tuple(got.shape)} != {want.dtype}"
                                 f"{tuple(want.shape)}")
        err, rel = _gm_rel(torch, got, want)
        log(f"[parity] grouped_matmul {what} max|err|={err:.3e} "
            f"rel={rel:.3e} tol={tol:.0e}")
        if not rel <= tol:
            raise AssertionError(f"grouped_matmul {what}: rel {rel} > {tol}")
        return err, got

    for G in (4, 8):
        for layer, (M, K, N) in FC_SHAPES.items():
            x = _rand(torch, rng, (G, M, K), dev)
            w = _rand(torch, rng, (G, K, N), dev)
            g = _rand(torch, rng, (G, M, N), dev)
            for what, a, b in (("fwd", x, w), ("dW", x.transpose(1, 2), g),
                               ("dx", g, w.transpose(1, 2))):
                err, _ = check(f"{layer} {what} G={G} {tuple(a.shape)}@"
                               f"{tuple(b.shape)}", a, b)
                worst = max(worst, err)
    for layer, (M, K, N) in CONV_WGRAD_SHAPES.items():
        S, depth = gm.split_k(M, N, K)
        err, _ = check(f"{layer} wgrad G=4 ({M}, {K})@({K}, {N}) split "
                       f"{S}x{depth}", _rand(torch, rng, (4, M, K), dev),
                       _rand(torch, rng, (4, K, N), dev))
        worst = max(worst, err)
    for G, M, K, N in GM_EDGE_SHAPES + ((3, 40, 5000, 72),):
        S, depth = gm.split_k(M, N, K)
        check(f"edge G={G} M={M} K={K} N={N} split {S}x{depth}",
              _rand(torch, rng, (G, M, K), dev), _rand(torch, rng, (G, K, N), dev))
    M, K, N = FC_SHAPES["fc0"]
    x, w = _rand(torch, rng, (4, M, K), dev), _rand(torch, rng, (4, K, N), dev)
    a, b = gm.grouped_matmul(x, w), gm.grouped_matmul(x, w)
    if not torch.equal(a, b):
        raise AssertionError("grouped_matmul is not bit-identical across runs")
    log("[parity] grouped_matmul fc0 G=4 repeated runs bit-identical")
    xs, ws = x[:3, :, :512], w[:3, :512, :]
    check("bf16 x f32 -> f32", xs.bfloat16(), ws)
    check("f32 x bf16 -> f32", xs, ws.bfloat16())
    # bf16 output: one rounding to bf16 (8 bits) after the f32 sum
    check("bf16 x bf16 -> bf16", xs.bfloat16(), ws.bfloat16(), tol=8e-3)
    x[3] = float("inf")                      # garbage in a masked group
    valid = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
    S = gm.split_k(M, N, K)[0]
    _, got = check(f"valid=[1,0,1,0] fc0 G=4 split {S}", x, w, valid)
    if not (bool((got[1] == 0).all()) and bool((got[3] == 0).all())):
        raise AssertionError("grouped_matmul: valid == 0 groups not exactly 0")
    if not torch.equal(got, gm.grouped_matmul(x, w, valid)):
        raise AssertionError("grouped_matmul masked split-K is not "
                             "bit-identical across runs")
    log(f"[parity] grouped_matmul valid == 0 groups exactly zero through "
        f"the {S}-way split's second pass; repeated runs bit-identical")
    return worst


def _parity_flash(torch, dev, rng) -> tuple:
    """flash_attention vs its plain version (materialised f32 softmax) at
    the serve prefill shapes (``FA_SERVE_SHAPES``: phi4-mini-3.8b,
    codeqwen1.5-7b, minitron-8b, qwen2-moe-a2.7b) and the edge shapes, f32 and bf16, and
    bit-identical repeated runs at the serve shapes. Tolerances: f32 max|err| <= 2e-5 *
    max(1, max|plain|) (online vs materialised softmax, rounding only);
    bf16 elementwise within the kernel module's ``bf16_limit`` (p rounded
    to bf16 before PV, then one output rounding; derived there).
    Returns the worst f32 and bf16 max|err| and the worst bf16 element's
    share of its limit."""
    from repro_torch.kernels import flash_attention as fa
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share = 0.0
    for B, Sq, Sk, H, Hkv, hd, causal in FA_SERVE_SHAPES + FA_EDGE_SHAPES:
        q = _rand(torch, rng, (B, Sq, H, hd), dev)
        k = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        v = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        for dt in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            got = fa.flash_attention(a, b, c, causal=causal)
            want = fa.flash_attention_plain(a, b, c, causal=causal)
            torch.cuda.synchronize()
            if got.dtype != dt or got.shape != want.shape:
                raise AssertionError(f"flash_attention {dt}: {got.dtype}"
                                     f"{tuple(got.shape)}")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dt == torch.float32:
                tol = 2e-5 * max(1.0, float(want.float().abs().max()))
                share = err / tol
                what = f"tol={tol:.3e}"
            else:
                share = float((diff / fa.bf16_limit(want, c)).max())
                old = float((diff / _bf16_limit_2m9(torch, want, c)).max())
                worst_share = max(worst_share, share)
                what = (f"limit {fa.BF16_LIMIT}, worst element at "
                        f"{share:.3f} of it, {old:.3f} of it with 2^-9 for "
                        f"p's rounding")
            log(f"[parity] flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                f"Hkv={Hkv} hd={hd} causal={causal} {str(dt)[6:]} "
                f"max|err|={err:.3e} {what}")
            if not share <= 1.0:
                raise AssertionError(f"flash_attention {(B, Sq, Sk, H, Hkv, hd)}"
                                     f" {dt}: max|err| {err}, {share} of limit")
            del diff
            worst[dt] = max(worst[dt], err)
            if (B, Sq, Sk, H, Hkv, hd, causal) in FA_SERVE_SHAPES:
                if not torch.equal(got, fa.flash_attention(a, b, c,
                                                           causal=causal)):
                    raise AssertionError("flash_attention is not bit-identical"
                                         " across runs")
                log(f"[parity] flash_attention serve shape H={H} Hkv={Hkv} "
                    f"{str(dt)[6:]} repeated runs bit-identical")
            del got, want
    return worst[torch.float32], worst[torch.bfloat16], worst_share


def _plain_by_kv(torch, fa, q, k, v, causal: bool, window):
    """flash_attention_plain one kv head (with its group of query heads) at
    a time, concatenated: the same function, with one group's scores alive
    at once (the long-context shape's would take 26 GB at once)."""
    G = q.shape[2] // k.shape[2]
    return torch.cat([fa.flash_attention_plain(
        q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
        causal=causal, window=window) for h in range(k.shape[2])], dim=2)


def _bf16_limit_2m9(torch, plain, v):
    """``bf16_limit`` as first stated, charging p's rounding to bf16 at
    2^-9 max|v|, where bf16's 8 significant bits give 2^-8 (printed beside
    the restated limit)."""
    vmax = v.float().abs().amax(dim=(1, 3))
    vmax = torch.repeat_interleave(vmax, plain.shape[2] // v.shape[2], dim=1)
    return (2.0 ** -7 * plain.float().abs()
            + 2.0 ** -9 * vmax[:, None, :, None] + 1e-4)


def _parity_flash_window(torch, dev, rng) -> dict:
    """The windowed forward kernels against the plain version (computed one
    kv head at a time) at ``FA_WINDOW_SHAPES``, f32 (CUDA-core kernel, 2e-5
    x max(1, max|plain|)) and bf16 (tensor-core kernel, ``bf16_limit``; each
    case's worst share printed under the restated limit and under the 2^-9
    one); repeated runs bit-equal; a window of at least Sk bit-equal to no
    window, also at the serve shape. Returns the worst errors and shares."""
    from repro_torch.kernels import flash_attention as fa
    out = {"f32": 0.0, "bf16": 0.0, "bf16_share": 0.0, "bf16_share_2m9": 0.0}
    for B, Sq, Sk, H, Hkv, hd, causal, W in FA_WINDOW_SHAPES:
        q = _rand(torch, rng, (B, Sq, H, hd), dev)
        k = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        v = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        empty = fa.has_empty_rows(Sq, Sk, W)
        for dt in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            got = fa.flash_attention(a, b, c, causal=causal, window=W)
            again = fa.flash_attention(a, b, c, causal=causal, window=W)
            want = _plain_by_kv(torch, fa, a, b, c, causal, W)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            what = (f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} "
                    f"causal={causal} window={W} {str(dt)[6:]}"
                    + (" (rows from Sk + window - 1 see no key)" if empty
                       else ""))
            if dt == torch.float32:
                tol = 2e-5 * max(1.0, float(want.float().abs().max()))
                share = err / tol
                note = f"tol={tol:.3e} ({share:.3f} of it)"
                out["f32"] = max(out["f32"], err)
            else:
                share = float((diff / fa.bf16_limit(want, c)).max())
                old = float((diff / _bf16_limit_2m9(torch, want, c)).max())
                note = (f"worst element at {share:.3f} of bf16_limit "
                        f"({fa.BF16_LIMIT}), {old:.3f} of it with 2^-9 for "
                        f"p's rounding")
                out["bf16"] = max(out["bf16"], err)
                out["bf16_share"] = max(out["bf16_share"], share)
                out["bf16_share_2m9"] = max(out["bf16_share_2m9"], old)
            log(f"[parity] flash_attention window {what}: max|err|={err:.3e} "
                f"{note}; repeat bit-equal {same}")
            if not (share <= 1.0 and same and got.dtype == dt
                    and got.shape == want.shape):
                raise AssertionError(f"flash_attention window {what}: "
                                     f"max|err| {err}, {share} of its limit, "
                                     f"repeat bit-equal {same}")
            del got, again, want, diff
    # a window of at least Sk masks nothing: the same bits as no window
    for B, Sq, Sk, H, Hkv, hd, causal in (FA_SERVE, FA_EDGE_SHAPES[5],
                                          FA_EDGE_SHAPES[4]):
        q = _rand(torch, rng, (B, Sq, H, hd), dev)
        k = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        v = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        for dt in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            free = fa.flash_attention(a, b, c, causal=causal)
            for W in (max(Sq, Sk), 10 ** 9):
                if not torch.equal(free, fa.flash_attention(
                        a, b, c, causal=causal, window=W)):
                    raise AssertionError(
                        f"flash_attention {(B, Sq, Sk, H, Hkv, hd, causal)} "
                        f"{dt}: window {W} >= Sk differs from no window")
        log(f"[parity] flash_attention B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} "
            f"hd={hd} causal={causal}: window max(Sq, Sk) and 1e9 bit-equal "
            f"to no window, f32 and bf16")
    return out


# cycles the card spins (torch.cuda._sleep) before a launch timed with
# hide_host: about 150 us at 1.98 GHz, more than a wrapper's host time, so
# the launch is queued before the start event is reached
HIDE_HOST_CYCLES = 300_000


def _time_ms(torch, fn, iters: int, flush, hide_host: bool = False) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    its own CUDA events after an L2 flush (flush time excluded). When the
    host takes longer to queue ``fn`` than the flush takes to run, the
    card waits between the events; ``hide_host`` spins the card after the
    flush so that the events hold the kernels alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def phase_timing(torch, dev):
    from repro_torch.kernels import buffer_agg as ba
    rng = np.random.default_rng(1)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    out = {}

    L, d = 5, CIFAR_D
    w = torch.softmax(_rand(torch, rng, (L,), dev), 0)
    g, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
    bytes_ = (L + 2) * d * 4
    b_ms, f_ms = bytes_ / HBM_BYTES_PER_S * 1e3, 2 * L * d / FP32_FLOPS_PER_S * 1e3
    out["buffer_agg"] = dict(
        shape=f"L={L} d={d}",
        ms=_time_ms(torch, lambda: ba.buffer_agg(w, g, u), 200, flush),
        plain_ms=_time_ms(torch, lambda: ba.buffer_agg_plain(w, g, u), 200, flush),
        library_ms=_time_ms(torch, lambda: torch.addmv(g, u.t(), w), 200, flush),
        bound_ms=max(b_ms, f_ms), bound_by="bytes" if b_ms >= f_ms else "operations")

    out["sens_sketch"] = _time_sketch(torch, dev, rng, flush)
    from repro_torch.kernels import grouped_matmul as gm
    G, (M, K, N) = 4, FC_SHAPES["fc0"]
    x, w = _rand(torch, rng, (G, M, K), dev), _rand(torch, rng, (G, K, N), dev)
    gr = _rand(torch, rng, (G, M, N), dev)
    # the convolutions' weight gradients, laid out as MemberConv2d passes
    # them: gy (G, C_out, n*H*W) and the input's windows (G, n*H*W, ckk)
    conv = {f"{c} wgrad": (_rand(torch, rng, (G, m, k), dev),
                           _rand(torch, rng, (G, k, n), dev))
            for c, (m, k, n) in CONV_WGRAD_SHAPES.items()}
    for what, a, b in (("fwd", x, w), ("dW", x.transpose(1, 2), gr),
                       ("dx", gr, w.transpose(1, 2)),
                       *((c, *ab) for c, ab in conv.items())):
        g_, m_, k_ = a.shape
        n_ = b.shape[2]
        b_ms = 4 * g_ * (m_ * k_ + k_ * n_ + m_ * n_) / HBM_BYTES_PER_S * 1e3
        f_ms = 2 * g_ * m_ * k_ * n_ / FP32_FLOPS_PER_S * 1e3
        key = ("grouped_matmul" if what == "fwd" else
               f"grouped_matmul_{what.replace(' ', '_')}")
        S, depth = gm.split_k(m_, n_, k_)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # pass-1 instantiation: <lhs k-contiguous, rhs k-contiguous, out>
        inst = (f"grouped_matmul_kernelILb{int(a.stride(2) == 1)}"
                f"ELb{int(b.stride(1) == 1 and b.stride(2) != 1)}EfE")
        out[key] = dict(
            shape=(f"{'' if 'wgrad' in what else 'fc0 '}{what} G={g_} "
                   f"({m_}x{k_})@({k_}x{n_})"),
            ms=_time_ms(torch, lambda: gm.grouped_matmul(a, b), 200, flush),
            plain_ms=_time_ms(torch, lambda: gm.grouped_matmul_plain(a, b),
                              200, flush),
            library_ms=_time_ms(torch, lambda: torch.bmm(a, b), 200, flush),
            bound_ms=max(b_ms, f_ms),
            bound_by="bytes" if b_ms >= f_ms else "operations",
            design=(f"split {S} x {depth} deep, "
                    f"{gm.pass1_blocks(g_, m_, n_, k_)} blocks for {sms} "
                    f"SMs{', + pass 2' if S > 1 else ''}; "
                    f"{_ptxas('grouped_matmul', inst)}"))
    del x, w, gr, conv
    out["grouped_matmul"]["cases"] = [
        dict(r) for k, r in out.items() if k.startswith("grouped_matmul_")]
    out["flash_attention"] = _time_flash(torch, dev, rng, flush)
    out["flash_attention_window"] = _time_flash_window(torch, dev, rng, flush)
    rows = [(name, r) for name, r in out.items()] + \
        [("sens_sketch", c) for c in out["sens_sketch"]["cases"]]
    for name, r in rows:
        lib = r.get("library_note", "none") if r["library_ms"] is None else (
            f"{r['library_ms'] * 1e3:.1f}us (kernel at "
            f"{r['ms'] / r['library_ms']:.2f}x its time)")
        plain = "-" if r["plain_ms"] is None else f"{r['plain_ms'] * 1e3:.1f}us"
        dev_t = ("" if "device_ms" not in r else
                 f" ({r['device_ms'] * 1e3:.1f}us with the host's queueing "
                 f"hidden, {100 * r['bound_ms'] / r['device_ms']:.2f}% of the "
                 f"bound; host {r['host_us']:.1f}us a call)")
        log(f"[timing] {name} {r['shape']}: kernel {r['ms'] * 1e3:.1f}us{dev_t} "
            f"plain {plain} library {lib} "
            f"bound {r['bound_ms'] * 1e3:.1f}us ({r['bound_by']}; kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of it)"
            + (f"; {r['design']}" if "design" in r else ""))
    return out


def _sketch_bound(n: int, k: int, members: int = 1) -> tuple:
    """(bound ms, by what) of sketches of n elements in all: the larger of
    12 bytes an element (and 4k a member's output) over HBM and
    SKETCH_INT_OPS_PER_ELEM_ROW x k INT32 operations an element over the
    INT32 pipe."""
    b_ms = (12 * n + 4 * k * members) / HBM_BYTES_PER_S * 1e3
    o_ms = SKETCH_INT_OPS_PER_ELEM_ROW * k * n / INT32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def _host_us(torch, fn, n: int = 200) -> float:
    """Host microseconds ``fn`` takes to queue its work (no sync inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _time_sketch(torch, dev, rng, flush) -> dict:
    """sens_sketch at fc0.w (d = 1,572,864, k = 16, the one-vector entry;
    the row earlier designs were timed on), and in ``cases``: the whole
    CIFAR tree in one call, the same tree as 10 one-leaf calls, and a wave
    of 8 members in one call; each also with the host's queueing hidden (``device_ms``)
    and the host's time a call (``host_us``). No single PyTorch call
    hashes the signs, so there is no library yardstick. Then the probe:
    the tree and the wave with the loads replaced by values made from the
    index (the hashing alone), the SM clock read by the blocks during the
    run, the blocks' span on the device's global timer, and the tree under
    other grids."""
    from repro_torch.core.sketch import leaf_seed_host
    from repro_torch.kernels import sens_sketch as ss
    k, cifar = 16, _cifar_spec(torch)
    n = 1_572_864                 # the main path's largest leaf, fc0.w
    t, g, f = (x[0] for x in _sketch_rows(torch, rng, dev, 1, n))
    bound, by = _sketch_bound(n, k)
    none = "none (no single PyTorch call hashes the signs)"
    one = lambda: ss.sens_sketch(t, g, f, k=k, seed=3)  # noqa: E731
    r = dict(shape=f"d={n} k={k}", library_ms=None, library_note=none,
             bound_ms=bound, bound_by=by, ms=_time_ms(torch, one, 200, flush),
             device_ms=_time_ms(torch, one, 200, flush, hide_host=True),
             host_us=_host_us(torch, one),
             plain_ms=_time_ms(torch, lambda: ss.sens_sketch_plain(
                 t, g, f, k=k, seed=3), 20, flush))
    table = ss.layout_table(cifar.sizes, 42, k, str(dev))
    ntiles = table.tiles.shape[0]
    cases, waves = [], {}
    for B in (1, 8):
        waves[B] = _sketch_rows(torch, rng, dev, B, cifar.size)
    t1, g1, f1 = (x[0] for x in waves[1])
    leaves = [(o, m, leaf_seed_host(42, i)) for i, (o, m) in
              enumerate(zip(cifar.offsets, cifar.sizes))]

    def per_leaf():
        return sum(ss.sens_sketch(t1[o:o + m], g1[o:o + m], f1[o:o + m], k=k,
                                  seed=sd) for o, m, sd in leaves)

    for what, B, fn, plain in (
            ("CIFAR tree, one call", 1,
             lambda: ss.sens_sketch_rows(*waves[1], table),
             lambda: ss.sens_sketch_rows_plain(*waves[1], table)),
            ("CIFAR tree, 10 one-leaf calls", 1, per_leaf, None),
            ("CIFAR wave of B=8, one call", 8,
             lambda: ss.sens_sketch_rows(*waves[8], table),
             lambda: ss.sens_sketch_rows_plain(*waves[8], table))):
        bound, by = _sketch_bound(B * cifar.size, k, B)
        grid, sms, per = ss.grid_of(k, B * ntiles)
        cases.append(dict(
            shape=f"{what} (d={cifar.size} k={k})", bound_ms=bound,
            bound_by=by, library_ms=None, library_note=none,
            ms=_time_ms(torch, fn, 200, flush),
            device_ms=_time_ms(torch, fn, 200, flush, hide_host=True),
            host_us=_host_us(torch, fn),
            plain_ms=None if plain is None else _time_ms(torch, plain, 10,
                                                          flush),
            design=(f"{B * ntiles} items of up to {ss.TILE} elements on "
                    f"{grid} blocks for {sms} SMs ({per} resident an SM)")))
    r["cases"] = cases

    probe = []
    for B in (1, 8):
        items = B * ntiles
        grid, sms, per = ss.grid_of(k, items)
        grids = [grid] + (sorted({sms, 2 * sms, sms * per} - {grid})
                          if B == 1 else [])
        for gr in grids:
            for loads in (True, False) if gr == grid else (True,):
                ms = _time_ms(torch, lambda: ss.probe(*waves[B], table, grid=gr,
                                                      loads=loads), 100, flush,
                              hide_host=True)
                _, clocks = ss.probe(*waves[B], table, grid=gr, loads=loads)
                c = clocks.cpu().numpy().astype(np.float64)
                probe.append(dict(B=B, grid=gr, loads=loads, ms=ms,
                                  span_ms=(c[:, 3].max() - c[:, 2].min()) / 1e6,
                                  sm_ghz=ss.sm_clock_ghz(clocks)))
    for p in probe:
        bound, _ = _sketch_bound(p["B"] * cifar.size, k, p["B"])
        log(f"[probe] sens_sketch CIFAR B={p['B']} grid={p['grid']} "
            f"{'loads' if p['loads'] else 'no loads (s from the index)'}: "
            f"{p['ms'] * 1e3:.1f}us between events (host hidden), blocks' span "
            f"{p['span_ms'] * 1e3:.1f}us ({100 * bound / p['span_ms']:.1f}% "
            f"of the operation bound), SM clock {p['sm_ghz']:.3f} GHz")
    r["probe"] = probe
    r["design"] = (f"one launch; tiles of up to {ss.TILE} elements; "
                   f"{_ptxas('sens_sketch', 'sens_sketch_tilesILi16ELi0E')}")
    del waves
    return r


def _ptxas(lib: str, needle: str) -> str:
    """Registers, static shared memory and spills that ptxas reported for
    the kernel instantiation of ``lib`` whose mangled name holds
    ``needle``."""
    from repro_torch.kernels import _build
    found, info = False, []
    for line in _build.REPORT[lib]["log"].splitlines():
        if "Compiling entry function" in line:
            if found:
                break
            found = needle in line
        elif found and ("registers" in line or "spill" in line):
            info.append(line.split(":", 1)[-1].strip())
    return "ptxas: " + "; ".join(info) if info else f"ptxas: {needle} not found"


def _causal_pairs(Sq: int, Sk: int) -> int:
    """Unmasked (query, key) pairs of top-left causal attention."""
    return sum(min(i + 1, Sk) for i in range(Sq))


def _band_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs inside the band: j <= i under ``causal``, j > i -
    window with a window (``_causal_pairs`` when causal with no window)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _sdpa_or_none(torch, fn, iters: int, flush):
    """``_time_ms`` of a library yardstick, or (None, why) when PyTorch has
    no kernel for it or runs out of memory (it is never on the port's
    path)."""
    try:
        return _time_ms(torch, fn, iters, flush), None
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        torch.cuda.empty_cache()
        return None, str(e).splitlines()[0][:160]


def _time_flash_window(torch, dev, rng, flush) -> dict:
    """The windowed forward at the long-context shape ``FA_WINDOW`` in bf16
    (the tensor-core kernel): kernel, the unwindowed causal kernel on the
    same inputs, the plain version (one kv head at a time), and
    F.scaled_dot_product_attention with the band as a boolean mask (k and v
    repeated to the query heads, so that its memory-efficient kernel can
    take the mask; a yardstick the port never calls). Bound: the band's
    pairs x 4 hd FLOP at the bf16 tensor-core peak, or q, k, v, o moved
    once; the unwindowed kernel's beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, Hkv, hd, causal, W = FA_WINDOW
    dt = torch.bfloat16
    q = _rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
    k = _rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
    v = _rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
    pairs = _band_pairs(Sq, Sk, causal, W)
    full_pairs = _band_pairs(Sq, Sk, causal, None)
    bytes_ = 2 * (q.numel() * 2 + k.numel() + v.numel())
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = B * H * pairs * 4 * hd / BF16_TC_FLOPS_PER_S * 1e3
    full_o_ms = B * H * full_pairs * 4 * hd / BF16_TC_FLOPS_PER_S * 1e3
    G = H // Hkv
    qt = q.transpose(1, 2)
    kt, vt = (torch.repeat_interleave(x, G, dim=2).transpose(1, 2)
              for x in (k, v))
    mask = fa.band_mask(Sq, Sk, causal, W, dev)
    lib_ms, why = _sdpa_or_none(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 10, flush)
    r = dict(
        shape=f"B={B} S={Sq} H={H} Hkv={Hkv} hd={hd} causal window={W} bf16",
        ms=_time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal,
                                                      window=W), 20, flush),
        unwindowed_ms=_time_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal), 20, flush),
        plain_ms=_time_ms(torch, lambda: _plain_by_kv(torch, fa, q, k, v,
                                                      causal, W), 3, flush),
        library_ms=lib_ms,
        library_note=(f"SDPA with the band's boolean mask: {why}" if why
                      else "SDPA with the band's boolean mask"),
        bound_ms=max(o_ms, b_ms),
        bound_by="operations" if o_ms >= b_ms else "bytes",
        unwindowed_bound_ms=max(full_o_ms, b_ms), pairs=B * H * pairs,
        unwindowed_pairs=B * H * full_pairs, pair_ratio=pairs / full_pairs)
    r["time_ratio"] = r["ms"] / r["unwindowed_ms"]
    log(f"[timing] flash_attention window: {pairs / 1e6:.2f} M band pairs a "
        f"(b, h) against {full_pairs / 1e6:.2f} M unwindowed (ratio "
        f"{r['pair_ratio']:.4f}); windowed {r['ms'] * 1e3:.1f}us, unwindowed "
        f"causal {r['unwindowed_ms'] * 1e3:.1f}us (time ratio "
        f"{r['time_ratio']:.4f}); bounds {r['bound_ms'] * 1e3:.1f}us and "
        f"{r['unwindowed_bound_ms'] * 1e3:.1f}us at the bf16 tensor-core "
        f"peak ({100 * r['bound_ms'] / r['ms']:.2f}% and "
        f"{100 * r['unwindowed_bound_ms'] / r['unwindowed_ms']:.2f}% of "
        f"them); {r['library_note']}"
        + ("" if lib_ms is None else f" {lib_ms * 1e3:.1f}us"))
    del q, k, v, qt, kt, vt, mask
    return r


def _time_flash(torch, dev, rng, flush) -> dict:
    """flash_attention at the serve shape in bf16 (the serve path's dtype,
    so the tensor-core kernel): kernel, plain version, and
    F.scaled_dot_product_attention (causal, GQA; a yardstick the port never
    calls) on the same inputs. Bound: the larger of the unmasked pairs x 4
    hd FLOP at the bf16 tensor-core peak and q, k, v, o moved once."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, Hkv, hd, causal = FA_SERVE
    dt = torch.bfloat16
    q = _rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
    k = _rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
    v = _rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
    flops = B * H * _causal_pairs(Sq, Sk) * 4 * hd
    bytes_ = 2 * (q.numel() * 2 + k.numel() + v.numel())
    o_ms = flops / BF16_TC_FLOPS_PER_S * 1e3
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    r = dict(
        shape=f"B={B} S={Sq} H={H} Hkv={Hkv} hd={hd} causal bf16",
        ms=_time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal),
                    20, flush),
        plain_ms=_time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), 10, flush),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush),
        bound_ms=max(o_ms, b_ms), bound_by="operations" if o_ms >= b_ms else "bytes",
        flops=flops, bytes=bytes_)
    # read from the runtime after the launches above set the attribute
    at = fa.tc_attributes(hd)
    r["design"] = (f"{at['max_dynamic_smem_bytes']} bytes dynamic smem, "
                   f"{at['registers']} registers, {at['local_bytes']} bytes "
                   f"local a thread (cudaFuncGetAttributes); "
                   f"{_ptxas('flash_attention', 'flash_attention_tcILi128E')}")
    log(f"[timing] flash_attention: {flops:.4e} FLOP (unmasked pairs x 4 hd), "
        f"{bytes_ / 1e6:.1f} MB; bound {o_ms * 1e3:.1f}us at the bf16 "
        f"tensor-core peak, {b_ms * 1e3:.1f}us by bytes")
    return r


def _golden_world():
    from repro_torch.configs import get_config
    from repro_torch.convert import load_npz_params
    from repro_torch.data import (ClientDataset, dirichlet_partition,
                                  make_calibration_batch, make_classification,
                                  train_test_split)
    W = GOLDEN_WORLD
    cfg = get_config(W["model"])
    full = make_classification(W["samples"], W["classes"], W["dim"],
                               seed=W["seed"], class_sep=0.7)
    train, test = train_test_split(full, 0.1)
    parts = dirichlet_partition(train, W["clients"], alpha=W["alpha"],
                                seed=W["seed"])
    clients = [ClientDataset(train.subset(ix)) for ix in parts]
    calib = make_calibration_batch(train, 64, "gaussian")
    params = load_npz_params(os.path.join(
        ROOT, "tests", "torch_fixtures", "paper_synthetic_mlp_init_seed0.npz"))
    return cfg, clients, test, calib, params


POLICIES = ("fedpsa", "fedbuff", "fedasync", "ca2fl", "fedfa", "fedpac",
            "asyncfeded")
ENGINE_SETTINGS = (("sequential", "vmap"), ("cohort", "vmap"),
                   ("cohort", "grouped"))


def _want_launches(name: str, metric: str, res) -> dict:
    """Exact launch counts of one policy run (``grouped_matmul`` apart):
    ``buffer_agg`` once per buffered apply (every receive under fedfa),
    ``sens_sketch`` once per sketched tree or wave, per FedPSA aggregation
    and for the initial global model, or once per asyncfeded receive
    under ``metric="sketch"`` (dw and the drift in one launch)."""
    receives = res.dispatches
    agg = {"fedbuff": res.versions, "fedpac": res.versions,
           "ca2fl": res.versions, "fedpsa": res.versions, "fedfa": receives}
    sketch = 0
    if name == "fedpsa":
        sketch = (res.cohorts if res.engine == "cohort" else receives) \
            + res.versions + 1
    elif name == "asyncfeded" and metric == "sketch":
        sketch = receives
    return {"buffer_agg": agg.get(name, 0), "sens_sketch": sketch,
            "flash_attention": 0, "flash_attention_bwd": 0}


def _check_launches(what: str, counts: dict, want: dict, grouped: bool):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    if (counts["grouped_matmul"] > 0) != grouped:
        raise AssertionError(f"{what}: grouped_matmul launched "
                             f"{counts['grouped_matmul']} times")


def phase_golden(torch):
    """Every async policy on the golden world, on the sequential engine and
    on the cohort engine with both member kernels: the committed goldens
    (``tests/golden/<policy>.json``), and asyncfeded's cosine and sketch
    metrics against the reference's digest streams committed under
    ``tests/torch_fixtures/`` (with their per-receive coefficients).
    Returns each (policy, metric)'s cohort/grouped run and its golden, the
    references of ``[mesh]``."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _golden_world()
    cases = [(n, "l2", os.path.join("golden", f"{n}.json")) for n in POLICIES]
    cases += [("asyncfeded", m, os.path.join(
        "torch_fixtures", f"asyncfeded_{m}_digests.json"))
        for m in ("cosine", "sketch")]
    refs = {}
    for name, metric, path in cases:
        with open(os.path.join(ROOT, "tests", path)) as fh:
            golden = json.load(fh)
        kw = {}
        if name == "fedpsa":
            kw = dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
        if metric != "l2":
            kw["server_kwargs"] = {"metric": metric}
        for engine, mk in ENGINE_SETTINGS:
            what = f"golden {name}/{metric} {engine}/{mk}"
            sim = SimConfig(engine=engine, member_kernel=mk, device="cuda",
                            record_trajectory=True, **GOLDEN_SIM)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_algorithm(name, cfg, params, clients, test, sim, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            got, want = np.asarray(res.digests), np.asarray(golden["digests"])
            if got.shape != want.shape:
                raise AssertionError(f"{what}: {got.shape} != {want.shape}")
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            for key in ("versions", "dispatches", "dropped", "launched"):
                if getattr(res, key) != golden["final"][key]:
                    raise AssertionError(f"{what}: {key} {getattr(res, key)} "
                                         f"!= {golden['final'][key]}")
            np.testing.assert_allclose(res.final_accuracy,
                                       golden["final"]["final_accuracy"],
                                       atol=2e-3)
            np.testing.assert_allclose(res.aulc, golden["final"]["aulc"],
                                       atol=2e-3)
            if "weights" in golden:
                np.testing.assert_allclose(
                    [e["weight"] for e in res.server_log], golden["weights"],
                    rtol=1e-4)
            if res.engine != engine:
                raise AssertionError(f"{what}: ran {res.engine}")
            _check_launches(what, counts, _want_launches(name, metric, res),
                            mk == "grouped")
            rel = float(np.max(np.abs(got - want)
                               / (np.abs(want) + ATOL / RTOL)))
            log(f"[golden] {name}/{metric} {engine}/{mk}: {len(got)} digests "
                f"match (max rel {rel:.2e}), cohorts={res.cohorts} "
                f"versions={res.versions} dispatches={res.dispatches} "
                f"final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
                f"launches={counts}")
            if (engine, mk) == ("cohort", "grouped"):
                refs[name, metric] = {
                    **_run_ref(res, counts, wall),
                    "file_digests": golden["digests"],
                    "file_final": {k: golden["final"][k] for k in (
                        "versions", "dispatches", "dropped", "launched")},
                    **({"weights": golden["weights"]}
                       if "weights" in golden else {})}
    return refs


def _run_ref(res, counts: dict, wall: float) -> dict:
    """A single-device run as ``[mesh]`` holds a mesh run to it."""
    return {"digests": res.digests, "accuracies": res.accuracies,
            "counts": counts, "s_per_receive": wall / res.dispatches,
            **{k: getattr(res, k) for k in (
                "versions", "dispatches", "dropped", "launched")}}


# tests/test_golden.py's sweep lanes: one timeline-preserving override per
# policy, on lane 1 of [0, 0, 1234]
SWEEP_HYPER = {
    "fedasync": {"alpha": 0.3}, "fedbuff": {"server_lr": 0.7},
    "fedpsa": {"server_lr": 0.5}, "ca2fl": {"server_lr": 0.6},
    "fedfa": {"beta": 0.8}, "fedpac": {"server_lr": 0.8},
    "asyncfeded": {"alpha": 0.4},
}
SWEEP_SEEDS = [0, 0, 1234]
# phase 5b's sweeps take the member kernels and the standalone lanes in
# turn, policy by policy (POLICIES[i]: SWEEP_MEMBER_KERNELS[i % 2], lane
# 1 + i % 2), so both kernels and both reshuffled lanes run on the card
# at one sweep and one standalone run a policy (the CPU tests hold every
# lane under both)
SWEEP_MEMBER_KERNELS = ("grouped", "vmap")
# a lane against its standalone run (the reference's tests/test_sweep.py)
LANE_RTOL, LANE_ATOL = 1e-5, 1e-4


def _want_sweep_launches(name: str, metric: str, res) -> dict:
    """Exact launch counts of an S-lane sweep (``grouped_matmul`` apart):
    every lane applies on its own (``buffer_agg`` S x versions, S x
    receives under fedfa) and refreshes its own global sketch (FedPSA: S at
    init and S per aggregation), while a wave's S x B client sketches are
    one ``sens_sketch`` launch."""
    S, receives = res.num_lanes, res.dispatches
    agg = {"fedbuff": res.versions, "fedpac": res.versions,
           "ca2fl": res.versions, "fedpsa": res.versions, "fedfa": receives}
    sketch = 0
    if name == "fedpsa":
        sketch = res.cohorts + S * (res.versions + 1)
    elif name == "asyncfeded" and metric == "sketch":
        sketch = S * receives
    return {"buffer_agg": S * agg.get(name, 0), "sens_sketch": sketch,
            "flash_attention": 0, "flash_attention_bwd": 0}


def _lane_gap(got, want) -> float:
    """Worst digest gap as a share of the lane tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"digest streams {got.shape} != {want.shape}")
    return float(np.max(np.abs(got - want)
                        / (LANE_ATOL + LANE_RTOL * np.abs(want))))


def phase_sweeps_golden(torch):
    """Phase 5b: a 3-lane sweep of every policy on the golden world (data
    seeds [0, 0, 1234], hyperparameters [None, SWEEP_HYPER, None]), the
    policies taking ``SWEEP_MEMBER_KERNELS`` in turn: lane 0 holds the
    committed golden, lane 1 (even policies) or lane 2 (odd ones) the
    port's standalone run on the card under the same member kernel at the
    lane tolerance; launch counts exact (``grouped_matmul`` as the
    standalone cohort run's: the same waves and local steps)."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import (SimConfig, SweepConfig,
                                                 run_algorithm, run_sweep)
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _golden_world()
    for i, name in enumerate(POLICIES):
        with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as fh:
            golden = json.load(fh)
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        hypers = [None, SWEEP_HYPER[name], None]
        mk, lane = SWEEP_MEMBER_KERNELS[i % 2], 1 + i % 2
        what = f"sweep {name} cohort/{mk}"
        sim = SimConfig(engine="cohort", member_kernel=mk, device="cuda",
                        record_trajectory=True, **GOLDEN_SIM)
        ops.reset_launch_counts()
        res = run_sweep(name, cfg, params, clients, test, sim,
                        SweepConfig(data_seeds=SWEEP_SEEDS,
                                    policy_params=hypers), **kw)
        counts = ops.launch_counts()
        want = np.asarray(golden["digests"])
        got = np.asarray(res.digests[0])
        if got.shape != want.shape:
            raise AssertionError(f"{what}: {got.shape} != {want.shape}")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for key in ("versions", "dispatches", "dropped", "launched"):
            if getattr(res, key) != golden["final"][key]:
                raise AssertionError(f"{what}: {key} {getattr(res, key)}"
                                     f" != {golden['final'][key]}")
        np.testing.assert_allclose(res.final_accuracy[0],
                                   golden["final"]["final_accuracy"],
                                   atol=2e-3)
        _check_launches(what, counts, _want_sweep_launches(name, "l2", res),
                        mk == "grouped")
        lane_kw = dict(kw)
        if lane == 1 and name == "fedpsa":
            lane_kw["psa_cfg"] = PSAConfig(**GOLDEN_PSA, **SWEEP_HYPER[name])
        elif lane == 1:
            lane_kw["server_kwargs"] = dict(SWEEP_HYPER[name])
        ops.reset_launch_counts()
        solo = run_algorithm(
            name, cfg, params, clients, test,
            SimConfig(engine="cohort", member_kernel=mk, device="cuda",
                      record_trajectory=True,
                      **{**GOLDEN_SIM, "seed": SWEEP_SEEDS[lane],
                         "timeline_seed": GOLDEN_SIM["seed"]}),
            **lane_kw)
        solo_gm = ops.launch_counts()["grouped_matmul"]
        gap = _lane_gap(res.digests[lane], solo.digests)
        if gap > 1.0 or solo.receive_log != res.receive_log:
            raise AssertionError(f"{what}: lane {lane} at {gap} of the lane "
                                 f"tolerance")
        if counts["grouped_matmul"] != solo_gm:
            raise AssertionError(f"{what}: grouped_matmul "
                                 f"{counts['grouped_matmul']} != the "
                                 f"standalone run's {solo_gm}")
        rel = float(np.max(np.abs(got - want) / (np.abs(want) + ATOL / RTOL)))
        log(f"[sweep] {name} cohort/{mk} 3 lanes: lane 0 matches the golden "
            f"(max rel {rel:.2e}), lane {lane} vs standalone at {gap:.2e} of "
            f"the lane tolerance; cohorts={res.cohorts} "
            f"versions={res.versions} launches={counts}")


CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")


def _prune_to_mid_run(ckdir: str, total: int) -> int:
    """Keep the snapshots up to the middle one of those taken mid-run;
    returns its step (dispatches at the snapshot)."""
    import shutil
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
    mid = [s for s in steps if 0 < s < total]
    if not mid:
        raise AssertionError(f"no mid-run snapshot among {steps}")
    keep = mid[len(mid) // 2]
    for s in steps:
        if s > keep:
            shutil.rmtree(os.path.join(ckdir, f"step_{s:08d}"))
    return keep


def phase_resume_fedavg(torch):
    """Phase 5c on the golden world: fedbuff on both engines and fedpsa on
    the cohort engine checkpointed every 1,000 units (which must not
    change the run), pruned to a snapshot from the middle of the run and
    resumed: digests, ``receive_log``, times and counters equal the
    unbroken run's exactly (fedpsa's digests at rtol 1e-6, atol 1e-5);
    then ``run_fedavg`` on both engines against the reference's run
    committed in ``tests/torch_fixtures/fedavg_golden_world.json`` (the
    evaluated models' digests at ``RTOL``/``ATOL``), with no
    ``buffer_agg`` or ``sens_sketch`` launch."""
    import shutil
    from repro_torch.common.tree import FlatSpec
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _golden_world()
    for name, engine, mk in (("fedbuff", "sequential", "vmap"),
                             ("fedbuff", "cohort", "grouped"),
                             ("fedpsa", "cohort", "grouped")):
        what = f"resume {name} {engine}/{mk}"
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        base_sim = dict(engine=engine, member_kernel=mk, device="cuda",
                        record_trajectory=True, **GOLDEN_SIM)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        runs = []
        for ck in ({}, dict(checkpoint_dir=CKPT_DIR, checkpoint_every=1_000.0),
                   "resume"):
            if ck == "resume":
                step = _prune_to_mid_run(CKPT_DIR, runs[0].dispatches)
                ck = dict(checkpoint_dir=CKPT_DIR, checkpoint_every=1_000.0,
                          resume=True)
            runs.append(run_algorithm(name, cfg, params, clients, test,
                                      SimConfig(**base_sim, **ck), **kw))
        base, snapped, resumed = runs
        for r, who in ((snapped, "checkpointed run"), (resumed, "resumed run")):
            if name == "fedpsa":
                np.testing.assert_allclose(r.digests, base.digests, rtol=1e-6,
                                           atol=1e-5)
            elif r.digests != base.digests:
                raise AssertionError(f"{what}: the {who}'s digests differ")
            for key in ("dispatches", "launched", "dropped", "versions",
                        "cohorts", "times", "receive_log"):
                if getattr(r, key) != getattr(base, key):
                    raise AssertionError(f"{what}: the {who}'s {key} differs")
        gap = float(np.max(np.abs(np.asarray(resumed.digests)
                                  - np.asarray(base.digests))))
        log(f"[resume] {name} {engine}/{mk}: resumed from the snapshot at "
            f"{step} of {base.dispatches} receives; digests, receive_log, "
            f"times and counters equal the unbroken run's (max |digest "
            f"gap| {gap:.3e}); final {resumed.final_accuracy:.4f} vs "
            f"{base.final_accuracy:.4f}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    with open(os.path.join(ROOT, "tests", "torch_fixtures",
                           "fedavg_golden_world.json")) as fh:
        want = json.load(fh)
    # the digest of the model each evaluation sees: FedAvg's accuracies
    # alone move in steps of one test sample
    seen, build = [], simulator._build_eval

    def build_recording(*a, **kw):
        evaluate = build(*a, **kw)

        def recorded(p):
            w = FlatSpec(p).flatten(p).cpu().numpy()
            seen.append(simulator.make_digest_fn(w.size)(w[None])[0])
            return evaluate(p)

        return recorded

    for engine, mk in ENGINE_SETTINGS:
        what = f"fedavg {engine}/{mk}"
        seen.clear()
        ops.reset_launch_counts()
        simulator._build_eval = build_recording
        try:
            res = run_algorithm("fedavg", cfg, params, clients, test,
                                SimConfig(engine=engine, member_kernel=mk,
                                          device="cuda", **GOLDEN_SIM))
        finally:
            simulator._build_eval = build
        counts = ops.launch_counts()
        if len(seen) != len(want["digests"]):
            raise AssertionError(f"{what}: {len(seen)} evaluations")
        np.testing.assert_allclose(seen, want["digests"], rtol=RTOL,
                                   atol=ATOL)
        gap = float(np.max(np.abs(np.asarray(seen) - want["digests"])))
        if res.times != want["times"]:
            raise AssertionError(f"{what}: times {res.times}")
        for key in ("versions", "dispatches", "launched"):
            if getattr(res, key) != want[key]:
                raise AssertionError(f"{what}: {key} {getattr(res, key)} != "
                                     f"{want[key]}")
        np.testing.assert_allclose(res.accuracies, want["accuracies"],
                                   atol=2e-3)
        np.testing.assert_allclose(res.final_accuracy, want["final_accuracy"],
                                   atol=2e-3)
        _check_launches(what, counts, {"buffer_agg": 0, "sens_sketch": 0,
                                       "flash_attention": 0,
                                       "flash_attention_bwd": 0},
                        mk == "grouped")
        log(f"[fedavg] {engine}/{mk}: rounds={res.versions} dispatches="
            f"{res.dispatches} accuracies={res.accuracies} and the evaluated "
            f"models' digests (max |gap| {gap:.3e}) match the reference's "
            f"fixture; launches={counts}")


@functools.lru_cache(maxsize=1)
def _main_world(torch):
    """The full-width CIFAR world and its init, built once a process (the
    runs only read it)."""
    from repro_torch.launch.train import build_task
    from repro_torch.models.model import init_params
    cfg, clients, test, calib = build_task("paper-cifar10-cnn", 10_000,
                                           alpha=0.1, num_clients=50, seed=0)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    return cfg, clients, test, calib, params


# phases 6-7: the main path's window, cut from the paper's 86,400 virtual
# units to 2,000 (about 93 receives; 3,000 and 140 receives until [dryrun]
# joined the script) for the script's time limit
MAIN_SIM = dict(num_clients=50, concurrency=0.2, horizon=2_000,
                eval_every=2_000, seed=0, device="cuda")


def phase_main(torch):
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _main_world(torch)
    sim = SimConfig(engine="sequential", **MAIN_SIM)
    psa = PSAConfig()
    captured = {}

    def hook(server, w_client, delta, meta, t):
        captured["server"] = server

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_algorithm("fedpsa", cfg, params, clients, test, sim,
                        psa_cfg=psa, calib_batch=calib, receive_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # one sketch per receive, per aggregation (the global-model refresh)
    # and of the initial global model, each one launch for the whole tree
    want_sk = res.dispatches + res.versions + 1
    if counts["sens_sketch"] != want_sk or counts["buffer_agg"] != res.versions:
        raise AssertionError(f"main path launches {counts}: want sens_sketch="
                             f"{want_sk} buffer_agg={res.versions}")
    if res.versions < 1:
        raise AssertionError("main path never aggregated")
    flat = captured["server"].flat_params
    if flat.shape != (CIFAR_D,) or not bool(torch.isfinite(flat).all()):
        raise AssertionError("main path global model is not finite (d,)")
    if not (0.0 <= res.final_accuracy <= 1.0 and math.isfinite(res.aulc)):
        raise AssertionError(f"bad accuracy {res.final_accuracy} / {res.aulc}")
    log(f"[main] paper-cifar10-cnn fedpsa d={flat.shape[0]} receives="
        f"{res.dispatches} versions={res.versions} final={res.final_accuracy:.4f} "
        f"aulc={res.aulc:.4f} wall={wall:.2f}s "
        f"s/receive={wall / max(res.dispatches, 1):.4f} "
        f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB "
        f"launches={counts}")
    return counts


def phase_main_cohort(torch):
    """The sequential main path's run on the cohort engine with the grouped
    member kernel. The engine that ``_drain_cohort`` builds is captured to
    read its local-step counter: each step launches grouped_matmul 9 times
    on the CNN (3 dense forwards, 3 dW, 3 dx — fc0's input depends on the
    conv weights)."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _main_world(torch)
    sim = simulator.SimConfig(engine="cohort", member_kernel="grouped",
                              record_trajectory=True, **MAIN_SIM)
    engines = []
    make = simulator._make_cohort_engine

    def capture(*a, **kw):
        engines.append(make(*a, **kw))
        return engines[-1]

    simulator._make_cohort_engine = capture
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = simulator.run_algorithm("fedpsa", cfg, params, clients, test,
                                      sim, psa_cfg=PSAConfig(),
                                      calib_batch=calib)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        simulator._make_cohort_engine = make
    (engine,) = engines
    # sens_sketch: one launch per wave (all its members), per aggregation
    # and for the initial global model
    want = {"sens_sketch": res.cohorts + res.versions + 1,
            "buffer_agg": res.versions,
            "grouped_matmul": CNN_GM_PER_STEP * engine.steps_run,
            "flash_attention": 0, "flash_attention_bwd": 0}
    if counts != want:
        raise AssertionError(f"cohort main path launches {counts} != {want}")
    if res.versions < 1 or res.engine != "cohort" or res.cohorts < 1:
        raise AssertionError(f"cohort main path did not run: {res.engine} "
                             f"versions={res.versions} cohorts={res.cohorts}")
    dig = np.asarray(res.digests)
    if dig.shape != (res.dispatches, 2) or not np.isfinite(dig).all():
        raise AssertionError(f"cohort main path digests {dig.shape} not finite")
    if not (0.0 <= res.final_accuracy <= 1.0 and math.isfinite(res.aulc)):
        raise AssertionError(f"bad accuracy {res.final_accuracy} / {res.aulc}")
    log(f"[main-cohort] paper-cifar10-cnn fedpsa cohort/grouped d={CIFAR_D} "
        f"receives={res.dispatches} versions={res.versions} "
        f"cohorts={res.cohorts} members/wave={res.dispatches / res.cohorts:.2f} "
        f"local_steps={engine.steps_run} "
        f"steps/wave={engine.steps_run / res.cohorts:.1f} "
        f"final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
        f"wall={wall:.2f}s s/receive={wall / max(res.dispatches, 1):.4f} "
        f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB "
        f"launches={counts}")
    return counts


# phase 7b: the other policies at full width, over 1,200 units of the
# main world (cut from 2,000 and its 93 receives for the script's time
# limit; its about 55 receives still fill the thermometer's 50)
POLICY_RUNS = (("fedasync", "l2"), ("fedpac", "l2"), ("ca2fl", "l2"),
               ("fedfa", "l2"), ("asyncfeded", "l2"), ("asyncfeded", "sketch"))
POLICY_HORIZON = 1_200


def phase_policies(torch) -> dict:
    """Every policy other than FedPSA on ``paper-cifar10-cnn`` at full
    width, cohort engine with the grouped member kernel, horizon cut to
    ``POLICY_HORIZON``: exact launch counts, a finite (d,) global, accuracy
    in [0, 1]. Returns (each run's launch counts by path name, the
    single-device runs ``[mesh]`` holds its ``MESH_FULL`` runs to)."""
    from repro_torch.federated import servers, simulator
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _main_world(torch)
    sim = simulator.SimConfig(engine="cohort", member_kernel="grouped",
                              **{**MAIN_SIM, "horizon": POLICY_HORIZON})
    engines, made = [], []
    make_engine, make_server = simulator._make_cohort_engine, servers.make_server

    def capture_engine(*a, **kw):
        engines.append(make_engine(*a, **kw))
        return engines[-1]

    def capture_server(*a, **kw):
        made.append(make_server(*a, **kw))
        return made[-1]

    simulator._make_cohort_engine = capture_engine
    servers.make_server = capture_server
    by_path, refs = {}, {}
    try:
        for name, metric in POLICY_RUNS:
            what = name if name != "asyncfeded" else f"{name}-{metric}"
            gc.collect()   # the previous run's tensors in reference cycles
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            # a run [mesh] holds its mesh runs to records its trajectory
            res = simulator.run_algorithm(
                name, cfg, params, clients, test, dataclasses.replace(
                    sim, record_trajectory=(name, metric) in MESH_FULL),
                server_kwargs={"metric": metric} if name == "asyncfeded"
                else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            (engine,), (server,) = engines, made
            want = {**_want_launches(name, metric, res),
                    "grouped_matmul": CNN_GM_PER_STEP * engine.steps_run}
            if counts != want:
                raise AssertionError(f"policy {what}: launches {counts} != "
                                     f"{want}")
            if res.versions < 1 or res.engine != "cohort":
                raise AssertionError(f"policy {what}: {res.engine} "
                                     f"versions={res.versions}")
            flat = server.flat_params
            if flat.shape != (CIFAR_D,) or not bool(torch.isfinite(flat).all()):
                raise AssertionError(f"policy {what}: global is not a finite "
                                     f"(d,) vector")
            if not 0.0 <= res.final_accuracy <= 1.0:
                raise AssertionError(f"policy {what}: accuracy "
                                     f"{res.final_accuracy}")
            log(f"[policy] {what} paper-cifar10-cnn cohort/grouped "
                f"d={CIFAR_D} horizon={POLICY_HORIZON} "
                f"receives={res.dispatches} versions={res.versions} "
                f"cohorts={res.cohorts} final={res.final_accuracy:.4f} "
                f"wall={wall:.2f}s s/receive={wall / res.dispatches:.4f} "
                f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB "
                f"(live at start {live / 2**20:.1f}MiB) launches={counts}")
            by_path[f"cohort-{what}"] = counts
            if (name, metric) in MESH_FULL:
                refs[name, metric] = _run_ref(res, counts, wall)
            # the next run's peak holds none of this run's tensors
            engines.clear()
            made.clear()
            del engine, server, flat, res
    finally:
        simulator._make_cohort_engine = make_engine
        servers.make_server = make_server
    return by_path, refs


# phase 7c's sweep: data seeds and FedPSA temperature slopes of its 3 lanes
FULL_SWEEP_SEEDS = [0, 0, 1]
FULL_SWEEP_GAMMA = [5.0, 1.0, 5.0]


def _timed_run(torch, fn):
    """(result, wall s, memory text, launch counts) of ``fn()``, with the
    peak and the counts reset just before; the text holds the peak device
    memory and what was live at the start."""
    from repro_torch.kernels import ops
    gc.collect()   # the previous run's tensors in reference cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    mem = (f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB "
           f"(live at start {live / 2**20:.1f}MiB)")
    return res, time.perf_counter() - t0, mem, ops.launch_counts()


def _gap_profile(a, b) -> str:
    """Where two digest streams part: the first receive whose digest
    differs, the gap there relative to the digest, and the largest gap."""
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a - b).max(axis=1)
    nz = np.flatnonzero(diff)
    if not nz.size:
        return "bit-equal"
    i = int(nz[0])
    return (f"first differing receive {i} of {len(a)} (gap there "
            f"{diff[i] / np.abs(b[i]).max():.3e} of the digest), max |gap| "
            f"{diff.max():.3e} at receive {int(np.argmax(diff))}")


# the convolutions' float32 parity: max |got - float64| over the sum of the
# terms' magnitudes, element by element, in u = 2**-24 (8 float32 ulps)
CONV_GATE_U = 16


def _lane_op_gaps(torch) -> None:
    """The wave's ops at the CNN's shapes, on N(0, 1) inputs, at groups 4
    (a standalone wave's bucket) and 12 (a 3-lane sweep's):

    * precision: forward, input gradient and weight gradient of each
      convolution through ``member_conv2d`` (the path of a cohort step,
      under ``"grouped"``), and cuDNN's own weight gradient, against
      float64 on the card (cuDNN's double-precision convolution), as
      max |err| / sum|terms| in u = 2**-24. The port's path must stay
      within ``CONV_GATE_U``; cuDNN's weight gradient is printed (it is
      why the port does not use it), and so are both weight gradients'
      times at groups 4;
    * lane parity: groups 4 against the first 4 groups of 12, and
      ``grouped_matmul`` at G = 4 against the first 4 of G = 12 (fc0's
      forward, dW and dx), as max |diff| (printed)."""
    import torch.nn.functional as F
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import member_math
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    n, k, c_out = 64, 5, 64

    def grads(conv, x, w, gy):
        x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv(x, w)
        return (y.detach(), *torch.autograd.grad(y, (x, w), gy))

    def timed(fn):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 10

    for name, c_in, hw in (("conv0", 3, 32), ("conv1", 64, 16)):
        x = _rand(torch, rng, (n, 12 * c_in, hw, hw), dev)
        w = _rand(torch, rng, (12 * c_out, c_in, k, k), dev)
        gy = _rand(torch, rng, (n, 12 * c_out, hw, hw), dev)
        port = {}
        for G in (4, 12):
            xg, wg, gyg = x[:, :G * c_in], w[:G * c_out], gy[:, :G * c_out]

            def member(a, b):
                return member_math.member_conv2d(a, b, groups=G,
                                                 padding=k // 2)

            def plain(a, b):
                return F.conv2d(a, b, padding=k // 2, groups=G)

            def cudnn_wgrad():
                return torch.nn.grad.conv2d_weight(xg, wg.shape, gyg,
                                                   padding=k // 2, groups=G)

            with member_math.routing("grouped"):
                port[G] = grads(member, xg, wg, gyg)
            ref = grads(plain, xg.double(), wg.double(), gyg.double())
            mag = grads(plain, xg.double().abs(), wg.double().abs(),
                        gyg.double().abs())
            got = (*port[G], cudnn_wgrad())
            errs = [float(((g.double() - r).abs() / m.clamp_min(1e-300))
                          .max()) / 2.0 ** -24
                    for g, r, m in zip(got, (*ref, ref[2]), (*mag, mag[2]))]
            times = ""
            if G == 4:
                leaf = wg.clone().requires_grad_(True)
                with member_math.routing("grouped"):
                    y = member(xg, leaf)     # backward: the weight gradient
                ms_port = timed(lambda: torch.autograd.grad(
                    y, leaf, gyg, retain_graph=True))
                ms_cudnn = timed(cudnn_wgrad)
                del y, leaf
                times = (f"; wgrad {ms_port:.3f} ms (port), {ms_cudnn:.3f} "
                         f"ms (cuDNN)")
            log(f"[lane-ops] {name} groups {G} (n={n}, {c_in}->{c_out}, "
                f"{hw}x{hw}) vs float64, max |err|/sum|terms| in u=2^-24: "
                f"fwd {errs[0]:.1f}, dgrad {errs[1]:.1f}, wgrad {errs[2]:.1f} "
                f"(cuDNN's own wgrad {errs[3]:.1f}); gate {CONV_GATE_U}"
                f"{times}")
            if not max(errs[:3]) <= CONV_GATE_U:
                raise AssertionError(
                    f"{name} groups {G}: the port's convolution misses "
                    f"float64 by {max(errs[:3]):.1f} u > {CONV_GATE_U}")
        (y4, dx4, dw4), (y12, dx12, dw12) = port[4], port[12]
        gaps = [float((wide - narrow).abs().max()) for wide, narrow in (
            (y12[:, :4 * c_out], y4), (dx12[:, :4 * c_in], dx4),
            (dw12[:4 * c_out], dw4))]
        log(f"[lane-ops] {name} groups 4 vs the first 4 of 12: max |diff| "
            f"fwd {gaps[0]:.3e}, dgrad {gaps[1]:.3e}, wgrad {gaps[2]:.3e}")
    M, K, N = FC_SHAPES["fc0"]
    a, b = _rand(torch, rng, (12, M, K), dev), _rand(torch, rng, (12, K, N), dev)
    g = _rand(torch, rng, (12, M, N), dev)
    gaps = []
    for lhs, rhs in ((a, b), (a.transpose(1, 2), g), (g, b.transpose(1, 2))):
        wide = gm.grouped_matmul(lhs, rhs)[:4]
        gaps.append(float((gm.grouped_matmul(lhs[:4], rhs[:4]) - wide)
                          .abs().max()))
        gaps.append(gm.split_k(lhs.shape[1], rhs.shape[2], lhs.shape[2])[0])
    log(f"[lane-ops] grouped_matmul fc0 G=4 vs the first 4 of G=12: max "
        f"|diff| fwd {gaps[0]:.3e} (split {gaps[1]}), dW {gaps[2]:.3e} "
        f"(split {gaps[3]}), dx {gaps[4]:.3e} (split {gaps[5]})")


def phase_full_width(torch, smi: str) -> dict:
    """Phase 7c, ``paper-cifar10-cnn`` at full width, cohort engine with
    ``member_kernel="grouped"``, horizon ``POLICY_HORIZON``:

    * determinism: the FedPSA run with cuDNN's deterministic flag on, off
      (``setup_device`` sets it; the off run clears it after), and on
      again; the two runs with it on must give bit-equal digest streams
      and accuracies;
    * a 1-lane FedPSA sweep, which must be bit-equal to the standalone run
      (the same shapes throughout);
    * a 3-lane FedPSA sweep (data seeds ``FULL_SWEEP_SEEDS``, gamma
      ``FULL_SWEEP_GAMMA``) with exact launch counts, s/receive and peak
      device memory; lane 0 is the standalone run's configuration and must
      stay within the lane tolerance of it (checked after FedAvg, so that
      the phase prints all it measured first), and the wave's ops are
      checked at the standalone and the sweep's widths
      (``_lane_op_gaps``);
    * ``run_fedavg``.

    Returns the 3-lane sweep's and FedAvg's launch counts by path name,
    the first FedPSA run with the flag on (result, launch counts), and its
    wall seconds."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    cfg, clients, test, calib, params = _main_world(torch)
    sim = simulator.SimConfig(engine="cohort", member_kernel="grouped",
                              record_trajectory=True,
                              **{**MAIN_SIM, "horizon": POLICY_HORIZON})
    engines = []
    make_engine, setup = simulator._make_cohort_engine, simulator.setup_device

    def capture_engine(*a, **kw):
        engines.append(make_engine(*a, **kw))
        return engines[-1]

    def setup_nondeterministic(name):
        dev = setup(name)
        torch.backends.cudnn.deterministic = False
        return dev

    def fedpsa():
        return simulator.run_algorithm("fedpsa", cfg, params, clients, test,
                                       sim, psa_cfg=PSAConfig(),
                                       calib_batch=calib)

    def sweep(seeds, gammas):
        return simulator.run_sweep(
            "fedpsa", cfg, params, clients, test, sim,
            simulator.SweepConfig(data_seeds=seeds, policy_params=[
                {"gamma": g} for g in gammas]),
            psa_cfg=PSAConfig(), calib_batch=calib)

    simulator._make_cohort_engine = capture_engine
    runs = {}
    try:
        for label in ("on", "off", "on again"):
            simulator.setup_device = (setup_nondeterministic
                                      if label == "off" else setup)
            engines.clear()
            res, wall, mem, counts = _timed_run(torch, fedpsa)
            flag = torch.backends.cudnn.deterministic
            (engine,) = engines
            want = {**_want_launches("fedpsa", "l2", res),
                    "grouped_matmul": CNN_GM_PER_STEP * engine.steps_run}
            if counts != want or flag != (label != "off"):
                raise AssertionError(f"determinism {label}: launches {counts}"
                                     f" != {want} or flag {flag}")
            runs[label] = (res, wall, counts)
            log(f"[determinism] fedpsa cohort/grouped cudnn.deterministic="
                f"{flag}: receives={res.dispatches} versions={res.versions} "
                f"final={res.final_accuracy:.4f} wall={wall:.2f}s "
                f"s/receive={wall / res.dispatches:.4f} {mem} on {smi}")
            del engine, res
        simulator.setup_device = setup
        on, off, again = (runs[k][0] for k in ("on", "off", "on again"))
        if on.digests != again.digests or on.accuracies != again.accuracies:
            raise AssertionError(
                f"determinism: two runs with the flag on differ: "
                f"{_gap_profile(again.digests, on.digests)}, accuracies "
                f"{on.accuracies} vs {again.accuracies}")
        s_on = [runs[k][1] / runs[k][0].dispatches for k in ("on", "on again")]
        s_off = runs["off"][1] / off.dispatches
        log(f"[determinism] the two runs with the flag on are bit-equal "
            f"({len(on.digests)} digests, accuracies {on.accuracies}); the "
            f"run with it off: {_gap_profile(off.digests, on.digests)}, "
            f"final {off.final_accuracy:.4f}; s/receive on {s_on[0]:.4f}, "
            f"{s_on[1]:.4f}, off {s_off:.4f} (on/off "
            f"{np.mean(s_on) / s_off:.3f})")

        engines.clear()
        res, wall, mem, counts = _timed_run(
            torch, lambda: sweep(FULL_SWEEP_SEEDS[:1], FULL_SWEEP_GAMMA[:1]))
        if res.digests[0] != on.digests or \
                res.lane_accuracies[0] != on.accuracies or \
                counts != runs["on"][2]:
            raise AssertionError(
                f"1-lane sweep vs the standalone run: "
                f"{_gap_profile(res.digests[0], on.digests)}; launches "
                f"{counts} vs {runs['on'][2]}")
        log(f"[sweep-full] fedpsa 1 lane: bit-equal to the standalone run "
            f"(digests, accuracies, launches {counts}); wall={wall:.2f}s "
            f"s/receive={wall / res.dispatches:.4f} {mem}")
        del res

        engines.clear()
        S = len(FULL_SWEEP_SEEDS)
        res, wall, mem, counts = _timed_run(
            torch, lambda: sweep(FULL_SWEEP_SEEDS, FULL_SWEEP_GAMMA))
        (engine,) = engines
        want = {**_want_sweep_launches("fedpsa", "l2", res),
                "grouped_matmul": CNN_GM_PER_STEP * engine.steps_run}
        if counts != want or counts["grouped_matmul"] != \
                runs["on"][2]["grouped_matmul"]:
            raise AssertionError(f"sweep: launches {counts} != {want} (the "
                                 f"standalone run: {runs['on'][2]})")
        if res.dispatches != on.dispatches or res.versions != on.versions:
            raise AssertionError("sweep: the shared timeline differs from "
                                 "the standalone run's")
        acc = np.asarray(res.final_accuracy)
        if not (np.all(acc >= 0) and np.all(acc <= 1)):
            raise AssertionError(f"sweep: accuracies {acc}")
        log(f"[sweep-full] fedpsa {S} lanes (data seeds {FULL_SWEEP_SEEDS}, "
            f"gamma {FULL_SWEEP_GAMMA}) cohort/grouped d={CIFAR_D}: "
            f"receives={res.dispatches} versions={res.versions} "
            f"cohorts={res.cohorts} finals={[round(float(a), 4) for a in acc]} "
            f"wall={wall:.2f}s s/receive={wall / res.dispatches:.4f} "
            f"({wall / (S * res.dispatches):.4f} a lane-receive; standalone "
            f"{s_on[0]:.4f}, {s_on[1]:.4f}) {mem} launches={counts}")
        lane0 = _lane_gap(res.digests[0], on.digests)
        log(f"[sweep-full] lane 0 vs the standalone run: "
            f"{_gap_profile(res.digests[0], on.digests)}; {lane0:.3e} of the "
            f"lane tolerance (rtol {LANE_RTOL}, atol {LANE_ATOL}); final "
            f"{acc[0]:.4f} vs {on.final_accuracy:.4f}")
        sweep_counts = counts
        del engine, res
        _lane_op_gaps(torch)

        engines.clear()
        res, wall, mem, counts = _timed_run(
            torch, lambda: simulator.run_algorithm("fedavg", cfg, params,
                                                   clients, test, sim))
        (engine,) = engines
        want = {"buffer_agg": 0, "sens_sketch": 0, "flash_attention": 0,
                "flash_attention_bwd": 0,
                "grouped_matmul": CNN_GM_PER_STEP * engine.steps_run}
        if counts != want or res.cohorts != res.versions or res.versions < 1:
            raise AssertionError(f"fedavg: launches {counts} != {want}, "
                                 f"rounds {res.versions} waves {res.cohorts}")
        if not 0.0 <= res.final_accuracy <= 1.0:
            raise AssertionError(f"fedavg: accuracy {res.final_accuracy}")
        log(f"[fedavg-full] cohort/grouped d={CIFAR_D}: rounds={res.versions} "
            f"dispatches={res.dispatches} final={res.final_accuracy:.4f} "
            f"wall={wall:.2f}s s/receive={wall / res.dispatches:.4f} {mem} "
            f"launches={counts}")
        del engine, res
        if not lane0 <= 1.0:
            raise AssertionError(f"sweep: lane 0 ends {lane0:.3e} x the lane "
                                 f"tolerance from its standalone run")
    finally:
        simulator._make_cohort_engine = make_engine
        simulator.setup_device = setup
    return ({"sweep": sweep_counts, "fedavg": counts}, runs["on"][::2],
            runs["on"][1])


# ---------------------------------------------------------------------------
# [population]: lazy populations and streaming client shards
# ---------------------------------------------------------------------------

POP_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                           "population_digests.json")
POP_POLICIES = ("fedasync", "fedbuff", "fedpsa")
# grouped_matmul launches per local step of paper-synthetic-mlp under
# member_kernel="grouped": forward, dW and dx of its three dense layers,
# less the first layer's dx (its input is data)
MLP_GM_PER_STEP = 3 * 3 - 1
# (c) the reference population benchmark's sizing
# (benchmarks/population_throughput.py): 1,024 in flight, latency U(100,
# 500), 2 local epochs of batch 32; about 500 receives (the benchmark's
# 1,000, halved for the script's time limit; at 250 the pop-1m runs train
# one wave, so nothing is left to prefetch)
POP_LATENCY = (100.0, 500.0)
POP_RECEIVES = 500
# (preset, policy, prefetch): each preset's own prefetch setting, and
# pop-1m fedpsa without it too
POP_SCALE_RUNS = (("pop-100k", "fedasync", False),
                  ("pop-100k", "fedpsa", False),
                  ("pop-1m", "fedasync", True), ("pop-1m", "fedpsa", True),
                  ("pop-1m", "fedpsa", False))
# pop-1m without the profiler, prefetch off, then on (one pair, for the
# script's time limit)
POP_PAIR_ORDER = (False, True)
TRACE_PATH = os.path.join(ROOT, "build", "chip_smoke_population_trace.json")


class _PeakRss:
    """Peak resident set size of this process over a ``with`` block,
    sampled from /proc/self/statm every 20 ms by a thread of its own."""

    def __init__(self):
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _read(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self.page

    def _loop(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._read())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())
        return False


def _capture_stores():
    """(list, restore): every ``ClientSlabStore.build`` lands in the list
    until ``restore()``."""
    from repro_torch.data.loader import ClientSlabStore
    made, orig = [], ClientSlabStore.build.__func__

    def spy(cls, datasets, **kw):
        made.append(orig(cls, datasets, **kw))
        return made[-1]

    ClientSlabStore.build = classmethod(spy)

    def restore():
        ClientSlabStore.build = classmethod(orig)

    return made, restore


def _store_text(store) -> str:
    st = store.stats
    return (f"store hits={st['hits']} row_fetches={st['row_fetches']} "
            f"shard_loads={st['shard_loads']} evictions={st['evictions']} "
            f"prefetch issued={st['prefetch_issued']} "
            f"hits={st['prefetch_hits']} wasted={st['prefetch_wasted']} "
            f"peak_bytes={store.peak_bytes / 2**20:.3f}MiB")


def _streams_of(torch, prof) -> dict:
    """{stream: {category: events}} of a trace's device events (kernels,
    copies, memsets), from its chrome trace."""
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    prof.export_chrome_trace(TRACE_PATH)
    with open(TRACE_PATH) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(TRACE_PATH)
    out = {}
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            stream = e.get("args", {}).get("stream")
            by = out.setdefault(stream, {})
            by[cat] = by.get(cat, 0) + 1
    return out


def _check_side_stream(torch, prof, what: str) -> None:
    """The prefetch's side stream ran copies only: every kernel of the
    trace ran on one stream, and some host-to-device copies ran on
    another."""
    streams = _streams_of(torch, prof)
    kern = [s for s, by in streams.items() if by.get("kernel")]
    side = {s: by for s, by in streams.items() if s not in kern}
    log(f"[population] {what} trace by stream: {streams}")
    if len(kern) != 1:
        raise AssertionError(f"{what}: kernels ran on streams {kern}, not "
                             f"on one")
    if not any(by.get("gpu_memcpy") for by in side.values()):
        raise AssertionError(f"{what}: no copy ran beside the kernels' "
                             f"stream (no side-stream prefetch in the trace)")
    if any(by.get("gpu_memset") for by in side.values()):
        raise AssertionError(f"{what}: a memset ran on the side stream")
    log(f"[population] {what}: all kernels on stream {kern[0]}; the side "
        f"stream(s) {sorted(side)} ran "
        f"{sum(by.get('gpu_memcpy', 0) for by in side.values())} copies and "
        f"no kernel")


def _population_kernels(torch, dev, smi: str) -> dict:
    """The path's kernels against their plain versions at this slice's
    shapes, and their times: ``grouped_matmul`` at G = 256 (a full wave,
    ``max_cohort``) and 768 (a 3-lane sweep of such waves) over the MLP's
    products at M = 32 (its ``bs_pad``), ``sens_sketch`` over waves of 256
    and 768 members of the MLP (d = 4,522), and ``buffer_agg`` at L = 5, d
    = 4,522. Returns each kernel's timed case; the times hide the host's
    queueing (``_time_ms``'s ``hide_host``: these launches are shorter
    than the host's time to queue them)."""
    from repro_torch.configs import get_config
    from repro_torch.common.tree import FlatSpec
    from repro_torch.kernels import buffer_agg as ba
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import sens_sketch as ss
    from repro_torch.models.model import init_params
    rng = np.random.default_rng(7)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    spec = FlatSpec(init_params(torch.Generator().manual_seed(0),
                                get_config("paper-synthetic-mlp")))
    d, M, out = spec.size, 32, {}
    widths = (32, 64, 32, 10)
    for G in (256, 768):
        for K, N in zip(widths[:-1], widths[1:]):
            x = _rand(torch, rng, (G, M, K), dev)
            w = _rand(torch, rng, (G, K, N), dev)
            g = _rand(torch, rng, (G, M, N), dev)
            for what, a, b in (("fwd", x, w), ("dW", x.transpose(1, 2), g),
                               ("dx", g, w.transpose(1, 2))):
                got = gm.grouped_matmul(a, b)
                err, rel = _gm_rel(torch, got, gm.grouped_matmul_plain(a, b))
                S = gm.split_k(a.shape[1], b.shape[2], a.shape[2])[0]
                log(f"[population] grouped_matmul G={G} {what} "
                    f"{tuple(a.shape[1:])}@{tuple(b.shape[1:])} split {S} "
                    f"max|err|={err:.3e} rel={rel:.3e} tol=1e-05")
                if not (rel <= 1e-5 and S == 1):
                    raise AssertionError(f"grouped_matmul G={G} {what}: rel "
                                         f"{rel}, split {S}")
    G, (K, N) = 256, (32, 64)
    x, w = _rand(torch, rng, (G, M, K), dev), _rand(torch, rng, (G, K, N), dev)
    flops = 2 * G * M * K * N
    byts = 4 * G * (M * K + K * N + M * N)
    b_ms, f_ms = byts / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    out["grouped_matmul"] = dict(
        shape=f"G={G} ({M}, {K})@({K}, {N}) f32 (the MLP's fc0 forward, a "
              f"full wave)",
        max_abs_err=_gm_rel(torch, gm.grouped_matmul(x, w),
                            gm.grouped_matmul_plain(x, w))[0],
        ms=_time_ms(torch, lambda: gm.grouped_matmul(x, w), 100, flush,
                    hide_host=True),
        plain_ms=_time_ms(torch, lambda: gm.grouped_matmul_plain(x, w), 20,
                          flush, hide_host=True),
        library_ms=_time_ms(torch, lambda: torch.bmm(x, w), 100, flush,
                            hide_host=True),
        bound_ms=max(b_ms, f_ms),
        bound_by="bytes" if b_ms >= f_ms else "operations")

    k = 16
    for B in (256, 768):
        t, g, f = _sketch_rows(torch, rng, dev, B, d)
        table = ss.layout_table(spec.sizes, 42, k, str(dev))
        got = ss.sens_sketch_rows(t, g, f, table)
        want = ss.sens_sketch_rows_plain(t, g, f, table)
        torch.cuda.synchronize()
        share = float(((got - want).abs() / _sketch_tol(torch, t, g, f, k))
                      .max())
        tickets = ss._TICKETS[t.device]
        zero = bool((tickets == 0).all())
        log(f"[population] sens_sketch wave of B={B} at d={d} k={k}: "
            f"max|err|={float((got - want).abs().max()):.3e}, worst at "
            f"{share:.3f} of its tolerance; tickets {tickets.shape[0]} "
            f"{'all zero' if zero else 'NOT zero'} after the launch")
        if not (share <= 1.0 and zero and tickets.shape[0] >= B):
            raise AssertionError(f"sens_sketch B={B}: {share} of tolerance, "
                                 f"tickets {tickets.shape[0]} zero={zero}")
        if B == 256:
            bound, by = _sketch_bound(B * d, k, B)
            out["sens_sketch"] = dict(
                shape=f"a wave of {B} members of paper-synthetic-mlp (d={d},"
                      f" 6 leaves) k={k}",
                max_abs_err=float((got - want).abs().max()),
                ms=_time_ms(torch, lambda: ss.sens_sketch_rows(t, g, f, table),
                            100, flush, hide_host=True),
                plain_ms=_time_ms(torch, lambda: ss.sens_sketch_rows_plain(
                    t, g, f, table), 10, flush, hide_host=True),
                library_ms=None, bound_ms=bound, bound_by=by)

    L = 5
    wts = torch.softmax(_rand(torch, rng, (L,), dev), 0)
    g, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
    got, want = ba.buffer_agg(wts, g, u), ba.buffer_agg_plain(wts, g, u)
    err = float((got - want).abs().max())
    tol = 1e-6 * (1.0 + float(want.abs().max())) * L
    log(f"[population] buffer_agg L={L} d={d} max|err|={err:.3e} "
        f"tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"buffer_agg L={L} d={d}: {err} > {tol}")
    b_ms = (L + 2) * d * 4 / HBM_BYTES_PER_S * 1e3
    f_ms = 2 * L * d / FP32_FLOPS_PER_S * 1e3
    out["buffer_agg"] = dict(
        shape=f"L={L} d={d}", max_abs_err=err,
        ms=_time_ms(torch, lambda: ba.buffer_agg(wts, g, u), 200, flush,
                    hide_host=True),
        plain_ms=_time_ms(torch, lambda: ba.buffer_agg_plain(wts, g, u), 200,
                          flush, hide_host=True),
        library_ms=_time_ms(torch, lambda: torch.addmv(g, u.t(), wts), 200,
                            flush, hide_host=True),
        bound_ms=max(b_ms, f_ms),
        bound_by="bytes" if b_ms >= f_ms else "operations")
    for name, r in out.items():
        lib = r["library_ms"]
        lib = "none" if lib is None else f"{lib * 1e3:.1f}us"
        log(f"[population] {name} at {r['shape']}: {r['ms'] * 1e3:.1f}us "
            f"(plain {r['plain_ms'] * 1e3:.1f}us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f}us by {r['bound_by']}) on {smi}")
    return out


def _pop_world(preset_name: str, test_rows: int):
    from repro_torch.configs import get_population_preset
    from repro_torch.data import make_calibration_batch
    pop = get_population_preset(preset_name).population(seed=0)
    test = pop.test_dataset(test_rows)
    return pop, test, make_calibration_batch(test, 64)


def _population_parity(torch, smi: str) -> dict:
    """(a) The smoke presets (pop-smoke, pop-1m-smoke): fedasync, fedbuff
    and fedpsa on the cohort engine under ``"grouped"`` from the golden
    init, each three ways: streaming with prefetch off (digests against
    the reference's in ``POP_FIXTURE`` at RTOL/ATOL, the store's stats
    exact), with prefetch on (bit-equal to off; stats printed), and the
    monolithic engine over ``pop[c]`` clients (its ``grouped_matmul``
    count); launch counts exact. Then one profiled prefetching
    pop-1m-smoke run: no kernel on the side stream. Returns the last
    prefetching run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.convert import load_npz_params
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    with open(POP_FIXTURE) as fh:
        fixture = json.load(fh)
    cfg = get_config(fixture["model"])
    params = load_npz_params(os.path.join(ROOT, "tests", "torch_fixtures",
                                          fixture["init"]))
    engines = []
    make_engine = simulator._make_cohort_engine

    def capture_engine(*a, **kw):
        engines.append(make_engine(*a, **kw))
        return engines[-1]

    stores, restore = _capture_stores()
    simulator._make_cohort_engine = capture_engine
    counts = None
    try:
        for preset, runs in fixture["runs"].items():
            pop, test, calib = _pop_world(preset, 512)
            clients = [pop[c] for c in range(len(pop))]
            for name in POP_POLICIES:
                want = runs[name]
                kw = (dict(psa_cfg=PSAConfig(), calib_batch=calib)
                      if name == "fedpsa" else {})
                sim = simulator.SimConfig(device="cuda", **runs["sim"])
                got = {}
                for label, src, s in (
                        ("prefetch off", pop, sim),
                        ("prefetch on", pop, dataclasses.replace(
                            sim, prefetch=True)),
                        ("monolithic", clients, dataclasses.replace(
                            sim, shard_size=0))):
                    engines.clear()
                    stores.clear()
                    res, wall, mem, c = _timed_run(
                        torch, lambda: simulator.run_algorithm(
                            name, cfg, params, src, test, s, **kw))
                    got[label] = (res, c, engines[0], list(stores), wall, mem)
                what = f"{preset} {name}"
                res, c, engine, (store,), wall, mem = got["prefetch off"]
                dig = np.asarray(res.digests)
                ref = np.asarray(want["digests"])
                if dig.shape != ref.shape:
                    raise AssertionError(f"{what}: {dig.shape} != {ref.shape}")
                np.testing.assert_allclose(dig, ref, rtol=RTOL, atol=ATOL)
                for key, v in want["final"].items():
                    if key != "final_accuracy" and getattr(res, key) != v:
                        raise AssertionError(f"{what}: {key} "
                                             f"{getattr(res, key)} != {v}")
                st = {k: store.stats[k] for k in want["stats"]}
                if st != want["stats"]:
                    raise AssertionError(f"{what}: store stats {st} != "
                                         f"{want['stats']}")
                wl = {**_want_launches(name, "l2", res),
                      "grouped_matmul": MLP_GM_PER_STEP * engine.steps_run}
                res_on, c_on, _, (store_on,), wall_on, _ = got["prefetch on"]
                res_m, c_m, _, _, wall_m, _ = got["monolithic"]
                if res_on.digests != res.digests or \
                        res_on.accuracies != res.accuracies:
                    raise AssertionError(
                        f"{what}: prefetch on differs from off: "
                        f"{_gap_profile(res_on.digests, res.digests)}")
                if not (c == wl == c_on and
                        c_m["grouped_matmul"] == c["grouped_matmul"]):
                    raise AssertionError(
                        f"{what}: launches off {c} on {c_on} want {wl}, "
                        f"monolithic {c_m}")
                if store_on.stats["prefetch_issued"] < 1:
                    raise AssertionError(f"{what}: prefetch never issued")
                rel = float(np.max(np.abs(dig - ref) / (np.abs(ref)
                                                        + ATOL / RTOL)))
                log(f"[population] {what} cohort/grouped: {len(dig)} "
                    f"digests match the reference (max rel {rel:.2e}), "
                    f"stats exact {st}; prefetch on bit-equal; monolithic "
                    f"{_gap_profile(res_m.digests, res.digests)}; "
                    f"cohorts={res.cohorts} versions={res.versions} "
                    f"launches={c} (monolithic grouped_matmul "
                    f"{c_m['grouped_matmul']}); s/receive off "
                    f"{wall / res.dispatches:.4f} on "
                    f"{wall_on / res.dispatches:.4f} monolithic "
                    f"{wall_m / res.dispatches:.4f}; prefetch on "
                    f"{_store_text(store_on)}; {mem} on {smi}")
                counts = c_on
        # one prefetching pop-1m-smoke run under the profiler
        from torch.profiler import ProfilerActivity, profile
        preset = "pop-1m-smoke"
        runs = fixture["runs"][preset]
        pop, test, calib = _pop_world(preset, 512)
        sim = simulator.SimConfig(device="cuda",
                                  **{**runs["sim"], "prefetch": True})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            simulator.run_algorithm("fedpsa", cfg, params, pop, test, sim,
                                    psa_cfg=PSAConfig(), calib_batch=calib)
            torch.cuda.synchronize()
        _check_side_stream(torch, prof, f"{preset} fedpsa prefetch on")
    finally:
        simulator._make_cohort_engine = make_engine
        restore()
    return counts


def _population_full_width(torch, smi: str, mono) -> dict:
    """(b) Phase 7c's CIFAR world and window (FedPSA, cohort/grouped,
    horizon ``POLICY_HORIZON``) through a list source of 8-client shards
    (2 resident, promote 2) with prefetch on: within the golden tolerance
    of phase 7c's monolithic run (``mono``: result, launch counts), bit-
    equality printed, launch counts exact at the monolithic run's."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    cfg, clients, test, calib, params = _main_world(torch)
    sim = simulator.SimConfig(
        engine="cohort", member_kernel="grouped", record_trajectory=True,
        shard_size=8, shard_cache=2, shard_promote=2, prefetch=True,
        **{**MAIN_SIM, "horizon": POLICY_HORIZON})
    stores, restore = _capture_stores()
    try:
        res, wall, mem, counts = _timed_run(
            torch, lambda: simulator.run_algorithm(
                "fedpsa", cfg, params, clients, test, sim,
                psa_cfg=PSAConfig(), calib_batch=calib))
    finally:
        restore()
    (store,) = stores
    want, want_counts = mono
    got, ref = np.asarray(res.digests), np.asarray(want.digests)
    if got.shape != ref.shape:
        raise AssertionError(f"streaming CIFAR: {got.shape} != {ref.shape}")
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if counts != want_counts:
        raise AssertionError(f"streaming CIFAR: launches {counts} != the "
                             f"monolithic run's {want_counts}")
    log(f"[population] CIFAR d={CIFAR_D} fedpsa cohort/grouped streamed "
        f"({store.num_shards} shards of 8, 2 resident, promote 2, prefetch "
        f"on): receives={res.dispatches} versions={res.versions} "
        f"cohorts={res.cohorts}; vs the monolithic run "
        f"{_gap_profile(res.digests, want.digests)}; launches={counts} (the "
        f"monolithic run's); wall={wall:.2f}s s/receive="
        f"{wall / res.dispatches:.4f} {mem}; {_store_text(store)} on {smi}")
    return counts


def _population_scale(torch, smi: str) -> dict:
    """(c) pop-100k and pop-1m at the reference population benchmark's
    load, fedasync and fedpsa, cohort/grouped, each under a device-only
    profile (busy share; and a prefetching run's side stream ran copies
    only), with wall s/receive, peak host RSS, peak device memory and the
    store's bytes against the preset's ``resident_mb``; pop-1m fedpsa with
    prefetch on and off must be bit-equal. Returns each run's counts."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config, get_population_preset
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    cfg = get_config("paper-synthetic-mlp")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    out, digests = {}, {}
    for preset_name, name, prefetch in POP_SCALE_RUNS:
        preset = get_population_preset(preset_name)
        t_set = time.perf_counter()
        pop, test, calib = _pop_world(preset_name, 1024)
        sim = _pop_sim(simulator, preset, prefetch)
        t_set = time.perf_counter() - t_set
        kw = (dict(psa_cfg=PSAConfig(), calib_batch=calib)
              if name == "fedpsa" else {})
        stores, restore = _capture_stores()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        try:
            with _PeakRss() as rss, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = simulator.run_algorithm(name, cfg, params, pop, test,
                                              sim, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            restore()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        (store,) = stores
        what = f"{preset_name} {name} prefetch {'on' if prefetch else 'off'}"
        busy = _device_busy(torch, prof, what, wall, top=6)
        if prefetch:
            _check_side_stream(torch, prof, what)
        bound = preset.resident_mb * 2**20
        held = bound + sim.max_cohort * store.row_bytes
        if store.device_bytes > bound or store.peak_bytes > held:
            raise AssertionError(
                f"{what}: the store held {store.peak_bytes} B (cached "
                f"{store.device_bytes} B), bound {bound:.0f} B + a wave's "
                f"row block = {held:.0f} B")
        want = {**_want_launches(name, "l2", res), "grouped_matmul":
                counts["grouped_matmul"]}
        dig = np.asarray(res.digests)
        if counts != want or not np.isfinite(dig).all() or \
                counts["grouped_matmul"] < 1:
            raise AssertionError(f"{what}: launches {counts} != {want} or "
                                 f"digests not finite")
        digests[(preset_name, name, prefetch)] = res
        out[what] = counts
        log(f"[population] {what} C={preset.num_clients:,} in flight "
            f"{preset.n_inflight} cohort/grouped: receives={res.dispatches} "
            f"cohorts={res.cohorts} members/wave="
            f"{res.dispatches / max(res.cohorts, 1):.1f} "
            f"versions={res.versions} final={res.final_accuracy:.4f}; "
            f"wall={wall:.3f}s (profiled) s/receive="
            f"{wall / res.dispatches:.5f}, set-up {t_set:.2f}s; device busy "
            f"{100 * busy:.1f}%; peak host RSS {rss.peak / 2**20:.1f}MiB "
            f"(at start {rss.start / 2**20:.1f}MiB); "
            f"peak device memory {peak / 2**20:.1f}MiB (live at start "
            f"{live / 2**20:.1f}MiB); store peak "
            f"{store.peak_bytes / 2**20:.3f}MiB, cached "
            f"{store.device_bytes / 2**20:.3f}MiB against resident_mb "
            f"{preset.resident_mb:.1f}; {_store_text(store)}; "
            f"launches={counts} on {smi}")
        del store, stores, res, prof
    on = digests[("pop-1m", "fedpsa", True)]
    off = digests[("pop-1m", "fedpsa", False)]
    if on.digests != off.digests or on.accuracies != off.accuracies:
        raise AssertionError(f"pop-1m fedpsa prefetch on vs off: "
                             f"{_gap_profile(on.digests, off.digests)}")
    log(f"[population] pop-1m fedpsa prefetch on and off bit-equal "
        f"({len(on.digests)} digests, accuracies {on.accuracies})")
    _prefetch_pairs(torch, smi, cfg, params)
    return out


def _pop_sim(simulator, preset, prefetch: bool):
    """A preset's SimConfig at the reference population benchmark's load
    (``POP_LATENCY``, about ``POP_RECEIVES`` receives), cohort/grouped."""
    lo, hi = POP_LATENCY
    horizon = lo + POP_RECEIVES * 0.5 * (lo + hi) / preset.n_inflight
    return simulator.SimConfig(
        local_epochs=2, batch_size=32, horizon=horizon, eval_every=horizon,
        latency_lo=lo, latency_hi=hi, seed=0, eval_batches=2,
        engine="cohort", member_kernel="grouped", record_trajectory=True,
        device="cuda", **{**preset.sim_kwargs(), "prefetch": prefetch})


def _prefetch_pairs(torch, smi: str, cfg, params) -> None:
    """pop-1m fedasync and fedpsa without the profiler, prefetch off and on
    in ``POP_PAIR_ORDER``: each run's wall s/receive and the medians (the
    prefetch's effect, compared within this call); every run must be
    bit-equal to the first."""
    from repro_torch.configs import get_population_preset
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    preset = get_population_preset("pop-1m")
    for name in ("fedasync", "fedpsa"):
        per_receive, first = {False: [], True: []}, None
        for prefetch in POP_PAIR_ORDER:
            pop, test, calib = _pop_world("pop-1m", 1024)
            sim = _pop_sim(simulator, preset, prefetch)
            kw = (dict(psa_cfg=PSAConfig(), calib_batch=calib)
                  if name == "fedpsa" else {})
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulator.run_algorithm(name, cfg, params, pop, test, sim,
                                          **kw)
            torch.cuda.synchronize()
            per_receive[prefetch].append((time.perf_counter() - t0)
                                         / res.dispatches)
            first = first or res
            if res.digests != first.digests:
                gap = _gap_profile(res.digests, first.digests)
                raise AssertionError(f"pop-1m {name} prefetch={prefetch}: "
                                     f"{gap}")
        off, on = (float(np.median(per_receive[k])) for k in (False, True))
        log(f"[population] pop-1m {name} unprofiled s/receive, order "
            f"{['on' if p else 'off' for p in POP_PAIR_ORDER]}: off "
            f"{[round(x, 6) for x in per_receive[False]]}, on "
            f"{[round(x, 6) for x in per_receive[True]]}; medians off "
            f"{off:.6f} on {on:.6f} (on/off {on / off:.3f}); all runs "
            f"bit-equal; on {smi}")


def phase_population(torch, dev, smi: str, mono) -> tuple:
    """[population]: the slice's kernel shapes, (a) fixture parity on the
    smoke presets, (b) the full-width CIFAR run streamed, (c) pop-100k and
    pop-1m. Returns (kernel cases, launch counts by path)."""
    t0 = time.perf_counter()
    cases = _population_kernels(torch, dev, smi)
    t1 = time.perf_counter()
    paths = {"population-smoke": _population_parity(torch, smi)}
    t2 = time.perf_counter()
    paths["population-cifar"] = _population_full_width(torch, smi, mono)
    t3 = time.perf_counter()
    scale = _population_scale(torch, smi)
    paths["population"] = scale["pop-1m fedpsa prefetch on"]
    t4 = time.perf_counter()
    log(f"[population] phase {t4 - t0:.1f}s: kernels {t1 - t0:.1f}s, (a) "
        f"{t2 - t1:.1f}s, (b) {t3 - t2:.1f}s, (c) {t4 - t3:.1f}s")
    return cases, paths


# ---------------------------------------------------------------------------
# [mesh]: the mesh-sharded policy server and the data-parallel cohort
# engine, one process a rank (spawned from this script)
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")
# each rank's process group times out a collective after this long, so a
# collective that only some ranks reach fails the phase instead of hanging
MESH_GROUP_TIMEOUT_S = 120
# the golden world's runs on the mesh: all nine on 2 gloo ranks; on the
# 1-rank NCCL job (bit-equal to phase 5) a buffered apply with the sketch
# refresh, the per-receive ring and the sharded sketch
MESH_GOLDEN = [(n, "l2") for n in POLICIES] + [("asyncfeded", "cosine"),
                                                ("asyncfeded", "sketch")]
MESH_GOLDEN_NCCL = [("fedpsa", "l2"), ("fedfa", "l2"), ("asyncfeded", "sketch")]
# the full-width runs: phase 7c's FedPSA window, and asyncfeded l2 on it
MESH_FULL = (("fedpsa", "l2"), ("asyncfeded", "l2"))
# full-width waves of B members, each trained by the cohort engine with the
# mesh and without it: on 2 ranks they split into shares of 4 and 8 members
# (the runs' waves rarely reach 8 members after padding)
MESH_SPLIT_B = (8, 16)
# the fed-lm world on the mesh, cohort/grouped: (policy, sliding window);
# 8 is FEDLM_WINDOW, the window of tests/torch_fixtures/
# fed_lm_window8_digests.json
MESH_FEDLM = (("fedasync", 0), ("fedpsa", 0), ("fedpsa", 8))
# (ranks, backend, job) in the order they run. A job's golden, full-width
# and fed-lm cases, its split waves, the worlds whose fedpsa run is traced
# once more on rank 0, whether it times the collectives, and whether it
# runs the fed-lm ssm and moe cases (``FAMILY_CARD_CASES`` of each
# family). The 1-rank NCCL job runs fedpsa alone at full width and in the
# fed-lm world, and the 2-rank job traces the fed-lm run alone (its trace
# holds all five port kernels), for the script's time limit.
MESH_JOBS = (
    (1, "nccl", dict(golden=MESH_GOLDEN_NCCL, full=MESH_FULL[:1], split=(),
                     trace=(), costs=False, fedlm=MESH_FEDLM[1:2],
                     families=False)),
    (2, "gloo", dict(golden=MESH_GOLDEN, full=MESH_FULL, split=MESH_SPLIT_B,
                     trace=("fedlm",), costs=True, fedlm=MESH_FEDLM,
                     families=True)),
    (4, "gloo", dict(golden=[("fedpsa", "l2")], full=(), split=(), trace=(),
                     costs=False, fedlm=(), families=False)),
)


def _mesh_count_collectives(dist) -> dict:
    """Count every all_reduce and all_gather call (and the bytes each
    rank sends) from here on, by wrapping ``torch.distributed``'s
    functions; returns the live counters."""
    counts = {"all_reduce": 0, "all_gather": 0, "bytes": 0}
    for name in ("all_reduce", "all_gather"):
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            t = a[1] if _name == "all_gather" else a[0]
            counts[_name] += 1
            counts["bytes"] += t.numel() * t.element_size()
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    return counts


def _mesh_collective_costs(torch, dist, group) -> dict:
    """Host time of one scalar all_reduce of a CUDA tensor, read back on
    the host as the policy steps' sums are not, and of an all_gather of a
    CIFAR half-vector (each rank's shard at n = 2), each over 50 calls."""
    out = {}
    x = torch.ones((1,), device="cuda")
    v = torch.ones((CIFAR_D // 2,), device="cuda")
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
    for name, fn in (("all_reduce_scalar_ms",
                      lambda: dist.all_reduce(x, group=group)),
                     ("all_gather_half_cifar_ms",
                      lambda: dist.all_gather(parts, v, group=group))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / 50
    return out


def _mesh_port_streams(torch, prof) -> dict:
    """{stream: {"port": port-kernel events, "other": other kernels,
    "copies": copies}} of a device-only trace."""
    os.makedirs(MESH_DIR, exist_ok=True)
    path = os.path.join(MESH_DIR, f"trace{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    needles = [x for v in PORT_KERNELS.values() for x in v]
    out = {}
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        by = out.setdefault(str(e.get("args", {}).get("stream")),
                            {"port": 0, "other": 0, "copies": 0})
        if cat != "kernel":
            by["copies"] += 1
        elif any(x in e.get("name", "") for x in needles):
            by["port"] += 1
        else:
            by["other"] += 1
    return out


def _mesh_split_case(torch, world, mesh, B: int) -> dict:
    """One full-width wave of B members (clients 0..B-1, learning rate
    0.05) through the cohort engine with ``mesh`` and without it: each
    engine's ``split_waves``, launches on this rank and seconds, and
    whether the two gave the same bits. The device is set up as a run sets
    it (``setup_device``: cuDNN deterministic), and each engine's wave runs
    twice, the second timed."""
    from repro_torch.common.tree import FlatSpec
    from repro_torch.data.loader import StackedClients
    from repro_torch.federated import simulator
    from repro_torch.federated.cohort import CohortEngine
    cfg, clients, _, _, params = world
    simulator.setup_device("cuda")
    spec = FlatSpec(params)
    stacked = StackedClients.from_datasets(clients)
    sim = simulator.SimConfig()
    w0 = spec.flatten(params)[None].repeat(B, 1)
    out, got = {"B": B}, {}
    for name, m in (("mesh", mesh), ("one", None)):
        engine = CohortEngine(cfg, stacked, spec, local_epochs=sim.local_epochs,
                              batch_size=sim.batch_size,
                              member_kernel="grouped", device="cuda", mesh=m)
        for _ in range(2):
            got[name], wall, _, counts = _timed_run(
                torch, lambda: engine.cohort_update(
                    w0, np.arange(B), [0.05] * B, 1000 + np.arange(B)))
        out[name] = {"split_waves": engine.split_waves, "s": wall,
                     "steps": engine.steps_run, "launches": counts}
    pairs = list(zip(got["mesh"], got["one"]))
    out["equal"] = all(torch.equal(a, b) for a, b in pairs)
    out["max_diff"] = max(float((a - b).abs().max()) for a, b in pairs)
    return out


def _mesh_rank_main(rank: int, n: int, jobdir: str) -> int:
    """One rank of a ``[mesh]`` job (``python3 chip_smoke.py --mesh-rank R N
    DIR``): the process group and mesh, then the job's runs, each with its
    launch counts, into ``DIR/rank{R}.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import simulator
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fed_mesh
    with open(os.path.join(jobdir, "job.json")) as fh:
        job = json.load(fh)
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        job["backend"], init_method=f"file://{jobdir}/rendezvous", rank=rank,
        world_size=n,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    out = {"runs": []}
    try:
        mesh = make_fed_mesh(n)
        collectives = _mesh_count_collectives(dist)
        engines = []
        make_engine = simulator._make_cohort_engine

        def capture_engine(*a, **kw):
            engines.append(make_engine(*a, **kw))
            return engines[-1]

        simulator._make_cohort_engine = capture_engine
        worlds = {"golden": _golden_world(),
                  "full": (_main_world(torch) if job["full"] or job["split"]
                           else None),
                  "fedlm": _fedlm_world() if job["fedlm"] else None,
                  **{fam: _family_world(fam)
                     for fam in {c[0] for c in job["families"]}}}
        out["split"] = [_mesh_split_case(torch, worlds["full"], mesh, B)
                        for B in job["split"]]
        # the traced runs come last: a profiler session slows the runs
        # after it. A fed-lm case's "metric" is its sliding window, a
        # family case's its member kernel.
        for kind, name, metric, trace in (
                [("golden", n_, m, False) for n_, m in job["golden"]]
                + [("full", n_, m, False) for n_, m in job["full"]]
                + [("fedlm", n_, w, False) for n_, w in job["fedlm"]]
                + [(f, n_, mk, False) for f, n_, mk in job["families"]]
                + ([("golden", "fedpsa", "l2", True)]
                   if "golden" in job["trace"] else [])
                + ([("fedlm", "fedpsa", 0, True)]
                   if "fedlm" in job["trace"] else [])):
            cfg, clients, test, calib, params = worlds[kind]
            if kind == "fedlm" and metric:
                cfg = dataclasses.replace(cfg, sliding_window=metric)
            family = kind in FAMILY_FEDLM
            base = {"golden": GOLDEN_SIM, "fedlm": FEDLM_SIM,
                    **{f: FAMILY_FEDLM_SIM for f in FAMILY_FEDLM}}.get(
                kind, {**MAIN_SIM, "horizon": POLICY_HORIZON})
            sim = simulator.SimConfig(
                engine="cohort", member_kernel=metric if family else "grouped",
                record_trajectory=True, mesh=mesh,
                **{**base, "device": "cuda"})
            kw = {}
            if name == "fedpsa":
                kw = dict(psa_cfg=PSAConfig(**(GOLDEN_PSA if kind != "full"
                                               else {})), calib_batch=calib)
            if kind in ("golden", "full") and metric != "l2":
                kw["server_kwargs"] = {"metric": metric}
            engines.clear()
            for k in ("all_reduce", "all_gather", "bytes"):
                collectives[k] = 0

            def run():
                return simulator.run_algorithm(name, cfg, params, clients,
                                               test, sim, **kw)

            streams = None
            if trace and rank == 0:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res, wall, mem, counts = _timed_run(torch, run)
                streams = _mesh_port_streams(torch, prof)
            else:
                res, wall, mem, counts = _timed_run(torch, run)
            out["runs"].append({
                "kind": kind, "name": name, "metric": metric,
                "digests": res.digests, "accuracies": res.accuracies,
                "final_accuracy": res.final_accuracy, "aulc": res.aulc,
                "weights": [e.get("weight") for e in res.server_log
                            if "weight" in e],
                **{k: getattr(res, k) for k in (
                    "versions", "dispatches", "dropped", "launched",
                    "cohorts", "engine")},
                "steps_run": engines[0].steps_run,
                "split_waves": engines[0].split_waves, "counts": counts,
                "wall": wall, "mem": mem, "traced": trace and rank == 0,
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "collectives": dict(collectives), "streams": streams})
            del res
        if job["costs"]:
            out["costs"] = _mesh_collective_costs(torch, dist,
                                                  mesh.get_group("d"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(jobdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def _mesh_spawn(n: int, backend: str, job: dict, timeout: float) -> tuple:
    """Run a job on ``n`` rank processes of this script; returns (each
    rank's results or None, each rank's exit code, each rank's log tail,
    seconds). Ranks still running at ``timeout`` are killed."""
    import shutil
    jobdir = os.path.join(MESH_DIR, f"n{n}-{backend}")
    shutil.rmtree(jobdir, ignore_errors=True)
    os.makedirs(jobdir)
    with open(os.path.join(jobdir, "job.json"), "w") as fh:
        json.dump({"backend": backend, **job}, fh)
    logs = [open(os.path.join(jobdir, f"rank{r}.log"), "w") for r in range(n)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(n), jobdir], stdout=logs[r], stderr=subprocess.STDOUT,
        start_new_session=True) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
        for fh in logs:
            fh.close()
    secs = time.perf_counter() - t0
    results, tails = [], []
    for r in range(n):
        path = os.path.join(jobdir, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else None)
        with open(os.path.join(jobdir, f"rank{r}.log")) as fh:
            tails.append(fh.read()[-3000:])
    shutil.rmtree(jobdir, ignore_errors=True)
    return results, [p.returncode for p in procs], tails, secs


def _mesh_check_run(what: str, run: dict, ref: dict, exact: bool,
                    want_counts: dict) -> str:
    """Hold one rank's run to its reference: bit-equal digests and
    accuracies (``exact``), else the golden or lane tolerance, which
    ``ref["tol"]`` names; the counters; the launch counts."""
    got, want = np.asarray(run["digests"]), np.asarray(ref["digests"])
    if got.shape != want.shape:
        raise AssertionError(f"{what}: digests {got.shape} != {want.shape}")
    if exact:
        if run["digests"] != ref["digests"] or \
                run["accuracies"] != ref["accuracies"]:
            raise AssertionError(f"{what}: not bit-equal to the "
                                 f"single-device run: "
                                 f"{_gap_profile(got, want)}")
        gap = "bit-equal"
    elif ref["tol"] == "lane":
        share = _lane_gap(got, want)
        if not share <= 1.0:
            raise AssertionError(f"{what}: {share:.3e} x the lane tolerance "
                                 f"({_gap_profile(got, want)})")
        gap = (f"{share:.3e} of the lane tolerance (rtol {LANE_RTOL}, atol "
               f"{LANE_ATOL}); {_gap_profile(got, want)}")
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        rel = float(np.max(np.abs(got - want) / (np.abs(want) + ATOL / RTOL)))
        gap = f"max rel {rel:.2e} (golden tolerance)"
    for key in ("versions", "dispatches", "dropped", "launched"):
        if key in ref and run[key] != ref[key]:
            raise AssertionError(f"{what}: {key} {run[key]} != {ref[key]}")
    got_counts = {k: run["counts"][k] for k in want_counts}
    if got_counts != want_counts:
        raise AssertionError(f"{what}: launches {got_counts} != "
                             f"{want_counts}")
    return gap


def _mesh_check_split(n: int, backend: str, results: list, smi: str) -> None:
    """Each full-width split case on every rank: the mesh engine split its
    wave each of the two times and the single-device engine did not, to the same bits, with
    the same launch counts, so the data-parallel path ran on the card."""
    for r, rank in enumerate(results):
        for case in rank["split"]:
            what = f"[mesh] n={n} {backend} rank {r} wave of {case['B']}"
            mesh, one = case["mesh"], case["one"]
            log(f"{what}: split {mesh['split_waves']} (one device "
                f"{one['split_waves']}), bit-equal {case['equal']} (max "
                f"|diff| {case['max_diff']:.3e}), {mesh['steps']} steps, "
                f"{mesh['s']:.3f}s against {one['s']:.3f}s on one device, "
                f"launches {mesh['launches']} on {smi}")
            if (mesh["split_waves"], one["split_waves"]) != (2, 0):
                raise AssertionError(f"{what}: split waves {mesh['split_waves']}"
                                     f" (want 2) and {one['split_waves']} on "
                                     f"one device (want 0)")
            if not case["equal"]:
                raise AssertionError(f"{what}: not bit-equal to one device "
                                     f"(max |diff| {case['max_diff']:.3e})")
            if mesh["launches"] != one["launches"]:
                raise AssertionError(f"{what}: launches {mesh['launches']} "
                                     f"!= {one['launches']} on one device")


def _mesh_width_probe(torch) -> None:
    """The cohort engine splits a wave over ranks only into shares of whole
    buckets (4 members), because cuDNN picks its grouped convolution's
    algorithm by the group count. The CNN's two convolutions at the batch
    of a local step, forward and input gradient of G = 8 and 16 members in
    one call against shares of 1, 2, 4 (and 8) members at each offset:
    shares of whole buckets must be bit-equal (the split relies on it);
    the others are printed."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    for G in (8, 16):
        for name, (c_in, c_out, hw) in (("conv0", (3, 64, 32)),
                                        ("conv1", (64, 64, 16))):
            x = torch.randn(64, G * c_in, hw, hw, device="cuda",
                            generator=gen)
            w = 0.05 * torch.randn(G * c_out, c_in, 5, 5, device="cuda",
                                   generator=gen)
            gy = torch.randn(64, G * c_out, hw, hw, device="cuda",
                             generator=gen)
            fwd = F.conv2d(x, w, padding=2, groups=G)
            dgrad = torch.nn.grad.conv2d_input(x.shape, w, gy, padding=2,
                                               groups=G)
            gaps = {}
            for m in (1, 2, 4, 8)[:G.bit_length() - 1]:
                worst = [0.0, 0.0]
                for lo in range(0, G, m):
                    xs = x[:, lo * c_in:(lo + m) * c_in].contiguous()
                    ws = w[lo * c_out:(lo + m) * c_out].contiguous()
                    gs = gy[:, lo * c_out:(lo + m) * c_out].contiguous()
                    f = F.conv2d(xs, ws, padding=2, groups=m)
                    dx = torch.nn.grad.conv2d_input(xs.shape, ws, gs,
                                                    padding=2, groups=m)
                    worst[0] = max(worst[0], float((f - fwd[:, lo * c_out:(
                        lo + m) * c_out]).abs().max()))
                    worst[1] = max(worst[1], float((dx - dgrad[:, lo * c_in:(
                        lo + m) * c_in]).abs().max()))
                gaps[m] = worst
            log(f"[mesh] {name} cuDNN grouped convolution, shares of m "
                f"members vs one call of {G}: max |diff| (forward, input "
                f"gradient) { {m: [f'{v:.3e}' for v in g] for m, g in gaps.items()} }")
            bad = {m: g for m, g in gaps.items() if m >= 4 and g != [0.0, 0.0]}
            if bad:
                raise AssertionError(f"{name}: shares of whole buckets are "
                                     f"not bit-equal to the wave of {G}: "
                                     f"{bad}")


def phase_mesh(torch, smi: str, golden_ref: dict, full_ref: dict,
               fedlm_ref: dict, fam_ref: dict) -> dict:
    """``[mesh]``: the port's mesh path, each job's ranks spawned from this
    script on the one card (``MESH_JOBS``): (a) the golden world, cohort
    engine with ``"grouped"``: ``MESH_GOLDEN_NCCL`` on 1 NCCL rank
    bit-equal to phase 5's single-device runs, all nine ``MESH_GOLDEN``
    runs on 2 gloo ranks at the golden tolerance (asyncfeded's cosine and
    sketch metrics against their fixtures), and fedpsa on 4 gloo ranks
    (d = 4,522 padded by 2), after the width probe behind the engine's
    split rule (``_mesh_width_probe``); (b) the full-width CIFAR window of
    phase 7c: FedPSA (and asyncfeded l2 on 2 ranks), 1 NCCL rank bit-equal
    to the single-device runs (``full_ref``), 2 gloo ranks within the lane
    tolerance; (c) full-width
    waves of 8 and 16 members on the 2 gloo ranks, with the mesh and
    without it: split on every rank, bit-equal, the same launches
    (``_mesh_check_split``); (d) the fed-lm world (``MESH_FEDLM``:
    fedasync, fedpsa, and fedpsa with a window of 8, cohort/grouped; fedpsa
    alone on NCCL): 1 NCCL rank bit-equal to ``[fed-lm]``'s single-device
    runs
    (``fedlm_ref``), 2 gloo ranks at the golden tolerance against the
    golden and the window fixture, and the 2-rank fedpsa run once more
    with rank 0 under a device-only profile, every port kernel on one
    stream; (e) ``fed-lm-ssm-smoke`` and ``fed-lm-moe-smoke``,
    ``FAMILY_CARD_CASES`` (fedasync under "vmap", fedpsa under "grouped")
    on the 2 gloo ranks, bit-equal to the single-device cohort runs
    (``fam_ref``). Every rank's launch counts are exact (``buffer_agg`` an apply on its shard,
    ``sens_sketch`` as on one device, ``grouped_matmul`` the single-device
    run's; a fed-lm run's attention launches the single-device run's, its
    waves training whole on every rank), every rank returns the same run.
    Then 2 NCCL ranks on the one card must fail. Returns the launch counts
    of the 2-rank full-width FedPSA run, rank 0, and of the fed-lm and
    the families' runs by path."""
    t_phase = time.perf_counter()
    _mesh_width_probe(torch)
    out, fedlm_paths = {}, {}
    for n, backend, job in MESH_JOBS:
        job = {**job, "families": [
            (f, n_, mk) for f in FAMILY_FEDLM for n_, mk in FAMILY_CARD_CASES]
            if job["families"] else []}
        results, codes, tails, secs = _mesh_spawn(n, backend, job, 600)
        if any(c != 0 for c in codes) or any(r is None for r in results):
            for r, t in enumerate(tails):
                log(f"[mesh] n={n} {backend} rank {r} exit {codes[r]}:\n{t}")
            raise AssertionError(f"[mesh] n={n} {backend}: ranks exited "
                                 f"{codes}")
        log(f"[mesh] n={n} {backend}: {len(results[0]['runs'])} runs on "
            f"{n} rank(s) in {secs:.1f}s (processes included) on {smi}")
        for i, run in enumerate(results[0]["runs"]):
            kind, key = run["kind"], (run["name"], run["metric"])
            what = (f"mesh n={n} {backend} fed-lm {run['name']} window="
                    f"{run['metric']}" if kind == "fedlm" else
                    f"mesh n={n} {backend} {FAMILY_FEDLM[kind]} "
                    f"{run['name']} cohort/{run['metric']}"
                    if kind in FAMILY_FEDLM else
                    f"mesh n={n} {backend} {kind} "
                    f"{run['name']}/{run['metric']}")
            # the families' waves train whole on every rank: bit-equal
            exact = n == 1 or kind in FAMILY_FEDLM
            if kind in FAMILY_FEDLM:
                ref = fam_ref[(kind,) + key]
            else:
                ref = {"golden": golden_ref, "full": full_ref,
                       "fedlm": fedlm_ref}[kind][key]
            if kind in ("golden", "fedlm") and n > 1:
                ref = {**ref, "digests": ref["file_digests"], "tol": "golden",
                       **ref["file_final"]}
            elif kind not in ("golden", "fedlm"):
                ref = {**ref, "tol": "lane"}
            if kind == "fedlm" or kind in FAMILY_FEDLM:
                want = dict(ref["counts"])
            else:
                res_like = types.SimpleNamespace(**{k: run[k] for k in (
                    "dispatches", "versions", "cohorts", "engine")})
                want = {**_want_launches(run["name"], run["metric"],
                                         res_like),
                        "grouped_matmul": ref["counts"]["grouped_matmul"]}
            for r, rank in enumerate(results):
                other = rank["runs"][i]
                for k in ("digests", "accuracies", "versions", "cohorts"):
                    if other[k] != run[k]:
                        raise AssertionError(f"{what}: rank {r}'s {k} differ "
                                             f"from rank 0's")
                gap = _mesh_check_run(f"{what} rank {r}", other, ref, exact,
                                      want)
            if run["kind"] == "golden" and n > 1 and "weights" in ref:
                np.testing.assert_allclose(run["weights"], ref["weights"],
                                           rtol=1e-4)
            walls = [rk["runs"][i]["wall"] for rk in results]
            col = run["collectives"]
            log(f"[mesh] {what}: {gap}; receives={run['dispatches']} "
                f"versions={run['versions']} cohorts={run['cohorts']} "
                f"split waves by rank "
                f"{[rk['runs'][i]['split_waves'] for rk in results]} "
                f"s/receive={max(walls) / run['dispatches']:.4f} "
                f"(single device {ref.get('s_per_receive', float('nan')):.4f})"
                f"{' profiled' if run['traced'] else ''} peak MiB by rank "
                f"{[round(rk['runs'][i]['peak_mib'], 1) for rk in results]} "
                f"launches every rank {want} collectives a receive "
                f"all_reduce={col['all_reduce'] / run['dispatches']:.2f} "
                f"all_gather={col['all_gather'] / run['dispatches']:.2f} "
                f"({col['bytes'] / run['dispatches'] / 2**20:.3f} MiB sent) "
                f"on {smi}")
            if run["kind"] == "full" and run["name"] == "fedpsa" and n == 2:
                out = run["counts"]
            if kind == "fedlm" and not run["traced"]:
                fedlm_paths[f"mesh-n{n}-{backend}-fed-lm-{run['name']}-w"
                            f"{run['metric']}"] = run["counts"]
            elif kind in FAMILY_FEDLM:
                fedlm_paths[f"{FAMILY_FEDLM[kind]}-mesh-n{n}-{run['name']}-"
                            f"{run['metric']}"] = run["counts"]
            if run["streams"] is not None:
                port = [s for s, by in run["streams"].items() if by["port"]]
                log(f"[mesh] {what} rank 0 trace by stream: "
                    f"{run['streams']}")
                if len(port) != 1:
                    raise AssertionError(f"{what}: port kernels ran on "
                                         f"streams {port}, not on one")
                log(f"[mesh] {what}: every port kernel on stream {port[0]}")
        _mesh_check_split(n, backend, results, smi)
        if "costs" in results[0]:
            log(f"[mesh] n={n} {backend} collective costs by rank (host ms a "
                f"call, CUDA tensors): {[rk['costs'] for rk in results]}")
    # NCCL refuses two ranks on one card: the job must fail with NCCL's
    # own error, not hang and not run on another backend
    results, codes, tails, secs = _mesh_spawn(
        2, "nccl", {"golden": [("fedbuff", "l2")], "full": [], "split": [],
                    "trace": [], "costs": False, "fedlm": [],
                    "families": []}, 180)
    if all(c == 0 for c in codes) or any(c == -9 for c in codes) or \
            not any("Duplicate GPU" in t for t in tails):
        raise AssertionError(f"[mesh] 2 NCCL ranks on one card: exit codes "
                             f"{codes} (want NCCL's duplicate-GPU failure, "
                             f"not a run, a hang or another error): {tails}")
    last = [t.strip().splitlines()[-1] if t.strip() else "" for t in tails]
    log(f"[mesh] 2 NCCL ranks on one card failed as expected in "
        f"{secs:.1f}s: exit codes {codes}; {last}")
    log(f"[mesh] the whole phase took {time.perf_counter() - t_phase:.1f}s")
    return out, fedlm_paths


# phase 8's profiled FedPSA window (at 2,000 units the profiler took about
# a minute to parse its two traces' 370 k events; cut to 500 for the
# script's time limit)
PROFILE_HORIZON = 500


def _profile_run(torch, engine: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    cfg, clients, test, calib, params = _main_world(torch)
    sim = SimConfig(engine=engine, member_kernel="grouped",
                    **{**MAIN_SIM, "horizon": PROFILE_HORIZON})
    torch.cuda.synchronize()
    # device activity only: host-op events would multiply the trace's
    # post-processing time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_algorithm("fedpsa", cfg, params, clients, test, sim,
                            psa_cfg=PSAConfig(), calib_batch=calib)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _device_busy(torch, prof, f"{engine}: horizon {PROFILE_HORIZON}, "
                 f"receives={res.dispatches}", wall)


# the port's kernels in a trace, by name (grouped_matmul's split-K second
# pass is splitk_reduce)
PORT_KERNELS = {"grouped_matmul": ("grouped_matmul_kernel", "splitk_reduce"),
                "flash_attention": ("flash_attention",),
                "flash_attention_bwd": ("dq_kernel", "dkdv_kernel",
                                        "bwd_dq_tc", "bwd_dkdv_tc"),
                "sens_sketch": ("sens_sketch",), "buffer_agg": ("buffer_agg",)}


def _device_busy(torch, prof, what: str, wall: float, top: int = 12) -> float:
    """Print the union of the trace's device intervals as a share of
    ``wall``, the CUDA kernels by total time, and each of the port's
    kernels' share of device time (all its instantiations); return that
    share."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):            # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"[profile] {what}: wall={wall:.3f}s (profiled) device "
        f"busy={busy / 1e6:.3f}s ({100 * busy / 1e6 / wall:.1f}% of wall), "
        f"{sum(n for n, _ in by_name.values())} device events")
    if not spans:
        log(f"[profile] {what}: the trace holds no device events")
        return 0.0
    total = sum(us for _, us in by_name.values())
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile]   {100 * us / total:5.1f}% {us / 1e3:9.1f}ms "
            f"{n:7d}x {name[:90]}")
    for kernel, needles in PORT_KERNELS.items():
        hits = [(n, us) for name, (n, us) in by_name.items()
                if any(x in name for x in needles)]
        if hits:
            us = sum(u for _, u in hits)
            log(f"[profile]   port kernel {kernel}: {100 * us / total:.1f}% of "
                f"device time, {us / 1e3:.1f}ms over "
                f"{sum(n for n, _ in hits)} launches")
    return busy / 1e6 / wall


def phase_profile(torch):
    for engine in ("sequential", "cohort"):
        _profile_run(torch, engine)


def _serve_config(spec: dict):
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    return cfg.for_long_context() if spec.get("long_context") else cfg


def _serve_world(torch, dev, spec: dict = SERVE):
    """``spec``'s model at full width (phi4-mini-3.8b by default; its
    sliding-window variant with ``long_context``), random init on the card,
    and the spec's prompts plus one more token each (for the decode
    check)."""
    from repro_torch.models import model as M
    cfg = _serve_config(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    params = M.init_params(gen, cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"] + 1),
                         generator=torch.Generator().manual_seed(spec["seed"]))
    return cfg, params, toks.to(dev)


def phase_serve_checks(torch, dev, spec: dict = SERVE):
    """On the serve world of ``spec``, outside the counted main path:
    flash_attention launches per prefill (one per layer) and per decode
    step (none); decode's logits at position S against the last logits of a
    prefill of S + 1 tokens (with a window, the cache is a ring of
    ``window`` slots that the prefill of S tokens filled by rolling the
    prompt's tail, and both sides attend over the window)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg, params, toks = _serve_world(torch, dev, spec)
    S, V = spec["prompt"], cfg.vocab_size
    with torch.no_grad():
        ops.reset_launch_counts()
        cache, _ = M.prefill(params, {"tokens": toks[:, :S]}, cfg, max_len=S + 1)
        per_prefill = ops.launch_counts()
        slots = cache["p0"]["k"].shape[2]
        ops.reset_launch_counts()
        _, dec = M.decode_step(params, cache, toks[:, S:], S, cfg)
        per_decode = ops.launch_counts()
        del cache
        _, pre = M.prefill(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    del params
    want_pre = {k: (cfg.num_layers if k == "flash_attention" else 0)
                for k in per_prefill}
    want_slots = (S + 1 if cfg.sliding_window is None
                  else min(cfg.sliding_window, S + 1))
    if per_prefill != want_pre or any(per_decode.values()) \
            or slots != want_slots:
        raise AssertionError(f"{cfg.name} serve launches per prefill "
                             f"{per_prefill} (want {want_pre}), per decode "
                             f"step {per_decode}, cache slots {slots} (want "
                             f"{want_slots})")
    dec, pre = dec[:, 0, :V].float(), pre[:, :V].float()
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(pre).all())):
        raise AssertionError("serve logits are not finite")
    err, big = float((dec - pre).abs().max()), float(pre.abs().max())
    agree = float((dec.argmax(-1) == pre.argmax(-1)).float().mean())
    what = (f"{cfg.name} B={spec['batch']} prompt={S}"
            + (f" window={cfg.sliding_window}" if cfg.sliding_window else ""))
    log(f"[serve] {what}: launches per prefill {per_prefill}, per decode "
        f"step {per_decode}; cache {slots} slots")
    log(f"[serve] {what}: decode logits at position {S} vs prefill of "
        f"{S + 1} tokens: max|diff|={err:.4e} max|prefill|={big:.4e} "
        f"tol={SERVE_TOL * big:.4e} greedy agreement {agree:.3f}")
    if not err <= SERVE_TOL * big:
        raise AssertionError(f"{what} serve decode vs prefill: {err} > "
                             f"{SERVE_TOL} * {big}")
    return {"decode_vs_prefill_max_abs": err, "prefill_max_abs": big,
            "greedy_agreement": agree, "cache_slots": slots}


def phase_profile_serve(torch, dev):
    """Phase 8 for the serve path: the prefill and then 7 decode steps, each
    under its own profiler session (device activity), and 7 decode steps
    timed unprofiled before and after those sessions."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    cfg, params, toks = _serve_world(torch, dev)
    S, n = SERVE["prompt"], 7

    def prefill():
        cache, lg = M.prefill(params, {"tokens": toks[:, :S]}, cfg,
                              max_len=S + n)
        return cache, torch.argmax(lg, -1)[:, None]

    def decode(cache, tok):
        for i in range(n):
            cache, lg = M.decode_step(params, cache, tok, S + i, cfg)
            tok = torch.argmax(lg[:, 0], -1)[:, None]
        torch.cuda.synchronize()

    def timed_decode() -> float:
        cache, tok = prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(cache, tok)
        return (time.perf_counter() - t0) / n

    with torch.no_grad():
        before = timed_decode()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache, tok = prefill()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _device_busy(torch, prof, f"serve prefill B={SERVE['batch']} S={S}", wall)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode(cache, tok)
            wall = time.perf_counter() - t0
        _device_busy(torch, prof, f"serve decode, {n} steps at B="
                     f"{SERVE['batch']} (events per step = device events / "
                     f"{n})", wall)
        after = timed_decode()
    log(f"[profile] serve decode unprofiled: {1e3 * before:.2f} ms/step before "
        f"the profiler sessions, {1e3 * after:.2f} ms/step after them")


def _free_card(torch) -> None:
    gc.collect()   # earlier phases' tensors in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()


def phase_serve(torch, dev, smi: str, spec: dict = SERVE) -> tuple:
    """The serve main path as a user runs it: ``python -m
    repro_torch.launch.serve --arch phi4-mini-3.8b --batch 8 --prompt-len
    2048 --gen 32`` (its ``main``; ``spec`` names another arch or shape;
    a ``long_context`` spec calls ``serve.generate`` on
    ``cfg.for_long_context()`` with ``main``'s init and prompts), with the
    kernel counts set to 0 just before and
    read just after. One prefill: flash_attention once per layer; decode
    steps launch none. Returns (counts, stats); the peak memory includes
    the random init."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = _serve_config(spec)
    _free_card(torch)
    live = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if spec.get("long_context"):
        # the CLI serves the registered configs; their long-context variant
        # goes through the same ``generate`` with the CLI's init and prompts
        from repro_torch.models import model as M
        params = M.init_params(
            torch.Generator(device=dev).manual_seed(spec["seed"]), cfg, dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
            generator=torch.Generator().manual_seed(spec["seed"]))
        res = serve.generate(params, cfg, prompts.to(dev), spec["gen"])
        del params
    else:
        res = serve.main(["--arch", spec["arch"], "--batch",
                          str(spec["batch"]), "--prompt-len",
                          str(spec["prompt"]), "--gen", str(spec["gen"]),
                          "--seed", str(spec["seed"]), "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {k: (cfg.num_layers if k == "flash_attention" else 0) for k in counts}
    tok = res["tokens"]
    peak = torch.cuda.max_memory_allocated()
    what = (f"{cfg.name} B={spec['batch']} prompt={spec['prompt']} "
            f"gen={spec['gen']}"
            + (f" window={cfg.sliding_window}" if cfg.sliding_window else ""))
    log(f"[serve] {what}: prefill {res['prefill_s']:.4f}s "
        f"({spec['batch'] * spec['prompt'] / res['prefill_s']:.0f} tok/s), "
        f"{res['decode_steps']} decode steps {res['decode_s']:.4f}s "
        f"({res['decode_tok_s']:.1f} tok/s, "
        f"{1e3 * res['decode_s'] / res['decode_steps']:.2f} ms/step), "
        f"wall incl. init {wall:.2f}s, peak device memory "
        f"{peak / 2**30:.2f} GiB "
        f"({live / 2**30:.2f} GiB live at the start), launches={counts} on "
        f"{smi}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != {want}")
    if tuple(tok.shape) != (spec["batch"], spec["gen"]) or \
            int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError(f"{what}: tokens {tuple(tok.shape)} out of range")
    return counts, {"prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
                    "decode_ms_per_step": 1e3 * res["decode_s"]
                    / res["decode_steps"], "decode_tok_s": res["decode_tok_s"],
                    "peak_bytes": peak}


def phase_serve_more(torch, dev, smi: str) -> tuple:
    """The serve path's other runs (after phase 9): phi4-mini-3.8b's
    long-context variant (``SERVE_LONG``: B = 1, a prompt of 16,384, twice
    the window, 32 tokens through the ring) and ``codeqwen1.5-7b`` and
    ``minitron-8b`` at the serve shape, each on random bf16 weights: the
    checks of ``phase_serve_checks`` (launches per prefill and decode step,
    cache slots, decode vs prefill logits), then the counted run
    (``phase_serve``), each model freed before the next. Returns (counts by
    path, stats by path)."""
    t0 = time.perf_counter()
    paths, stats = {}, {}
    for spec in (SERVE_LONG,) + SERVE_MORE:
        key = "serve-long-context" if spec.get("long_context") \
            else f"serve-{spec['arch']}"
        _free_card(torch)
        check = phase_serve_checks(torch, dev, spec)
        paths[key], st = phase_serve(torch, dev, smi, spec)
        stats[key] = {**st, **check}
    _free_card(torch)
    log(f"[serve] long-context and new-config runs "
        f"{time.perf_counter() - t0:.1f}s")
    return paths, stats


# ---------------------------------------------------------------------------
# [fed-lm]: federated LM fine-tuning on the dense family (PR 20)
# ---------------------------------------------------------------------------

# tests/test_golden.py's fed-lm world, the constants of
# tests/golden/fed-lm-smoke.json
FEDLM_WORLD = dict(model="fed-lm-smoke", samples=240, alpha=0.3, clients=6,
                   seed=0, seq=16)
FEDLM_SIM = dict(num_clients=6, horizon=6_000.0, eval_every=3_000.0, seed=0,
                 local_epochs=2, batch_size=8)
FEDLM_POLICIES = ("fedasync", "fedpsa")
# grad_and_fisher: one gradient pass and PSAConfig.fisher_microbatches (4)
# passes, each a forward and a backward, per sketched tree or wave
SKETCH_PASSES = 1 + 4
# the attention shapes (B, S, H, Hkv, hd): a cohort wave of the golden world
# (4 members x 8 sequences of 16 tokens, f32) and the full-width training
# step (2 x 2,048 tokens of phi4-mini-3.8b, bf16)
FEDLM_ATTN = (32, 16, 2, 2, 8)
FULL_ATTN = (2, 2048, 24, 8, 128)
# the bf16 backward's edges (B, Sq, Sk, H, Hkv, hd, causal): both hd
# buckets of the tensor-core kernels (hd 16, 64, 80, 96, 128), GQA and MHA,
# causal and not, Sq != Sk, ragged tiles, the full width's heads at S =
# 256; hd 256 on the CUDA-core kernels
FEDLM_BWD_EDGES = ((2, 64, 64, 4, 2, 16, True), (2, 70, 70, 4, 4, 64, False),
                   (2, 40, 72, 6, 2, 64, True), (1, 100, 70, 4, 2, 128, False),
                   (1, 33, 50, 4, 2, 128, True), (1, 200, 200, 8, 2, 80, True),
                   (1, 300, 260, 6, 3, 96, False),
                   (2, 256, 256, 24, 8, 128, True),
                   (1, 65, 65, 2, 1, 256, True))
# full width: phi4-mini-3.8b's local SGD, 4 sequences of 2,048, batch 2,
# one epoch: 2 steps
FULL_LM = dict(arch="phi4-mini-3.8b", seqs=4, seq=2048, batch=2, lr=1e-3,
               seed=0)
# the windowed fed-lm run: fed-lm-smoke with a window of 8 on the golden's
# world (sequences of 16 tokens), against the reference's digests
FEDLM_WINDOW = 8
# the windowed backward (B, Sq, Sk, H, Hkv, hd, causal, window, dtype): the
# tensor-core kernels at the long-context and full-width shapes and at
# edges (a window below a tile, Sq < Sk, causal=False, hd 80, MHA); the
# CUDA-core kernels in f32 (the windowed fed-lm run's wave shape, window
# 8, among them) and in bf16 at hd 256; and FA_WINDOW_SHAPES' two
# causal=False shapes in both dtypes, the second with rows that see no key
# (their gradient: dv += do / Sk, nothing to dq or dk)
FEDLM_BWD_WINDOW = (FA_WINDOW + ("bfloat16",),
                    (2, 2048, 2048, 24, 8, 128, True, 512, "bfloat16"),
                    (2, 300, 300, 8, 2, 64, True, 17, "bfloat16"),
                    (1, 200, 320, 6, 2, 128, True, 100, "bfloat16"),
                    (2, 333, 333, 6, 3, 128, False, 129, "bfloat16"),
                    (1, 300, 300, 4, 4, 80, True, 200, "bfloat16"),
                    (32, 16, 16, 2, 2, 8, True, FEDLM_WINDOW, "float32"),
                    (2, 300, 300, 4, 2, 64, True, 77, "float32"),
                    (2, 200, 320, 4, 2, 32, False, 60, "float32"),
                    (1, 200, 200, 2, 1, 256, True, 50, "bfloat16"),
                    (2, 333, 333, 6, 3, 128, False, 129, "float32"),
                    (1, 400, 200, 4, 2, 64, False, 50, "float32"),
                    (1, 400, 200, 4, 2, 64, False, 50, "bfloat16"))
FEDLM_WINDOW_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                                    "fed_lm_window8_digests.json")
# the reference's run_sweep lanes of the fed-lm world (tests/
# test_torch_sweep_fedlm.py), without and with the window
FEDLM_SWEEP_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                                   "fed_lm_sweep_digests.json")
# the other five policies' reference runs on the fed-lm world at horizon
# 3,000 (tests/test_torch_fedlm_policies.py)
FEDLM_POLICY_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                                    "fed_lm_policies_digests.json")
FEDLM_POLICY_RUNS = (("fedbuff", "l2"), ("ca2fl", "l2"), ("fedfa", "l2"),
                     ("fedpac", "l2"), ("asyncfeded", "l2"),
                     ("asyncfeded", "cosine"), ("asyncfeded", "sketch"))


def _fedlm_attn_inputs(torch, rng, dev, shape, dt):
    B, S, H, Hkv, hd = shape
    q, do = (_rand(torch, rng, (B, S, H, hd), dev).to(dt) for _ in range(2))
    k, v = (_rand(torch, rng, (B, S, Hkv, hd), dev).to(dt) for _ in range(2))
    return q, k, v, do


def _fedlm_bwd_bound(shape) -> tuple:
    """(bf16 tensor-core bound ms, fp32 CUDA-core bound ms, bytes bound ms,
    FLOP, bytes) of the causal backward at ``shape`` in bf16: five products
    of 2 hd FLOP per unmasked pair and head; q, k, v, o, dO read and dq, dk,
    dv written once (and the lse read)."""
    B, S, H, Hkv, hd = shape
    flops = 5 * 2 * hd * _causal_pairs(S, S) * B * H
    bytes_ = 2 * (4 * B * S * H * hd + 4 * B * S * Hkv * hd) + 4 * B * H * S
    return (flops / BF16_TC_FLOPS_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3,
            bytes_ / HBM_BYTES_PER_S * 1e3, flops, bytes_)


def _bwd_plain_by_kv(torch, fa, q, k, v, o, do, lse, causal: bool, window,
                     **kw):
    """flash_attention_bwd_plain one kv head (with its group of query
    heads, whose dK and dV sums it holds) at a time: (dq, dk, dv)
    concatenated over the heads, with one group's scores alive at once."""
    G = q.shape[2] // k.shape[2]
    parts = []
    for h in range(k.shape[2]):
        g = slice(h * G, (h + 1) * G)
        parts.append(fa.flash_attention_bwd_plain(
            q[:, :, g], k[:, :, h:h + 1], v[:, :, h:h + 1], o[:, :, g],
            do[:, :, g], lse[:, g], causal, window=window, **kw))
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


def _bwd_check(torch, fa, q, k, v, o, do, lse, causal: bool,
               window=None) -> dict:
    """One backward on the card against its plain version (one kv head at a
    time): f32 within 2e-5 x max(1, max|plain|); bf16 elementwise against
    the float64 backward of the same inputs, within the limit of its route
    (``bwd_bf16_tc_limit`` on the tensor cores, ``bwd_bf16_limit`` on the
    CUDA cores; the former's share of the latter printed as well). A second
    run with a strided dO must give the same bits."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    dos = do.transpose(1, 2).contiguous().transpose(1, 2)
    again = fa.flash_attention_bwd(q, k, v, o, dos, lse, causal, window)
    torch.cuda.synchronize()
    r = {"same": all(torch.equal(a, b) for a, b in zip(got, again)),
         "route": fa.bwd_route(q.dtype, hd),
         "finite": all(bool(torch.isfinite(a).all()) for a in got)}
    del again
    plain = _bwd_plain_by_kv(torch, fa, q, k, v, o, do, lse, causal, window)
    r["errs"] = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(got, plain)]
    if q.dtype == torch.float32:
        tols = [2e-5 * max(1.0, float(b.abs().max())) for b in plain]
        r["share"] = max(e / t for e, t in zip(r["errs"], tols))
        r["note"] = f"tol 2e-5 x max(1, max|plain|): {r['share']:.3f} of it"
        return r
    del plain
    ref = _bwd_plain_by_kv(torch, fa, q, k, v, o, do, lse, causal, window,
                           dtype=torch.float64)
    absref = _bwd_plain_by_kv(torch, fa, q, k, v, o, do, lse, causal, window,
                              dtype=torch.float64, absolute=True)
    gate = (fa.bwd_bf16_tc_limit if r["route"] == "tc"
            else fa.bwd_bf16_limit)
    shares, old, errs64 = [], [], []
    for a, rf, ab, n in zip(got, ref, absref, (Sk, G * Sq, G * Sq)):
        err = (a.double() - rf).abs()
        errs64.append(float(err.max()))
        for out, lim in ((shares, gate), (old, fa.bwd_bf16_limit)):
            out.append(float(torch.where(err == 0, 0.0,
                                         err / lim(rf, ab, n, hd)).max()))
        del err
    r["share"], r["old_share"] = max(shares), max(old)
    r["note"] = (f"vs float64 max|err| dq/dk/dv {errs64[0]:.3e}/"
                 f"{errs64[1]:.3e}/{errs64[2]:.3e}, worst element at "
                 f"{r['share']:.3f} of {gate.__name__} (dq/dk/dv "
                 f"{shares[0]:.3f}/{shares[1]:.3f}/{shares[2]:.3f}); "
                 f"{r['old_share']:.3f} of bwd_bf16_limit")
    return r


def phase_fedlm_kernels(torch, dev) -> dict:
    """The attention backward kernels and the forward's lse on the card:
    f32 at the golden world's wave shape against the plain backward (2e-5 x
    max(1, max|plain|)); bf16 at the full-width shape and at the edge
    shapes ``FEDLM_BWD_EDGES`` against the float64 backward of the same
    inputs, elementwise within the limit of the route (``_bwd_check``);
    the lse against the plain forward's (2e-5 x max(1, max|lse|));
    repeated runs bit-equal; the tensor-core kernels' registers, spill
    bytes (none allowed) and shared memory from the runtime. Then the
    time of the full-width backward (L2 flushed) beside the plain
    backward's, the CUDA-core kernels' on the same bf16 inputs (the
    route f32 and hd 256 take) and the autograd backward of ``F.scaled_dot_product_attention``
    (a yardstick the port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(20)
    out = {}
    for shape, dt in ((FEDLM_ATTN, torch.float32), (FULL_ATTN, torch.bfloat16)):
        B, S, H, Hkv, hd = shape
        q, k, v, do = _fedlm_attn_inputs(torch, rng, dev, shape, dt)
        o, lse = fa._forward(q, k, v, True, with_lse=True)
        _, lse_p = fa._plain_forward(q, k, v, True)
        lse_err = float((lse - lse_p).abs().max())
        lse_tol = 2e-5 * max(1.0, float(lse_p.abs().max()))
        r = _bwd_check(torch, fa, q, k, v, o, do, lse, True)
        what = f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal {str(dt)[6:]}"
        log(f"[fed-lm] flash_attention_bwd {what} ({r['route']}): vs plain "
            f"max|err| dq/dk/dv {r['errs'][0]:.3e}/{r['errs'][1]:.3e}/"
            f"{r['errs'][2]:.3e}; {r['note']}; repeated run (strided dO) "
            f"bit-equal {r['same']}; forward lse max|err| {lse_err:.3e} "
            f"(tol {lse_tol:.3e})")
        if not (r["share"] <= 1.0 and r["same"] and r["finite"]
                and lse_err <= lse_tol):
            raise AssertionError(f"flash_attention_bwd {what}: {r}, lse "
                                 f"{lse_err}")
        out["f32" if dt == torch.float32 else "bf16"] = {
            "max_abs_err": max(r["errs"]), "share": r["share"],
            "old_share": r.get("old_share"), "lse_err": lse_err}
        del q, k, v, do, o, lse, lse_p
    worst = 0.0
    for B, Sq, Sk, H, Hkv, hd, causal in FEDLM_BWD_EDGES:
        q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(torch.bfloat16)
                for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, with_lse=True)
        r = _bwd_check(torch, fa, q, k, v, o, do, lse, causal)
        what = (f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} "
                f"{'causal' if causal else 'full'} bf16")
        log(f"[fed-lm] flash_attention_bwd {what} ({r['route']}): "
            f"{r['note']}; bit-equal {r['same']}")
        if not (r["share"] <= 1.0 and r["same"] and r["finite"]):
            raise AssertionError(f"flash_attention_bwd {what}: {r}")
        worst = max(worst, r["share"])
    out["edges_worst_share"] = worst
    out["window"] = _fedlm_window_kernels(torch, dev, rng)
    # read from the runtime after the launches above set the attributes
    attrs = {hd: fa.bwd_tc_attributes(hd) for hd in (64, 128)}
    for hd, at in attrs.items():
        log(f"[fed-lm] tensor-core backward, hd bucket {hd}: " + "; ".join(
            f"{n} {a['registers']} registers, {a['local_bytes']} bytes "
            f"local a thread, {a['max_dynamic_smem_bytes']} bytes dynamic "
            f"shared memory" for n, a in at.items()))
        if any(a["local_bytes"] for a in at.values()):
            raise AssertionError(f"tensor-core backward spills at hd {hd}: "
                                 f"{at}")
    # timing at the full-width shape, bf16
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    q, k, v, do = _fedlm_attn_inputs(torch, rng, dev, FULL_ATTN, torch.bfloat16)
    o, lse = fa._forward(q, k, v, True, with_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    bf, b32, bb, flops, bytes_ = _fedlm_bwd_bound(FULL_ATTN)
    B, S, H, Hkv, hd = FULL_ATTN
    r = dict(
        shape=f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal bf16",
        ms=_time_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                          True), 20, flush),
        plain_ms=_time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, do, lse, True), 5, flush),
        cuda_core_ms=_time_ms(torch, lambda: fa._bwd_cuda(
            q, k, v, o, do, lse, True, "cuda_core"), 3, flush),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 20, flush),
        bound_ms=max(bf, bb), bound_by="operations" if bf >= bb else "bytes",
        fp32_bound_ms=b32, flops=flops, bytes=bytes_)
    at = attrs[128]
    r["design"] = "; ".join(
        f"{n}: {a['max_dynamic_smem_bytes']} bytes dynamic smem, "
        f"{a['registers']} registers, {a['local_bytes']} bytes local a "
        f"thread (cudaFuncGetAttributes); "
        f"{_ptxas('flash_attention_bwd', f'bwd_{n}_tcILi128E')}"
        for n, a in at.items())
    log(f"[timing] flash_attention_bwd {r['shape']}: tensor-core kernels "
        f"{r['ms'] * 1e3:.1f}us, the CUDA-core kernels on the same inputs "
        f"{r['cuda_core_ms'] * 1e3:.1f}us, plain {r['plain_ms'] * 1e3:.1f}us, "
        f"library (SDPA backward) {r['library_ms'] * 1e3:.1f}us; "
        f"{flops:.4e} FLOP, {bytes_ / 1e6:.1f} MB: bound {bf * 1e3:.1f}us at "
        f"the bf16 tensor-core peak ({100 * bf / r['ms']:.2f}% of it), "
        f"{b32 * 1e3:.1f}us at the fp32 peak, {bb * 1e3:.1f}us by bytes; "
        f"{r['design']}")
    if not r["ms"] < b32:
        raise AssertionError(f"tensor-core backward {r['ms']} ms is not below"
                             f" the fp32 CUDA-core bound {b32} ms")
    del q, k, v, do, o, lse, qt, kt, vt, ot, dot
    out["timing"] = r
    out["window_timing"] = _time_bwd_window(torch, dev, rng, flush)
    out["empty_rows_timing"] = _time_bwd_empty_rows(torch, dev, rng, flush)
    return out


# the backward with rows that see no key (FA_WINDOW_SHAPES' last shape)
FA_EMPTY_ROWS = (1, 400, 200, 4, 2, 64, False, 50)


def _time_bwd_empty_rows(torch, dev, rng, flush) -> list:
    """The backward at ``FA_EMPTY_ROWS`` in bf16 (the tensor-core kernels)
    and f32 (the CUDA-core kernels), each with its third kernel for the
    empty rows' dv, beside the plain backward. Bound: five products of
    2 hd FLOP per band pair at the dtype's peak, or the bytes (q, k, v, o,
    dO and the lse read once, dq, dk, dv written once). No library yardstick:
    SDPA gives NaN on a row whose mask is all False."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, Hkv, hd, causal, W = FA_EMPTY_ROWS
    pairs = B * H * _band_pairs(Sq, Sk, causal, W)
    out = []
    for dt, peak in ((torch.bfloat16, BF16_TC_FLOPS_PER_S),
                     (torch.float32, FP32_FLOPS_PER_S)):
        q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
                 for _ in range(2))
        k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
                for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, True, W)
        el = q.element_size()
        bytes_ = (el * (3 * B * Sq * H * hd + 4 * B * Sk * Hkv * hd
                        + B * Sq * H * hd) + 4 * B * H * Sq)
        o_ms = 10 * hd * pairs / peak * 1e3
        b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        r = dict(shape=f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} full "
                       f"window={W} {str(dt).split('.')[-1]} (rows from "
                       f"{Sk + W - 1} see no key)",
                 route=fa.bwd_route(dt, hd),
                 ms=_time_ms(torch, lambda: fa.flash_attention_bwd(
                     q, k, v, o, do, lse, causal, W), 20, flush),
                 plain_ms=_time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                     q, k, v, o, do, lse, causal, window=W), 5, flush),
                 library_ms=None, bound_ms=max(o_ms, b_ms),
                 bound_by="operations" if o_ms >= b_ms else "bytes",
                 pairs=pairs)
        log(f"[timing] flash_attention_bwd {r['shape']} ({r['route']}): "
            f"{r['ms'] * 1e3:.1f}us, plain {r['plain_ms'] * 1e3:.1f}us; bound "
            f"{r['bound_ms'] * 1e3:.2f}us by {r['bound_by']} "
            f"({100 * r['bound_ms'] / r['ms']:.2f}% of it); no library call "
            f"(SDPA gives NaN on a row with no key)")
        out.append(r)
        del q, k, v, do, o, lse
    return out


def _fedlm_window_kernels(torch, dev, rng) -> dict:
    """The windowed backward at ``FEDLM_BWD_WINDOW`` through ``_bwd_check``
    (each route's limit; repeats bit-equal), and the windowed forward's lse
    against the plain forward's (2e-5 x max(1, max|lse|)). Returns the worst
    share of each dtype's limit."""
    from repro_torch.kernels import flash_attention as fa
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for B, Sq, Sk, H, Hkv, hd, causal, W, dts in FEDLM_BWD_WINDOW:
        dt = getattr(torch, dts)
        q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
                 for _ in range(2))
        k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
                for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, True, W)
        G = H // Hkv
        lse_p = torch.cat([fa._plain_forward(
            q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
            causal, W)[1] for h in range(Hkv)], dim=1)
        # the rows that see a key (a row that sees none has lse -1e30)
        seen = slice(0, Sk + W - 1 if fa.has_empty_rows(Sq, Sk, W) else Sq)
        lse_err = float((lse - lse_p)[..., seen].abs().max())
        lse_tol = 2e-5 * max(1.0, float(lse_p[..., seen].abs().max()))
        del lse_p
        r = _bwd_check(torch, fa, q, k, v, o, do, lse, causal, W)
        what = (f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} "
                f"{'causal' if causal else 'full'} window={W} {dts}"
                + (" (rows from Sk + window - 1 see no key)"
                   if fa.has_empty_rows(Sq, Sk, W) else ""))
        log(f"[fed-lm] flash_attention_bwd window {what} ({r['route']}): "
            f"vs plain max|err| dq/dk/dv {r['errs'][0]:.3e}/"
            f"{r['errs'][1]:.3e}/{r['errs'][2]:.3e}; {r['note']}; repeat "
            f"(strided dO) bit-equal {r['same']}; forward lse max|err| "
            f"{lse_err:.3e} (tol {lse_tol:.3e})")
        if not (r["share"] <= 1.0 and r["same"] and r["finite"]
                and lse_err <= lse_tol):
            raise AssertionError(f"flash_attention_bwd window {what}: {r}, "
                                 f"lse {lse_err}")
        worst[dts] = max(worst[dts], r["share"])
        del q, k, v, do, o, lse
    return worst


def _time_bwd_window(torch, dev, rng, flush) -> dict:
    """The windowed backward at ``FA_WINDOW`` in bf16 (the tensor-core
    kernels) beside the unwindowed causal backward on the same inputs, the
    plain backward (one kv head at a time) and the autograd backward of
    SDPA with the band as a boolean mask (k and v repeated to the query
    heads); bound: five products of 2 hd FLOP per band pair at the bf16
    tensor-core peak, or the bytes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, Hkv, hd, causal, W = FA_WINDOW
    dt = torch.bfloat16
    q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(dt) for _ in range(2))
    k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt) for _ in range(2))
    o, lse = fa._forward(q, k, v, causal, True, W)
    of, lsef = fa._forward(q, k, v, causal, True)
    pairs = B * H * _band_pairs(Sq, Sk, causal, W)
    full_pairs = B * H * _band_pairs(Sq, Sk, causal, None)
    bytes_ = 2 * (4 * B * Sq * H * hd + 4 * B * Sk * Hkv * hd) + 4 * B * H * Sq
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms, full_o_ms = (10 * hd * n / BF16_TC_FLOPS_PER_S * 1e3
                       for n in (pairs, full_pairs))
    G = H // Hkv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (torch.repeat_interleave(x, G, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for x in (k, v))
    mask = fa.band_mask(Sq, Sk, causal, W, dev)
    try:
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_ms, why = _sdpa_or_none(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 5,
            flush)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        lib_ms, why = None, str(e).splitlines()[0][:160]
    ot = None
    torch.cuda.empty_cache()
    r = dict(
        shape=f"B={B} S={Sq} H={H} Hkv={Hkv} hd={hd} causal window={W} bf16",
        ms=_time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, do, lse, causal, W), 10, flush),
        unwindowed_ms=_time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, of, do, lsef, causal), 10, flush),
        plain_ms=_time_ms(torch, lambda: _bwd_plain_by_kv(
            torch, fa, q, k, v, o, do, lse, causal, W), 2, flush),
        library_ms=lib_ms,
        library_note=(f"SDPA backward with the band's boolean mask: {why}"
                      if why else "SDPA backward with the band's boolean "
                      "mask"),
        bound_ms=max(o_ms, b_ms),
        bound_by="operations" if o_ms >= b_ms else "bytes",
        unwindowed_bound_ms=max(full_o_ms, b_ms), pairs=pairs,
        unwindowed_pairs=full_pairs, pair_ratio=pairs / full_pairs)
    r["time_ratio"] = r["ms"] / r["unwindowed_ms"]
    log(f"[timing] flash_attention_bwd window {r['shape']}: windowed "
        f"{r['ms'] * 1e3:.1f}us, unwindowed causal "
        f"{r['unwindowed_ms'] * 1e3:.1f}us (time ratio {r['time_ratio']:.4f},"
        f" pair ratio {r['pair_ratio']:.4f}), plain "
        f"{r['plain_ms'] * 1e3:.1f}us; bounds {r['bound_ms'] * 1e3:.1f}us and "
        f"{r['unwindowed_bound_ms'] * 1e3:.1f}us at the bf16 tensor-core peak "
        f"({100 * r['bound_ms'] / r['ms']:.2f}% and "
        f"{100 * r['unwindowed_bound_ms'] / r['unwindowed_ms']:.2f}% of "
        f"them); {r['library_note']}"
        + ("" if lib_ms is None else f" {lib_ms * 1e3:.1f}us"))
    del q, k, v, do, o, lse, of, lsef, qt, kt, vt, mask
    return r


def _fedlm_world():
    from repro_torch.convert import load_npz_params
    from repro_torch.launch.train import build_task
    W = FEDLM_WORLD
    cfg, clients, test, calib = build_task(W["model"], W["samples"],
                                           W["alpha"], W["clients"],
                                           W["seed"], seq_len=W["seq"])
    params = load_npz_params(os.path.join(
        ROOT, "tests", "torch_fixtures", "fed_lm_smoke_init_seed0.npz"))
    return cfg, clients, test, calib, params


def _fedlm_want(name: str, res, cfg, grouped: bool, metric: str = "l2"
                ) -> dict:
    """Exact launch counts of a fed-lm run or sweep (``res`` a
    ``SimResult`` or a ``SweepResult``, whose lanes share its waves):
    per layer, flash_attention's forward once a local step (a cohort wave's
    step counts once: its members, of every lane, share the launch), once
    an eval batch of each lane and once a FedPSA sketch pass, and its
    backward once a step and a sketch pass; ``buffer_agg`` and
    ``sens_sketch`` as ``_want_launches`` (one lane) or
    ``_want_sweep_launches`` (S lanes) count them, each FedPSA sketch
    ``SKETCH_PASSES`` LM passes, asyncfeded's ``sketch`` none;
    ``grouped_matmul`` (cohort under "grouped") forward, dx and dW of each
    of ``_member_dots`` products, each local step (the sketch's products
    run unrouted). "Per layer" counts the attention layers."""
    from repro_torch.federated.simulator import SimConfig
    L = cfg.num_superblocks * cfg.block_pattern.count("attn")
    lanes = getattr(res, "num_lanes", 1)
    base = (_want_sweep_launches(name, metric, res)
            if hasattr(res, "num_lanes") else
            _want_launches(name, metric, res))
    evals = len(res.times) * SimConfig().eval_batches * lanes
    passes = SKETCH_PASSES * base["sens_sketch"] if name == "fedpsa" else 0
    return {**base,
            "flash_attention": L * (res.local_steps + evals + passes),
            "flash_attention_bwd": L * (res.local_steps + passes),
            "grouped_matmul": (3 * _member_dots(cfg) * res.local_steps
                               if grouped else 0)}


def _member_dots(cfg) -> int:
    """``member_dot`` sites of one LM forward: each layer's products
    (attention q, k, v, o; a dense FFN's three, two without a gate; an
    MoE's router, and its shared experts' FFN; mamba's two projections,
    mLSTM's six, sLSTM's three) and the cross-entropy's unembedding."""
    ffn = 3 if cfg.ffn_act == "swiglu" else 2
    moe = 1 + (ffn if cfg.num_shared_experts else 0)
    mix = {"attn": 4, "mamba": 2, "mlstm": 6, "slstm": 3}
    kind = {"dense": ffn, "moe": moe, "moe+dense": moe + ffn, "none": 0}
    return cfg.num_superblocks * sum(
        mix[m] + kind[f] for m, f in zip(cfg.block_pattern, cfg.ffn_pattern)) + 1


def _fedlm_ref(res, counts: dict, wall: float, golden: dict) -> dict:
    """A single-device fed-lm run as ``[mesh]`` holds a mesh run to it, with
    the digests and counters of the file that the run holds (``golden``)."""
    return {**_run_ref(res, counts, wall), "local_steps": res.local_steps,
            "file_digests": golden["digests"],
            "file_final": {k: golden["final"][k] for k in (
                "versions", "dispatches", "dropped", "launched")}}


def phase_fedlm(torch, smi: str) -> tuple:
    """The fed-lm world on the card: fedasync and fedpsa on the sequential
    engine and on the cohort engine with both member kernels against
    ``tests/golden/fed-lm-smoke.json`` (RTOL/ATOL; counters and launch
    counts exact), fedpsa cohort/grouped again (bit-equal digests), and the
    train CLI (``python -m repro_torch.launch.train --arch fed-lm-smoke
    --seq 16``'s ``main``) as a user runs it. Returns launch counts by
    path, and the cohort/grouped runs by (policy, window 0): the
    references of the sweeps and of ``[mesh]``."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    cfg, clients, test, calib, params = _fedlm_world()
    with open(os.path.join(ROOT, "tests", "golden", "fed-lm-smoke.json")) as fh:
        golden = json.load(fh)["policies"]
    paths, digests, refs = {}, {}, {}
    runs = [(n, e, mk) for n in FEDLM_POLICIES for e, mk in ENGINE_SETTINGS]
    for name, engine, mk in runs + [("fedpsa", "cohort", "grouped")]:
        what = f"fed-lm {name} {engine}/{mk}"
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        sim = SimConfig(engine=engine, member_kernel=mk, device="cuda",
                        record_trajectory=True, **FEDLM_SIM)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_algorithm(name, cfg, params, clients, test, sim, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        g = golden[name]
        got, want = np.asarray(res.digests), np.asarray(g["digests"])
        if got.shape != want.shape or res.engine != engine:
            raise AssertionError(f"{what}: {got.shape} != {want.shape} "
                                 f"({res.engine})")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for key in ("versions", "dispatches", "dropped", "launched"):
            if getattr(res, key) != g["final"][key]:
                raise AssertionError(f"{what}: {key} {getattr(res, key)} != "
                                     f"{g['final'][key]}")
        np.testing.assert_allclose(res.final_accuracy,
                                   g["final"]["final_accuracy"], atol=2e-3)
        np.testing.assert_allclose(res.aulc, g["final"]["aulc"], atol=2e-3)
        want_counts = _fedlm_want(name, res, cfg, mk == "grouped"
                                  and engine == "cohort")
        if counts != want_counts:
            raise AssertionError(f"{what}: launches {counts} != {want_counts}")
        rel = float(np.max(np.abs(got - want) / (np.abs(want) + ATOL / RTOL)))
        key = (name, engine, mk)
        if key in digests:
            same = (np.array_equal(got, digests[key][0])
                    and res.accuracies == digests[key][1])
            log(f"[fed-lm] {name} {engine}/{mk} again: digests and accuracies "
                f"bit-equal {same}")
            if not same:
                raise AssertionError(f"{what}: a repeated run differs")
            continue
        digests[key] = (got, res.accuracies)
        if (engine, mk) == ("cohort", "grouped"):
            refs[name, 0] = _fedlm_ref(res, counts, wall, g)
        paths[f"fed-lm-{name}-{engine}-{mk}"] = counts
        log(f"[fed-lm] {name} {engine}/{mk}: {len(got)} digests match (max rel "
            f"{rel:.2e}), local steps {res.local_steps}, cohorts={res.cohorts} "
            f"versions={res.versions} dispatches={res.dispatches} "
            f"final={res.final_accuracy:.4f} aulc={res.aulc:.4f} "
            f"{wall:.2f}s ({wall / res.dispatches:.4f} s/receive) "
            f"launches={counts}")
    # the main path as a user runs it: the train CLI
    out = os.path.join(ROOT, "build", "chip_smoke_fedlm")
    W = FEDLM_WORLD
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.main(["--arch", W["model"], "--seq", str(W["seq"]),
                      "--alg", "fedpsa", "--samples", str(W["samples"]),
                      "--clients", str(W["clients"]), "--alpha",
                      str(W["alpha"]), "--horizon", "6000", "--device",
                      "cuda", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_counts = _fedlm_want("fedpsa", res, cfg, False)
    if counts != want_counts or not 0.0 <= res.final_accuracy <= 1.0:
        raise AssertionError(f"fed-lm train CLI: launches {counts} != "
                             f"{want_counts}, final {res.final_accuracy}")
    paths["fed-lm-train-cli"] = counts
    log(f"[fed-lm] train CLI --arch {W['model']} --seq {W['seq']} --alg fedpsa "
        f"(cohort/vmap): final={res.final_accuracy:.4f} "
        f"aulc={res.aulc:.4f} dispatches={res.dispatches} "
        f"local steps {res.local_steps}, {wall:.2f}s, launches={counts} on "
        f"{smi}")
    return paths, refs


def phase_fedlm_window(torch, smi: str) -> tuple:
    """The fed-lm world with a sliding window of 8 (its sequences are 16
    tokens, so the window bites): fedasync and fedpsa on the cohort engine
    under ``member_kernel="grouped"`` against the reference's runs in
    ``FEDLM_WINDOW_FIXTURE`` (RTOL/ATOL on the digests, accuracies within
    2e-3, counters exact), with exact launch counts (``_fedlm_want``: every
    attention launch is windowed). Returns launch counts by path and the
    runs by (policy, window), as ``phase_fedlm``."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    cfg, clients, test, calib, params = _fedlm_world()
    cfg = dataclasses.replace(cfg, sliding_window=FEDLM_WINDOW)
    with open(FEDLM_WINDOW_FIXTURE) as fh:
        fixture = json.load(fh)
    if fixture["sliding_window"] != FEDLM_WINDOW:
        raise AssertionError(f"fixture window {fixture['sliding_window']}")
    paths, refs = {}, {}
    for name in FEDLM_POLICIES:
        what = f"fed-lm window={FEDLM_WINDOW} {name} cohort/grouped"
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        sim = SimConfig(engine="cohort", member_kernel="grouped",
                        device="cuda", record_trajectory=True, **FEDLM_SIM)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_algorithm(name, cfg, params, clients, test, sim, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = fixture["policies"][name]
        got, exp = np.asarray(res.digests), np.asarray(want["digests"])
        if got.shape != exp.shape:
            raise AssertionError(f"{what}: {got.shape} != {exp.shape}")
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res.accuracies, want["accuracies"],
                                   atol=2e-3)
        for key in ("versions", "dispatches", "dropped", "launched"):
            if getattr(res, key) != want["final"][key]:
                raise AssertionError(f"{what}: {key} {getattr(res, key)} != "
                                     f"{want['final'][key]}")
        want_counts = _fedlm_want(name, res, cfg, True)
        if counts != want_counts:
            raise AssertionError(f"{what}: launches {counts} != {want_counts}")
        rel = float(np.max(np.abs(got - exp) / (np.abs(exp) + ATOL / RTOL)))
        paths[f"fed-lm-window{FEDLM_WINDOW}-{name}-cohort-grouped"] = counts
        refs[name, FEDLM_WINDOW] = _fedlm_ref(res, counts, wall, want)
        log(f"[fed-lm] {what}: {len(got)} digests match the reference's "
            f"(max rel {rel:.2e}), local steps {res.local_steps}, "
            f"versions={res.versions} final={res.final_accuracy:.4f} "
            f"{wall:.2f}s, launches={counts} on {smi}")
    return paths, refs


# the fed-lm sweeps on the card as (policy, member kernel, window): each
# member kernel once (the CPU tests sweep both policies under both)
FEDLM_SWEEPS = (("fedasync", "vmap", 0), ("fedpsa", "grouped", 0),
                ("fedpsa", "grouped", FEDLM_WINDOW))


def phase_fedlm_sweeps(torch, smi: str, refs: dict) -> dict:
    """3-lane ``run_sweep``s of the fed-lm world (data seeds [0, 0, 1234],
    ``SWEEP_HYPER`` on lane 1), ``FEDLM_SWEEPS``: fedasync under "vmap",
    fedpsa under "grouped", and fedpsa under "grouped" once more with a
    window of 8. Lane 0
    holds the golden (the window fixture with the window), every lane the
    reference's ``run_sweep`` lane (``FEDLM_SWEEP_FIXTURE``), at
    RTOL/ATOL with times and counters exact; launch counts exact
    (``_fedlm_want`` over S lanes: ``buffer_agg`` S x versions,
    ``sens_sketch`` waves + S x (versions + 1) for fedpsa), with the local
    steps and ``grouped_matmul`` of the standalone cohort/grouped run in
    ``refs`` (the same waves). Returns launch counts by path."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import SimConfig, SweepConfig, run_sweep
    from repro_torch.kernels import ops
    cfg0, clients, test, calib, params = _fedlm_world()
    with open(FEDLM_SWEEP_FIXTURE) as fh:
        fixture = json.load(fh)
    if fixture["sim"] != FEDLM_SIM or fixture["data_seeds"] != SWEEP_SEEDS:
        raise AssertionError(f"sweep fixture for {fixture['sim']}, "
                             f"{fixture['data_seeds']}")
    with open(os.path.join(ROOT, "tests", "golden", "fed-lm-smoke.json")) as fh:
        golden = json.load(fh)["policies"]
    with open(FEDLM_WINDOW_FIXTURE) as fh:
        windowed = json.load(fh)["policies"]
    paths = {}
    for name, mk, window in FEDLM_SWEEPS:
        what = f"fed-lm sweep {name} cohort/{mk} window={window}"
        cfg = dataclasses.replace(cfg0, sliding_window=window) if window \
            else cfg0
        kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
              if name == "fedpsa" else {})
        sweep = SweepConfig(data_seeds=SWEEP_SEEDS,
                            policy_params=[None, SWEEP_HYPER[name], None])
        sim = SimConfig(engine="cohort", member_kernel=mk, device="cuda",
                        record_trajectory=True, **FEDLM_SIM)
        res, wall, mem, counts = _timed_run(torch, lambda: run_sweep(
            name, cfg, params, clients, test, sim, sweep, **kw))
        one = (windowed if window else golden)[name]
        np.testing.assert_allclose(np.asarray(res.digests[0]),
                                   np.asarray(one["digests"]), rtol=RTOL,
                                   atol=ATOL)
        lanes = fixture["sweeps"][f"{name}/w{window}"]
        if res.times != lanes["times"]:
            raise AssertionError(f"{what}: times {res.times} != "
                                 f"{lanes['times']}")
        for key in ("versions", "dispatches", "dropped", "launched",
                    "cohorts"):
            if getattr(res, key) != lanes["final"][key] or (
                    key in one["final"]
                    and getattr(res, key) != one["final"][key]):
                raise AssertionError(f"{what}: {key} {getattr(res, key)}")
        rel = []
        for s in range(res.num_lanes):
            got, want = (np.asarray(res.digests[s]),
                         np.asarray(lanes["digests"][s]))
            if got.shape != want.shape:
                raise AssertionError(f"{what}: lane {s} {got.shape} != "
                                     f"{want.shape}")
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(res.lane_accuracies[s],
                                       lanes["lane_accuracies"][s], atol=2e-3)
            rel.append(float(np.max(np.abs(got - want)
                                    / (np.abs(want) + ATOL / RTOL))))
        solo = refs[name, window]
        if res.local_steps != solo["local_steps"]:
            raise AssertionError(f"{what}: local steps {res.local_steps} != "
                                 f"the standalone run's {solo['local_steps']}")
        want_counts = _fedlm_want(name, res, cfg, mk == "grouped")
        if mk == "grouped" and \
                want_counts["grouped_matmul"] != solo["counts"]["grouped_matmul"]:
            raise AssertionError(f"{what}: grouped_matmul "
                                 f"{want_counts['grouped_matmul']} != the "
                                 f"standalone run's "
                                 f"{solo['counts']['grouped_matmul']}")
        if counts != want_counts:
            raise AssertionError(f"{what}: launches {counts} != "
                                 f"{want_counts}")
        paths[f"fed-lm-sweep-{name}-{mk}-w{window}"] = counts
        log(f"[fed-lm] {what} 3 lanes: lane 0 holds the "
            f"{'window fixture' if window else 'golden'}, lanes vs the "
            f"reference's max rel {[f'{r:.2e}' for r in rel]}; "
            f"cohorts={res.cohorts} versions={res.versions} local steps "
            f"{res.local_steps} {wall:.2f}s ({wall / res.dispatches:.4f} "
            f"s/receive; one lane {solo['s_per_receive']:.4f}) {mem} "
            f"launches={counts} on {smi}")
    return paths


def phase_fedlm_policies(torch, smi: str) -> dict:
    """The other five policies on the fed-lm world (``FEDLM_POLICY_RUNS``:
    fedbuff, ca2fl, fedfa, fedpac and asyncfeded with its l2, cosine and
    sketch metrics) on cohort/grouped at the fixture's horizon (3,000)
    against the reference's runs in ``FEDLM_POLICY_FIXTURE`` (RTOL/ATOL,
    accuracies within 2e-3, counters exact), with exact launch counts
    (``_fedlm_want``). Returns launch counts by path."""
    from repro_torch.federated import SimConfig, run_algorithm
    cfg, clients, test, calib, params = _fedlm_world()
    with open(FEDLM_POLICY_FIXTURE) as fh:
        fixture = json.load(fh)
    paths = {}
    for name, metric in FEDLM_POLICY_RUNS:
        what = f"fed-lm {name}/{metric} cohort/grouped"
        want = fixture["runs"][f"{name}/{metric}"]
        kw = ({"server_kwargs": {"metric": metric}} if name == "asyncfeded"
              else {})
        sim = SimConfig(engine="cohort", member_kernel="grouped",
                        device="cuda", record_trajectory=True,
                        **fixture["sim"])
        res, wall, mem, counts = _timed_run(torch, lambda: run_algorithm(
            name, cfg, params, clients, test, sim, **kw))
        got, exp = np.asarray(res.digests), np.asarray(want["digests"])
        if got.shape != exp.shape:
            raise AssertionError(f"{what}: {got.shape} != {exp.shape}")
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res.accuracies, want["accuracies"],
                                   atol=2e-3)
        for key, val in want["final"].items():
            if key != "final_accuracy" and getattr(res, key) != val:
                raise AssertionError(f"{what}: {key} {getattr(res, key)} != "
                                     f"{val}")
        want_counts = _fedlm_want(name, res, cfg, True, metric)
        if counts != want_counts:
            raise AssertionError(f"{what}: launches {counts} != "
                                 f"{want_counts}")
        rel = float(np.max(np.abs(got - exp) / (np.abs(exp) + ATOL / RTOL)))
        paths[f"fed-lm-{name}-{metric}-cohort-grouped"] = counts
        log(f"[fed-lm] {what}: {len(got)} digests match the reference's "
            f"(max rel {rel:.2e}), versions={res.versions} local steps "
            f"{res.local_steps} {wall:.2f}s ({wall / res.dispatches:.4f} "
            f"s/receive) {mem} launches={counts} on {smi}")
    return paths


def _leaf_checksums(torch, tree) -> list:
    """Position-weighted integer checksums of each leaf's bits (equal for
    bit-equal leaves), chunked to bound the scratch memory."""
    from repro_torch.common.tree import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        bits = leaf.detach().reshape(-1).view(torch.int32)
        total = 0
        for lo in range(0, bits.numel(), 1 << 26):
            chunk = bits[lo:lo + (1 << 26)].to(torch.int64)
            pos = torch.arange(lo, lo + chunk.numel(), device=chunk.device)
            total += int(torch.sum(chunk * (pos % 1000003 + 1)))
        out.append(total)
    return out


# remat "dots" nested two levels deep: llama3-405b-smoke cut to 6 layers in
# 3 scan groups, a selective checkpoint inside a selective checkpoint
REMAT_NESTED = dict(arch="llama3-405b-smoke", num_layers=6, scan_groups=3)


def phase_fedlm_remat(torch, smi: str) -> None:
    """Remat "dots" on the card at the nested depth ``REMAT_NESTED``: the
    loss and every gradient under "none", "full" and "dots" bit-equal, for
    one model and for a wave of 3 members through ``grouped_matmul``, with
    the attention kernels' launches of each setting."""
    from repro_torch.common.tree import (FlatSpec, tree_leaves,
                                         tree_unflatten_like)
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import member_math, registry
    from repro_torch.models import model as M
    base = dataclasses.replace(get_config(REMAT_NESTED["arch"]),
                               num_layers=REMAT_NESTED["num_layers"],
                               scan_groups=REMAT_NESTED["scan_groups"])
    fam = registry.get_family(base)
    gen = torch.Generator(device="cuda").manual_seed(3)
    init = M.init_params(gen, base, "cuda")
    spec = FlatSpec(init)
    wave = torch.stack([spec.flatten(init) * (1 + 0.01 * i)
                        for i in range(3)])
    toks = torch.randint(0, base.vocab_size, (3, 2, 64), device="cuda",
                         generator=gen)
    for members in (False, True):
        got = {}
        for remat in ("none", "full", "dots"):
            cfg = dataclasses.replace(base, remat=remat)
            ops.reset_launch_counts()
            if members:
                w = wave.clone().requires_grad_(True)
                vm = torch.ones((3, 2), device="cuda")
                batch = fam.masked_batch(toks, toks.clone(), vm, vm.sum(1))
                with member_math.routing("grouped"):
                    loss = fam.client_loss(spec.unflatten(w), batch, cfg,
                                           members=True).sum()
                    grads = torch.autograd.grad(loss, [w])
            else:
                leaves = [x.detach().requires_grad_(True)
                          for x in tree_leaves(init)]
                p = tree_unflatten_like(init, leaves)
                loss = M.loss_fn(p, {"tokens": toks[0], "labels": toks[0]},
                                 cfg)
                grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            got[remat] = (loss.detach(), [g.detach() for g in grads],
                          ops.launch_counts())
        same = all(torch.equal(got[r][0], got["none"][0])
                   and all(torch.equal(a, b) for a, b in
                           zip(got[r][1], got["none"][1]))
                   for r in ("full", "dots"))
        log(f"[fed-lm] remat {REMAT_NESTED} members={members}: none, full "
            f"and dots bit-equal {same}; launches "
            f"{ {r: {k: v for k, v in c.items() if v} for r, (_, _, c) in got.items()} } "
            f"on {smi}")
        if not same:
            raise AssertionError(f"remat dots at {REMAT_NESTED}, members="
                                 f"{members}: not bit-equal to remat none")
        if got["dots"][2] != got["full"][2]:
            raise AssertionError(f"remat dots launches {got['dots'][2]} != "
                                 f"full's {got['full'][2]}")


def _full_width_update(torch, params, cfg, ds, kw: dict, profiled: bool):
    """One ``local_update`` on the card: (delta's leaf checksums, finite,
    dtypes, wall s, peak bytes, launch counts, the profile or None)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.tree import tree_leaves
    from repro_torch.federated.client import local_update
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    delta, w = local_update(params, cfg, ds, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del w
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(delta))
    dtypes = sorted({str(x.dtype) for x in tree_leaves(delta)})
    sums = _leaf_checksums(torch, delta)
    del delta
    return sums, finite, dtypes, wall, peak, counts, prof


def phase_fedlm_full(torch, dev, smi: str) -> dict:
    """The client's local SGD at full width: ``federated.client.
    local_update`` on ``phi4-mini-3.8b`` (32 layers, bf16, remat "full",
    nothing cut; random init on the card) over a token ``ClientDataset`` of
    4 sequences of 2,048 tokens from ``make_lm_corpus`` at the full vocab,
    one epoch at batch 2: two steps. Gates: per step flash_attention 2 x
    32 (the forward and remat's recompute) and its backward 32, no other
    kernel; the delta finite; a second run bit-equal (leaf checksums); in
    the second run's device-only profile, the backward's tensor-core
    kernels ``bwd_dq_tc`` and ``bwd_dkdv_tc`` once each a backward call.
    Then the same update twice under remat "dots" (JAX's
    ``dots_with_no_batch_dims_saveable``: the shared-weight products'
    outputs kept, the attention recomputed, so the same launches), the
    second profiled: bit-equal to "full". Prints seconds a step, peak
    device memory and the device's busy share of each setting."""
    from repro_torch.configs import get_config
    from repro_torch.data import (ClientDataset, SyntheticClassification,
                                  make_lm_corpus)
    from repro_torch.models import model as M
    cfg = get_config(FULL_LM["arch"])
    gc.collect()   # earlier phases' tensors in reference cycles
    torch.cuda.empty_cache()
    params = M.init_params(torch.Generator(device=dev).manual_seed(
        FULL_LM["seed"]), cfg, dev)

    F = FULL_LM
    toks = make_lm_corpus(F["seqs"] * F["seq"], vocab=cfg.vocab_size,
                          seed=F["seed"]).reshape(F["seqs"], F["seq"])
    ds = ClientDataset(SyntheticClassification(x=toks, y=toks,
                                               num_classes=cfg.vocab_size))
    steps = F["seqs"] // F["batch"]
    kw = dict(epochs=1, batch_size=F["batch"], lr=F["lr"], seed=F["seed"])
    want = {k: 0 for k in PORT_KERNELS}
    want["flash_attention"] = steps * 2 * cfg.num_layers
    want["flash_attention_bwd"] = steps * cfg.num_layers
    stats, sums = {}, {}
    for remat, profiled in (("full", False), ("full", True), ("dots", False),
                            ("dots", True)):
        got, finite, dtypes, wall, peak, counts, prof = _full_width_update(
            torch, params, dataclasses.replace(cfg, remat=remat), ds, kw,
            profiled)
        log(f"[fed-lm] full width {cfg.name} remat={remat} local_update: "
            f"{steps} steps of {F['batch']} x {F['seq']} tokens, {wall:.3f}s "
            f"({wall / steps:.3f} s/step), peak device memory "
            f"{peak / 2**30:.2f} GiB, delta finite {finite} {dtypes}, "
            f"launches={counts}{' profiled' if profiled else ''} on {smi}")
        if counts != want or not finite:
            raise AssertionError(f"full-width local_update remat={remat}: "
                                 f"launches {counts} != {want}, finite "
                                 f"{finite}")
        if sums.setdefault(remat, got) != got:
            raise AssertionError(f"full-width local_update remat={remat}: "
                                 f"a repeat differs")
        tag = "" if remat == "full" else f"{remat}_"
        stats.setdefault(f"{tag}s_per_step", []).append(wall / steps)
        stats.setdefault(f"{tag}peak_bytes", []).append(peak)
        stats["launches"] = counts
        if prof is not None:
            _full_width_profile(torch, prof, wall, steps, want, stats, remat)
    if sums["dots"] != sums["full"]:
        raise AssertionError("full-width local_update: remat=dots differs "
                             "from remat=full")
    log(f"[fed-lm] full width: each setting's two runs and remat=dots and "
        f"remat=full bit-equal (leaf checksums); s/step full "
        f"{stats['s_per_step']} dots {stats['dots_s_per_step']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _full_width_profile(torch, prof, wall: float, steps: int, want: dict,
                        stats: dict, remat: str) -> None:
    """A profiled full-width run: the device's busy share, and the bf16
    hd-128 backward on the tensor-core kernels, each launched once a
    backward call."""
    from torch.autograd import DeviceType
    stats["busy_share" if remat == "full" else f"{remat}_busy_share"] = \
        _device_busy(torch, prof, f"fed-lm full width local_update remat="
                     f"{remat}, {steps} steps", wall)
    tc, tc_us = {}, {}
    for n in ("bwd_dq_tc", "bwd_dkdv_tc"):
        evs = [e for e in prof.events() if n in e.name
               and e.device_type == DeviceType.CUDA]
        tc[n] = len(evs)
        tc_us[n] = sum(e.time_range.elapsed_us() for e in evs) \
            / max(1, len(evs))
    log(f"[fed-lm] full width: tensor-core backward kernels in the trace "
        f"{tc}, us a launch { {n: round(u, 1) for n, u in tc_us.items()} }")
    if set(tc.values()) != {want["flash_attention_bwd"]}:
        raise AssertionError(f"full-width local_update: tensor-core kernels "
                             f"{tc}, want {want['flash_attention_bwd']} each")
    if remat == "full":
        stats["tc_kernels"] = tc
        stats["tc_kernel_us"] = tc_us


# ---------------------------------------------------------------------------
# [families]: the recurrent, MoE and hybrid LM families
# ---------------------------------------------------------------------------

# the two families' full-width serve runs: B = 8, 32 tokens, prompt 2,048
# (xlstm-350m's cut to 512 for the script's time limit: its eager
# recurrences took 21.5 s to prefill 2,048 tokens on an H100 80GB HBM3 at
# 700 W)
FAMILY_SERVE = (dict(SERVE, arch="xlstm-350m", prompt=512),
                dict(SERVE, arch="qwen2-moe-a2.7b"))
# xlstm-350m's prefill launches: profiled at these prompt lengths, where
# the eager recurrences make the count a + b * S; the line through them
# gives the count at the serve prompt (a profile of the serve prompt's 1.2
# M launches would take the profiler tens of seconds to parse)
FAMILY_PROFILE_PROMPTS = (16, 32, 64)
# qwen2-moe's decode-vs-prefill gate runs at lossless capacity in f32
# arithmetic (bf16 weights) at this batch: in bf16 the two paths' rounding
# flips near-tied top-k choices, and through the layers the gap grows to
# the logits' size (2, 6, 24 layers at full width: 7.8e-3, 0.45, 0.60-1.22
# of max|prefill| in bf16; 2.4e-6, 3.7e-6, 1.2e-5 in f32, on the H100),
# so no bf16 gap is gated. B = 4 keeps the f32 lossless buffers (E x T
# slots) within the card beside the weights.
FAMILY_GATE_BATCH = 4
# the recurrent families' decode-vs-prefill check runs at this prompt (the
# serve run at its own): their eager prefill takes 18-24 s at 2,048
# tokens on the H100, and the check needs two more
FAMILY_RECURRENT_GATE_PROMPT = 256
FAMILY_DECODE_STEPS = 7
FAMILY_FEDLM = {"ssm": "fed-lm-ssm-smoke", "moe": "fed-lm-moe-smoke"}
# their runs on the card as (policy, engine, member kernel): fedasync on
# the three engine settings, fedpsa (the ssm family's took 0.76-0.84 s a
# receive on an H100 80GB HBM3 at 700 W) on cohort/grouped; the CPU tests
# run both on all three
FAMILY_RUNS = (tuple(("fedasync",) + es for es in ENGINE_SETTINGS)
               + (("fedpsa", "cohort", "grouped"),))
# tests/torch_fedlm_families.py's world and simulation
FAMILY_FEDLM_SIM = dict(num_clients=6, horizon=2_000.0, eval_every=1_000.0,
                        seed=0, local_epochs=2, batch_size=8)
# the models that do not fit the card: smoke size on the card, full size on
# the meta device
FAMILY_META = ("jamba-v0.1-52b", "arctic-480b")
# the fed-lm ssm and moe waves' member_dot products as (M, K, N): the
# mamba in_proj and out_proj, the attention projections, the MoE router
# and the unembedding, at 8 sequences of 16 tokens (15 in the loss)
FAMILY_GM_SHAPES = ((128, 16, 64), (128, 32, 16), (128, 16, 16),
                    (128, 16, 4), (120, 16, 32))


def _families_kernel_parity(torch, dev) -> dict:
    """The FL kernels at the new paths' shapes against their plain
    versions: ``grouped_matmul`` forward, dW and dx of the fed-lm ssm and
    moe waves' products at G = 4 (1e-5 x max|plain|), ``buffer_agg`` at
    their d (1e-6 (1 + max|plain|) L) and ``sens_sketch`` over a wave of 4
    members of each tree (``_sketch_tol``). Returns the worst max|err| of
    each kernel."""
    from repro_torch.common.tree import FlatSpec
    from repro_torch.configs import get_config
    from repro_torch.kernels import buffer_agg as ba
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import sens_sketch as ss
    from repro_torch.models import model as M
    rng = np.random.default_rng(24)
    worst = {"grouped_matmul": 0.0, "buffer_agg": 0.0, "sens_sketch": 0.0}
    for M_, K, N in FAMILY_GM_SHAPES:
        x = _rand(torch, rng, (4, M_, K), dev)
        w = _rand(torch, rng, (4, K, N), dev)
        g = _rand(torch, rng, (4, M_, N), dev)
        for what, a, b in (("fwd", x, w), ("dW", x.transpose(1, 2), g),
                           ("dx", g, w.transpose(1, 2))):
            got, want = gm.grouped_matmul(a, b), gm.grouped_matmul_plain(a, b)
            err, rel = _gm_rel(torch, got, want)
            log(f"[families] grouped_matmul {what} G=4 {tuple(a.shape)}@"
                f"{tuple(b.shape)} max|err|={err:.3e} rel={rel:.3e} tol=1e-05")
            if not rel <= 1e-5:
                raise AssertionError(f"grouped_matmul {what} {(M_, K, N)}: "
                                     f"rel {rel}")
            worst["grouped_matmul"] = max(worst["grouped_matmul"], err)
    for fam, arch in FAMILY_FEDLM.items():
        spec = FlatSpec(M.init_params(torch.Generator().manual_seed(0),
                                      get_config(arch)))
        d, L = spec.size, 5
        wts = torch.softmax(_rand(torch, rng, (L,), dev), 0)
        glob, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (L, d), dev)
        got, want = ba.buffer_agg(wts, glob, u), ba.buffer_agg_plain(wts, glob, u)
        err = float((got - want).abs().max())
        tol = 1e-6 * (1.0 + float(want.abs().max())) * L
        t, g, f = _sketch_rows(torch, rng, dev, 4, d)
        table = ss.layout_table(spec.sizes, 42, 16, str(dev))
        sg = ss.sens_sketch_rows(t, g, f, table)
        sw = ss.sens_sketch_rows_plain(t, g, f, table)
        torch.cuda.synchronize()
        share = float(((sg - sw).abs() / _sketch_tol(torch, t, g, f, 16)).max())
        log(f"[families] {arch} (d={d}, {len(spec.sizes)} leaves): "
            f"buffer_agg L={L} max|err|={err:.3e} tol={tol:.3e}; sens_sketch "
            f"wave of 4 k=16 max|err|={float((sg - sw).abs().max()):.3e} at "
            f"{share:.3f} of its tolerance")
        if not (err <= tol and share <= 1.0):
            raise AssertionError(f"{arch}: buffer_agg {err} > {tol} or "
                                 f"sens_sketch at {share} of its tolerance")
        worst["buffer_agg"] = max(worst["buffer_agg"], err)
        worst["sens_sketch"] = max(worst["sens_sketch"],
                                   float((sg - sw).abs().max()))
    return worst


def _family_fixture(fam: str) -> dict:
    """The reference's sequential runs of a fed-lm family
    (``tests/torch_fixtures/fed_lm_<family>_digests.json``)."""
    with open(os.path.join(ROOT, "tests", "torch_fixtures",
                           f"fed_lm_{fam}_digests.json")) as fh:
        fix = json.load(fh)
    if fix["sim"] != FAMILY_FEDLM_SIM or fix["model"] != FAMILY_FEDLM[fam]:
        raise AssertionError(f"{fam}: fixture {fix['model']} {fix['sim']} "
                             f"!= {FAMILY_FEDLM_SIM}")
    return fix


def _family_world(fam: str):
    """``(cfg, clients, test, calib, init)`` of a fed-lm family's world,
    the init the reference's (``tests/torch_fixtures/
    fed_lm_<family>_smoke_init_seed0.npz``)."""
    from repro_torch.convert import load_npz_params
    from repro_torch.launch.train import build_task
    W = FEDLM_WORLD
    cfg, clients, test, calib = build_task(FAMILY_FEDLM[fam], W["samples"],
                                           W["alpha"], W["clients"],
                                           W["seed"], seq_len=W["seq"])
    return cfg, clients, test, calib, load_npz_params(os.path.join(
        ROOT, "tests", "torch_fixtures", f"fed_lm_{fam}_smoke_init_seed0.npz"))


def _families_fedlm(torch, smi: str) -> tuple:
    """``fed-lm-ssm-smoke`` and ``fed-lm-moe-smoke`` on the card:
    ``FAMILY_RUNS``, from the reference's init
    (``tests/torch_fixtures/fed_lm_<family>_smoke_init_seed0.npz``), against
    the reference's runs in ``tests/torch_fixtures/fed_lm_<family>_digests
    .json`` (RTOL/ATOL on the digests, accuracies within 2e-3, counters
    exact), with exact launch counts (``_fedlm_want``: the ssm world
    launches no attention kernel). Returns (launch counts by path, the
    cohort runs by (family, policy, member kernel): what the sweeps and
    the mesh runs are held to)."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated.simulator import SimConfig, run_algorithm
    from repro_torch.kernels import ops
    paths, refs = {}, {}
    for fam, arch in FAMILY_FEDLM.items():
        fix = _family_fixture(fam)
        cfg, clients, test, calib, params = _family_world(fam)
        for name, engine, mk in FAMILY_RUNS:
            want = fix["policies"][name]
            what = f"{arch} {name} {engine}/{mk}"
            kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
                  if name == "fedpsa" else {})
            sim = SimConfig(engine=engine, member_kernel=mk, device="cuda",
                            record_trajectory=True, **FAMILY_FEDLM_SIM)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_algorithm(name, cfg, params, clients, test, sim, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            got, exp = np.asarray(res.digests), np.asarray(want["digests"])
            if got.shape != exp.shape or res.engine != engine:
                raise AssertionError(f"{what}: {got.shape} != {exp.shape}")
            np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
            for key in ("versions", "dispatches", "dropped", "launched"):
                if getattr(res, key) != want["final"][key]:
                    raise AssertionError(f"{what}: {key} {getattr(res, key)}"
                                         f" != {want['final'][key]}")
            np.testing.assert_allclose(res.accuracies, want["accuracies"],
                                       atol=2e-3)
            want_counts = _fedlm_want(name, res, cfg, mk == "grouped"
                                      and engine == "cohort")
            if counts != want_counts:
                raise AssertionError(f"{what}: launches {counts} != "
                                     f"{want_counts}")
            rel = float(np.max(np.abs(got - exp)
                               / (np.abs(exp) + ATOL / RTOL)))
            paths[f"{arch}-{name}-{engine}-{mk}"] = counts
            if engine == "cohort":
                refs[fam, name, mk] = {**_run_ref(res, counts, wall),
                                       "accuracies": res.accuracies,
                                       "local_steps": res.local_steps}
            log(f"[families] {what}: {len(got)} digests match the "
                f"reference's (max rel {rel:.2e}), local steps "
                f"{res.local_steps}, versions={res.versions} dispatches="
                f"{res.dispatches} final={res.final_accuracy:.4f} "
                f"{wall:.2f}s ({wall / res.dispatches:.4f} s/receive) "
                f"launches={counts} on {smi}")
    return paths, refs


# the families' sweep lanes: tests/test_torch_sweep_families.py's (data
# seeds 0, 1, 2) against the reference's run_sweep lanes in its fixture
FAMILY_SWEEP_SEEDS = [0, 1, 2]
# the families' sweeps and mesh runs on the card as (policy, member
# kernel): each member kernel once, each against the cohort run of
# FAMILY_RUNS with the same member kernel (the CPU tests run both policies
# under both)
FAMILY_CARD_CASES = (("fedasync", "vmap"), ("fedpsa", "grouped"))
FAMILY_SWEEP_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                                    "fed_lm_families_sweep_digests.json")


def _families_sweeps(torch, smi: str, refs: dict) -> dict:
    """3-lane ``run_sweep``s (data seeds 0, 1, 2) of both families,
    ``FAMILY_CARD_CASES``: every lane against the
    reference's ``run_sweep`` lane (``FAMILY_SWEEP_FIXTURE``) at the lane
    tolerance (rtol 1e-5, atol 1e-4), lane 0 also against the reference's
    sequential run, times and counters exact; launches exact
    (``_fedlm_want`` over 3 lanes) with the local steps of the standalone
    cohort run in ``refs`` (the same waves). Returns launch counts by
    path."""
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import SimConfig, SweepConfig, run_sweep
    with open(FAMILY_SWEEP_FIXTURE) as fh:
        fixture = json.load(fh)
    if fixture["sim"] != FAMILY_FEDLM_SIM or \
            fixture["data_seeds"] != FAMILY_SWEEP_SEEDS:
        raise AssertionError(f"family sweep fixture for {fixture['sim']}, "
                             f"{fixture['data_seeds']}")
    paths = {}
    for fam in FAMILY_FEDLM:
        seq = _family_fixture(fam)["policies"]
        cfg, clients, test, calib, params = _family_world(fam)
        for name, mk in FAMILY_CARD_CASES:
            lanes = fixture["sweeps"][f"{fam}/{name}"]
            what = f"{FAMILY_FEDLM[fam]} sweep {name} cohort/{mk}"
            kw = (dict(psa_cfg=PSAConfig(**GOLDEN_PSA), calib_batch=calib)
                  if name == "fedpsa" else {})
            sim = SimConfig(engine="cohort", member_kernel=mk, device="cuda",
                            record_trajectory=True, **FAMILY_FEDLM_SIM)
            res, wall, _, counts = _timed_run(torch, lambda: run_sweep(
                name, cfg, params, clients, test, sim,
                SweepConfig(data_seeds=FAMILY_SWEEP_SEEDS), **kw))
            if res.times != lanes["times"]:
                raise AssertionError(f"{what}: times {res.times}")
            for key, val in lanes["final"].items():
                if getattr(res, key) != val:
                    raise AssertionError(f"{what}: {key} "
                                         f"{getattr(res, key)} != {val}")
            shares = [_lane_gap(res.digests[s_], want)
                      for s_, want in enumerate(lanes["digests"])]
            seq_share = _lane_gap(res.digests[0], seq[name]["digests"])
            if not max(shares + [seq_share]) <= 1.0:
                raise AssertionError(f"{what}: lanes at {shares} of the lane "
                                     f"tolerance, lane 0 at {seq_share} "
                                     f"against the sequential run")
            solo = refs[fam, name, mk]
            if res.local_steps != solo["local_steps"]:
                raise AssertionError(f"{what}: local steps {res.local_steps}"
                                     f" != the standalone run's "
                                     f"{solo['local_steps']}")
            want_counts = _fedlm_want(name, res, cfg, mk == "grouped")
            if counts != want_counts:
                raise AssertionError(f"{what}: launches {counts} != "
                                     f"{want_counts}")
            paths[f"{FAMILY_FEDLM[fam]}-sweep-{name}-{mk}"] = counts
            log(f"[families] {what} 3 lanes: vs the reference's lanes "
                f"{[f'{x:.3e}' for x in shares]} of the lane tolerance, "
                f"lane 0 vs its sequential run {seq_share:.3e}; "
                f"cohorts={res.cohorts} versions={res.versions} local steps "
                f"{res.local_steps} {wall:.2f}s ({wall / res.dispatches:.4f} "
                f"s/receive, the standalone run {solo['s_per_receive']:.4f}) "
                f"launches={counts} on {smi}")
    return paths


def _families_moe_backward(torch, dev) -> None:
    """Two forward-backward passes of an MoE layer at smoke width bit-equal
    on the card: qwen2-moe-a2.7b-smoke's layer (4 experts, top-2, a shared
    expert) at capacity factor 1.0 in 2 groups, so choices drop and every
    path of the dispatch and combine maps runs; f32 and bf16, and a wave of
    3 members under ``"grouped"``."""
    from repro_torch.common.tree import tree_leaves, tree_unflatten_like
    from repro_torch.configs import get_config
    from repro_torch.models import member_math, moe
    base = dataclasses.replace(get_config("qwen2-moe-a2.7b-smoke"),
                               capacity_factor=1.0, dispatch_groups=2)
    for dt, B in ((torch.float32, 0), (torch.bfloat16, 0),
                  (torch.float32, 3)):
        cfg = dataclasses.replace(base, dtype=str(dt)[6:],
                                  param_dtype=str(dt)[6:])
        lead = (B,) if B else ()
        p = moe.init_moe(torch.Generator(device=dev).manual_seed(5), cfg,
                         dev, lead)
        x0 = torch.randn(lead + (4, 64, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6)
                         ).to(dt)
        outs = []
        for _ in range(2):
            leaves = [l.detach().requires_grad_(True) for l in tree_leaves(p)]
            x = x0.detach().requires_grad_(True)
            pp = tree_unflatten_like(p, leaves)
            with member_math.routing("grouped" if B else "vmap"):
                y, aux = moe.moe_forward(pp, x, cfg, members=bool(B))
                loss = torch.sum(y.float() ** 2) + torch.sum(aux)
                grads = torch.autograd.grad(loss, leaves + [x])
            outs.append([g.detach().clone() for g in grads])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in outs[0])
        log(f"[families] MoE layer backward ({cfg.name}, capacity 1.0, 2 "
            f"groups, {str(dt)[6:]}{f', {B} members grouped' if B else ''}): "
            f"two runs bit-equal {same}, finite {finite}")
        if not (same and finite):
            raise AssertionError(f"MoE backward {dt} B={B}: bit-equal {same}, "
                                 f"finite {finite}")


def _families_world(torch, dev, spec: dict):
    """``spec``'s model at full width, random bf16 init on the card from a
    seeded generator, and its prompts plus one more token each."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(spec["arch"])
    params = M.init_params(torch.Generator(device=dev).manual_seed(
        spec["seed"]), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"] + 1),
                         generator=torch.Generator().manual_seed(spec["seed"]))
    return cfg, params, toks.to(dev)


def _families_decode_gap(torch, params, cfg, toks, S: int) -> tuple:
    """Decode logits at position S against the last logits of a prefill of
    S + 1 tokens: (max|diff|, max|prefill|, greedy agreement, flash_attention
    launches per prefill and per decode step)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    V = cfg.vocab_size
    with torch.no_grad():
        ops.reset_launch_counts()
        cache, _ = M.prefill(params, {"tokens": toks[:, :S]}, cfg,
                             max_len=S + 1)
        per_prefill = ops.launch_counts()
        ops.reset_launch_counts()
        _, dec = M.decode_step(params, cache, toks[:, S:], S, cfg)
        per_decode = ops.launch_counts()
        del cache
        _, pre = M.prefill(params, {"tokens": toks}, cfg)
    dec, pre = dec[:, 0, :V].float(), pre[:, :V].float()
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(pre).all())):
        raise AssertionError(f"{cfg.name}: serve logits are not finite")
    return (float((dec - pre).abs().max()), float(pre.abs().max()),
            float((dec.argmax(-1) == pre.argmax(-1)).float().mean()),
            per_prefill, per_decode)


def _families_profile(torch, params, cfg, toks, S: int, what: str,
                      decode: bool = True) -> dict:
    """Device events (launches) and busy share of one prefill of S tokens
    and (with ``decode``) of ``FAMILY_DECODE_STEPS`` decode steps after it,
    each under its own device-only profile."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    n = FAMILY_DECODE_STEPS
    out = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache, lg = M.prefill(params, {"tokens": toks[:, :S]}, cfg,
                                  max_len=S + n)
            tok = torch.argmax(lg, -1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill_busy"] = _device_busy(torch, prof, f"{what} prefill "
                                           f"S={S}", wall, top=6)
        out["prefill_launches"] = sum(1 for e in prof.events()
                                      if e.device_type.name == "CUDA")
        if not decode:
            return out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                cache, lg = M.decode_step(params, cache, tok, S + i, cfg)
                tok = torch.argmax(lg[:, 0], -1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["decode_busy"] = _device_busy(torch, prof, f"{what} decode, {n} "
                                          f"steps", wall, top=6)
        out["decode_launches_per_step"] = sum(
            1 for e in prof.events() if e.device_type.name == "CUDA") / n
    return out


def _families_serve_one(torch, dev, smi: str, spec: dict) -> tuple:
    """One family model's full-width serve run: the decode-vs-prefill
    check (xlstm at ``FAMILY_RECURRENT_GATE_PROMPT``; qwen2-moe at the
    serve prompt, gated at lossless capacity ``E / top_k``, where no
    choice drops at either shape, in f32 arithmetic at
    ``FAMILY_GATE_BATCH``; its bf16 gap at the shipped capacity printed
    ungated: at 1.25 a decode step's 8 tokens route in one
    group with one slot an expert, the prefill's 16,384 in 16 groups of
    86), the counted run
    through ``serve.generate`` (flash_attention once a prefill per
    attention layer, never in decode), and the profiles. Returns (counts,
    stats)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    _free_card(torch)
    t0 = time.perf_counter()
    cfg, params, toks = _families_world(torch, dev, spec)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S, B = spec["prompt"], spec["batch"]
    attn = cfg.num_superblocks * cfg.block_pattern.count("attn")
    stats = {"init_s": init_s, "weights_bytes": torch.cuda.memory_allocated()}
    # (config, batch, gated, key); an MoE's gate at lossless capacity in f32
    # arithmetic over the bf16 weights, its shipped capacity's bf16 gap
    # printed (see FAMILY_GATE_BATCH)
    checks = [(cfg, B, FAMILY_RECURRENT_GATE_PROMPT, True, "gap")]
    if cfg.num_experts:
        lossless = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        checks = [(dataclasses.replace(lossless, dtype="float32"),
                   FAMILY_GATE_BATCH, S, True, "gap"),
                  (cfg, B, S, False, "bf16_shipped_gap")]
    for c, b, s, gate, key in checks:
        err, big, agree, per_pre, per_dec = _families_decode_gap(
            torch, params, c, toks[:b, :s + 1], s)
        what = (f" {c.dtype} arithmetic, capacity factor "
                f"{c.capacity_factor:g}" if cfg.num_experts else "")
        log(f"[families] {cfg.name} B={b} prompt={s}{what}: decode logits at "
            f"position {s} vs prefill of {s + 1} tokens: max|diff|={err:.4e} "
            f"max|prefill|={big:.4e} ({err / big:.3e} of it; tol "
            f"{SERVE_TOL * big:.4e}{'' if gate else ', not gated'}) greedy "
            f"agreement {agree:.3f}; launches per prefill {per_pre}, per "
            f"decode step {per_dec}")
        want_pre = {k: (attn if k == "flash_attention" else 0)
                    for k in per_pre}
        if per_pre != want_pre or any(per_dec.values()):
            raise AssertionError(f"{cfg.name}: launches per prefill {per_pre}"
                                 f" (want {want_pre}), per decode {per_dec}")
        stats[key] = {"max_abs": err, "prefill_max_abs": big,
                      "greedy_agreement": agree, "batch": b, "prompt": s,
                      "dtype": c.dtype,
                      **({"capacity_factor": c.capacity_factor}
                         if cfg.num_experts else {})}
        if gate and not err <= SERVE_TOL * big:
            raise AssertionError(f"{cfg.name} decode vs prefill: {err} > "
                                 f"{SERVE_TOL} * {big}")
        _free_card_keep(torch)
    # the counted main path: serve.generate on the shipped config
    prompts = toks[:, :S].contiguous()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.generate(params, cfg, prompts, spec["gen"])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: (attn if k == "flash_attention" else 0) for k in counts}
    tok = res["tokens"]
    log(f"[families] {cfg.name} serve.generate B={B} prompt={S} "
        f"gen={spec['gen']}: prefill {res['prefill_s']:.4f}s "
        f"({B * S / res['prefill_s']:.0f} tok/s), {res['decode_steps']} decode "
        f"steps {res['decode_s']:.4f}s ({res['decode_tok_s']:.1f} tok/s, "
        f"{1e3 * res['decode_s'] / res['decode_steps']:.2f} ms/step), peak "
        f"device memory {peak / 2**30:.2f} GiB (weights "
        f"{stats['weights_bytes'] / 2**30:.2f} GiB), init {init_s:.1f}s, "
        f"launches={counts} on {smi}")
    if counts != want:
        raise AssertionError(f"{cfg.name} serve: launches {counts} != {want}")
    if tuple(tok.shape) != (B, spec["gen"]) or int(tok.min()) < 0 \
            or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} serve: tokens {tuple(tok.shape)}")
    stats.update(prefill_s=res["prefill_s"], decode_ms_per_step=1e3
                 * res["decode_s"] / res["decode_steps"],
                 decode_tok_s=res["decode_tok_s"], peak_bytes=peak)
    # launches and busy share: the full prefill where the trace stays
    # small; for the recurrences, prefills of FAMILY_PROFILE_PROMPTS and the
    # line through their counts
    if cfg.family == "moe":
        stats["profile"] = _families_profile(torch, params, cfg, toks, S,
                                             cfg.name)
        stats["prefill_launches"] = stats["profile"]["prefill_launches"]
    else:
        runs = {s: _families_profile(torch, params, cfg, toks, s, cfg.name,
                                     decode=s == FAMILY_PROFILE_PROMPTS[-1])
                for s in FAMILY_PROFILE_PROMPTS}
        (s0, s1, s2) = FAMILY_PROFILE_PROMPTS
        n0, n1, n2 = (runs[s]["prefill_launches"] for s in (s0, s1, s2))
        # the line through the two longest; the shortest must sit on it
        # within 5% (a trace's count moves by up to 1.5% from one session
        # to the next: +7, +30.5, +24, -156 events off the line seen)
        per_tok = (n2 - n1) / (s2 - s1)
        off = n0 - (n1 - per_tok * (s1 - s0))
        if not abs(off) <= 5e-2 * n0:
            raise AssertionError(f"{cfg.name}: prefill launches {n0}, {n1}, "
                                 f"{n2} at {FAMILY_PROFILE_PROMPTS} are not "
                                 f"a line")
        stats["profile"] = runs[s2]
        stats["prefill_launches_per_token"] = per_tok
        stats["prefill_launches"] = n1 + per_tok * (S - s1)
        log(f"[families] {cfg.name} prefill launches {n0}, {n1}, {n2} at "
            f"prompts {FAMILY_PROFILE_PROMPTS}: {per_tok:g} a token (the "
            f"shortest {off:+g} off the line), {stats['prefill_launches']:g} "
            f"at prompt {S}; decode {runs[s2]['decode_launches_per_step']:g} "
            f"a step")
    log(f"[families] {cfg.name}: launches per prefill "
        f"{stats['prefill_launches']:g}, per decode step "
        f"{stats['profile']['decode_launches_per_step']:g}; device busy "
        f"{100 * stats['profile']['prefill_busy']:.1f}% of a prefill's wall, "
        f"{100 * stats['profile']['decode_busy']:.1f}% of decode's")
    del params, toks, res
    _free_card(torch)
    return counts, stats


def _free_card_keep(torch) -> None:
    """Release cached blocks between checks while the weights stay live."""
    gc.collect()
    torch.cuda.empty_cache()


def _families_meta(torch, dev, smi: str) -> dict:
    """The two models that do not fit the card: at full size on the meta
    device (the parameter count and the largest leaves), and at ``-smoke``
    size on the card: loss and gradients finite, flash_attention once per
    attention layer in the forward, decode within 2e-3 of a prefill of one
    more token (f32). Returns the smoke runs' launch counts by path."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    paths = {}
    for arch in FAMILY_META:
        cfg = get_config(arch)
        meta = M.init_params(None, cfg, "meta")
        total, active = M.count_params(cfg)
        big = sorted(((leaf.numel(), tuple(leaf.shape))
                      for leaf in tree_leaves(meta)), reverse=True)[:2]
        if sum(leaf.numel() for leaf in tree_leaves(meta)) != total:
            raise AssertionError(f"{arch}: meta tree != count_params")
        log(f"[families] {arch} on the meta device: {total:,} parameters "
            f"({active:,} active), {2 * total / 1e9:.1f} GB of bf16 weights; "
            f"largest leaves {[s for _, s in big]}")
        scfg = get_config(arch + "-smoke")
        p = M.init_params(torch.Generator(device=dev).manual_seed(0), scfg, dev)
        toks = torch.randint(0, scfg.vocab_size, (2, 33), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        ops.reset_launch_counts()
        loss = M.loss_fn(p, {"tokens": toks[:, :32], "labels": toks[:, :32]},
                         scfg)
        grads = torch.autograd.grad(loss, leaves)
        counts = ops.launch_counts()
        attn = scfg.num_superblocks * scfg.block_pattern.count("attn")
        want = {k: 0 for k in counts}
        want.update(flash_attention=attn, flash_attention_bwd=attn)
        with torch.no_grad():
            cache, _ = M.prefill(p, {"tokens": toks[:, :32]}, scfg, max_len=33)
            _, dec = M.decode_step(p, cache, toks[:, 32:], 32, scfg)
            _, pre = M.prefill(p, {"tokens": toks}, scfg)
        gap = float((dec[:, 0] - pre).abs().max())
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        log(f"[families] {scfg.name} on the card: loss {float(loss.detach()):.4f}, "
            f"gradients finite {finite}, launches {counts}; decode vs "
            f"prefill of one more token max|diff| {gap:.3e} on {smi}")
        if counts != want or not finite or not gap <= 2e-3:
            raise AssertionError(f"{scfg.name}: launches {counts} (want "
                                 f"{want}), finite {finite}, gap {gap}")
        paths[f"{scfg.name}-loss"] = counts
        del p, leaves, grads, meta
    return paths


def phase_families_fedlm(torch, dev, smi: str) -> tuple:
    """``[families]``' small world, before ``[mesh]`` (which holds the
    families' mesh runs to its cohort runs): the FL kernels at the fed-lm
    ssm and moe shapes, ``FAMILY_RUNS`` against the reference's digests
    and the ``FAMILY_CARD_CASES`` sweeps against its lanes, launches
    exact. Returns (kernel errors, launch counts by path, the cohort runs
    by (family, policy, member kernel))."""
    errs = _families_kernel_parity(torch, dev)
    t0 = time.perf_counter()
    paths, refs = _families_fedlm(torch, smi)
    log(f"[families] fed-lm ssm and moe runs {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    paths.update(_families_sweeps(torch, smi, refs))
    log(f"[families] fed-lm ssm and moe sweeps "
        f"{time.perf_counter() - t0:.1f}s")
    return errs, paths, refs


def phase_families(torch, dev, smi: str) -> tuple:
    """[families]: the recurrent, MoE and hybrid LMs on the card (the
    fed-lm runs came before ``[mesh]``, ``phase_families_fedlm``): two MoE
    layer backwards bit-equal; xlstm-350m and qwen2-moe-a2.7b served at
    full width (B = 8, 32 tokens; prompts ``FAMILY_SERVE``);
    jamba-v0.1-52b and arctic-480b at smoke size and on the meta device.
    Returns (launch counts by path, serve stats by model)."""
    t_phase = time.perf_counter()
    _families_moe_backward(torch, dev)
    paths = _families_meta(torch, dev, smi)
    serve_stats = {}
    for spec in FAMILY_SERVE:
        t0 = time.perf_counter()
        counts, serve_stats[spec["arch"]] = _families_serve_one(
            torch, dev, smi, spec)
        paths[f"serve-{spec['arch']}"] = counts
        log(f"[families] {spec['arch']} serve phase "
            f"{time.perf_counter() - t0:.1f}s")
    log(f"[families] the whole phase took {time.perf_counter() - t_phase:.1f}s")
    return paths, serve_stats


# ---------------------------------------------------------------------------
# [frontends]: the vision and audio frontends, the step builders, the
# optimizers and the pretrain example
# ---------------------------------------------------------------------------

# flash_attention at the frontends' shapes, (B, Sq, Sk, H, Hkv, hd, causal):
# internvl2-1b's prefill (8 x (256 patches + 2,048 tokens), GQA 14/2: a
# group of 7) and its train step's (2 x 2,304), hubert-xlarge's encode (8 x
# 2,048 frames, MHA 16/16, hd 80 in the kernels' 128 bucket, non-causal)
# and its train step's microbatch (2 x 2,048), and an edge with a group of 7
FRONT_VLM_PREFILL = (8, 2304, 2304, 14, 2, 64, True)
FRONT_AUDIO_ENCODE = (8, 2048, 2048, 16, 16, 80, False)
FRONT_VLM_TRAIN = (2, 2304, 2304, 14, 2, 64, True)
FRONT_AUDIO_TRAIN = (2, 2048, 2048, 16, 16, 80, False)
FRONT_EDGE = (1, 300, 300, 14, 2, 64, True)
FRONT_FA_SHAPES = (FRONT_VLM_PREFILL, FRONT_AUDIO_ENCODE, FRONT_EDGE)
FRONT_BWD_SHAPES = (FRONT_EDGE, FRONT_VLM_TRAIN, FRONT_AUDIO_TRAIN)
FRONT_SERVE = dict(arch="internvl2-1b", batch=8, prompt=2048, gen=32, seed=0)
FRONT_ENCODE = dict(arch="hubert-xlarge", batch=8, frames=2048, seed=0)
# the encode's gate: the first superblocks of the full-width model in f32
# arithmetic, the kernel path against the same forward through
# flash_attention_plain, within FRONT_ENCODE_TOL x max|logit|
FRONT_ENCODE_GATE_LAYERS = 2
FRONT_ENCODE_TOL = 2e-5
# make_train_step at full width: batch x seq (plus the 256 patches of
# internvl2-1b), grad_accum, two steps a run, two runs
FRONT_TRAIN = (dict(arch="hubert-xlarge", batch=4, seq=2048, grad_accum=2),
               dict(arch="internvl2-1b", batch=2, seq=2048, grad_accum=1))
FRONT_TRAIN_STEPS = 2
FRONT_LR = 1e-3
# make_sketch_step on hubert-xlarge at full width: a calibration batch of
# 2 x 512 frames, k = 16, seed 42; the plain version held in chunks of
# FRONT_SKETCH_CHUNK elements of a leaf
FRONT_SKETCH = dict(batch=2, frames=512, k=16, seed=42)
FRONT_SKETCH_CHUNK = 1 << 25
FRONT_PRETRAIN = ("--preset", "20m", "--rounds", "3", "--device", "cuda")


def _front_params(torch, dev, arch: str, seed: int, **over):
    """``arch`` at full width, random init on the card from a seeded
    generator (bf16, as shipped)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), **over)
    return cfg, M.init_params(torch.Generator(device=dev).manual_seed(seed),
                              cfg, dev)


def _front_batch(torch, dev, cfg, B: int, S: int, seed: int) -> dict:
    """A batch from a seeded host generator: tokens, labels and the patch
    embeddings (vision), or frame features and per-frame labels (audio);
    features and patches f32 normal, as the reference's serve draws them."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if cfg.frontend == "audio":
        out = {"features": torch.randn((B, S, cfg.d_model), generator=gen),
               "labels": labels}
    else:
        out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen), "labels": labels}
        if cfg.frontend == "vision":
            out["patches"] = torch.randn((B, cfg.num_prefix_tokens,
                                          cfg.d_model), generator=gen)
    return {k: v.to(dev) for k, v in out.items()}


def _front_bounds(shape, backward: bool = False) -> tuple:
    """(bound ms, by what, FLOP, bytes) of attention at ``shape`` in bf16:
    2 products (the forward) or 5 (the backward) of 2 hd FLOP per unmasked
    (query, key) pair and head at the bf16 tensor-core peak, against q, k,
    v, o (and dO, dq, dk, dv and the lse for the backward) moved once."""
    B, Sq, Sk, H, Hkv, hd, causal = shape
    pairs = _band_pairs(Sq, Sk, causal, None)
    flops = (5 if backward else 2) * 2 * hd * pairs * B * H
    qo, kv = B * Sq * H * hd, B * Sk * Hkv * hd
    bytes_ = 2 * (4 * qo + 4 * kv) + 4 * B * H * Sq if backward \
        else 2 * (2 * qo + 2 * kv)
    o_ms = flops / BF16_TC_FLOPS_PER_S * 1e3
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    return max(o_ms, b_ms), "operations" if o_ms >= b_ms else "bytes", \
        flops, bytes_


def _front_kernels(torch, dev) -> dict:
    """flash_attention and its backward at the frontends' shapes against
    their plain versions: the forward in f32 (2e-5 x max(1, max|plain|))
    and bf16 (``bf16_limit``) at ``FRONT_FA_SHAPES``, repeats bit-equal; the
    backward through ``_bwd_check`` at ``FRONT_BWD_SHAPES`` in bf16 (the
    tensor-core kernels against float64, ``bwd_bf16_tc_limit``) and at the
    edge in f32 (the CUDA-core kernels). Then the times (L2 flushed) of the
    hubert encode's and the internvl2 prefill's forward and of both train
    shapes' backward in bf16, each beside its plain version, SDPA (forward,
    or its autograd backward) on the same inputs and its bound. Returns the
    errors, shares and timings."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(25)
    out = {"fwd_f32_err": 0.0, "fwd_bf16_err": 0.0, "fwd_bf16_share": 0.0,
           "bwd_f32_err": 0.0, "bwd_bf16_share": 0.0, "timing": []}
    for shape in FRONT_FA_SHAPES:
        B, Sq, Sk, H, Hkv, hd, causal = shape
        q = _rand(torch, rng, (B, Sq, H, hd), dev)
        k = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        v = _rand(torch, rng, (B, Sk, Hkv, hd), dev)
        for dt in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            got = fa.flash_attention(a, b, c, causal=causal)
            want = fa.flash_attention_plain(a, b, c, causal=causal)
            again = fa.flash_attention(a, b, c, causal=causal)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dt == torch.float32:
                share = err / (2e-5 * max(1.0, float(want.float().abs().max())))
                out["fwd_f32_err"] = max(out["fwd_f32_err"], err)
            else:
                share = float((diff / fa.bf16_limit(want, c)).max())
                out["fwd_bf16_err"] = max(out["fwd_bf16_err"], err)
                out["fwd_bf16_share"] = max(out["fwd_bf16_share"], share)
            same = torch.equal(got, again)
            log(f"[frontends] flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                f"Hkv={Hkv} hd={hd} {'causal' if causal else 'full'} "
                f"{str(dt)[6:]}: max|err|={err:.3e}, worst at {share:.3f} of "
                f"its limit; repeat bit-equal {same}")
            if not (share <= 1.0 and same and got.dtype == dt):
                raise AssertionError(f"flash_attention {shape} {dt}: {err}, "
                                     f"{share} of its limit, repeat {same}")
            del got, want, again, diff
        del q, k, v
    for shape in FRONT_BWD_SHAPES:
        B, Sq, Sk, H, Hkv, hd, causal = shape
        for dt in ((torch.float32, torch.bfloat16) if shape == FRONT_EDGE
                   else (torch.bfloat16,)):
            q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
                     for _ in range(2))
            k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
                    for _ in range(2))
            o, lse = fa._forward(q, k, v, causal, with_lse=True)
            r = _bwd_check(torch, fa, q, k, v, o, do, lse, causal)
            what = (f"B={B} Sq={Sq} H={H} Hkv={Hkv} hd={hd} "
                    f"{'causal' if causal else 'full'} {str(dt)[6:]}")
            log(f"[frontends] flash_attention_bwd {what} ({r['route']}): "
                f"{r['note']}; repeat bit-equal {r['same']}")
            if not (r["share"] <= 1.0 and r["same"] and r["finite"]):
                raise AssertionError(f"flash_attention_bwd {what}: {r}")
            if dt == torch.float32:
                out["bwd_f32_err"] = max(out["bwd_f32_err"], max(r["errs"]))
            else:
                out["bwd_bf16_share"] = max(out["bwd_bf16_share"], r["share"])
            del q, k, v, do, o, lse
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    for shape, backward in ((FRONT_AUDIO_ENCODE, False),
                            (FRONT_VLM_PREFILL, False),
                            (FRONT_AUDIO_TRAIN, True), (FRONT_VLM_TRAIN, True)):
        B, Sq, Sk, H, Hkv, hd, causal = shape
        dt = torch.bfloat16
        q, do = (_rand(torch, rng, (B, Sq, H, hd), dev).to(dt)
                 for _ in range(2))
        k, v = (_rand(torch, rng, (B, Sk, Hkv, hd), dev).to(dt)
                for _ in range(2))
        bound, by, flops, bytes_ = _front_bounds(shape, backward)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(backward)
                      for x in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 is_causal=causal, enable_gqa=H != Hkv)
        if backward:
            o, lse = fa._forward(q, k, v, causal, with_lse=True)
            ot, dot = sdpa(qt, kt, vt), do.transpose(1, 2)
            fn = lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, causal)  # noqa: E731
            plain = lambda: _bwd_plain_by_kv(torch, fa, q, k, v, o, do, lse,  # noqa: E731
                                             causal, None)
            lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,  # noqa: E731
                                              retain_graph=True)
        else:
            fn = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
            plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal)  # noqa: E731
            lib = lambda: sdpa(qt, kt, vt)  # noqa: E731
        lib_ms, why = _sdpa_or_none(torch, lib, 20, flush)
        r = dict(shape=f"{'backward ' if backward else ''}B={B} S={Sq} H={H} "
                       f"Hkv={Hkv} hd={hd} "
                       f"{'causal' if causal else 'non-causal'} bf16",
                 ms=_time_ms(torch, fn, 20, flush),
                 plain_ms=_time_ms(torch, plain, 3, flush),
                 library_ms=lib_ms, bound_ms=bound, bound_by=by, flops=flops,
                 bytes=bytes_,
                 library_note=("SDPA's autograd backward" if backward
                               else "F.scaled_dot_product_attention")
                 + (f": {why}" if why else ""))
        out["timing"].append(r)
        log(f"[timing] frontends {r['shape']}: kernel {r['ms'] * 1e3:.1f}us, "
            f"plain {r['plain_ms'] * 1e3:.1f}us, {r['library_note']} "
            + ("not run" if lib_ms is None else f"{lib_ms * 1e3:.1f}us")
            + f"; {flops:.4e} FLOP, {bytes_ / 1e6:.1f} MB: bound "
            f"{bound * 1e3:.1f}us by {by} ({100 * bound / r['ms']:.2f}% of "
            f"it)")
        del q, k, v, do, qt, kt, vt
        if backward:
            del o, lse, ot, dot
    del flush
    return out


def _front_serve(torch, dev, smi: str) -> tuple:
    """internvl2-1b served at full width: B = 8, 256 patches + a prompt of
    2,048, 32 tokens (``serve.generate`` with patches). Decode's logits at
    position P + S against the last logits of a prefill of S + 1 tokens
    after the same patches, within SERVE_TOL x max|prefill|;
    flash_attention once a layer a prefill and never in a decode step.
    Returns (counts, stats)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    spec = FRONT_SERVE
    _free_card(torch)
    t0 = time.perf_counter()
    cfg, params = _front_params(torch, dev, spec["arch"], spec["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, P = spec["batch"], spec["prompt"], cfg.num_prefix_tokens
    batch = _front_batch(torch, dev, cfg, B, S + 1, spec["seed"])
    toks, patches = batch["tokens"], batch["patches"]
    attn = cfg.num_superblocks
    with torch.no_grad():
        ops.reset_launch_counts()
        cache, _ = M.prefill(params, {"tokens": toks[:, :S],
                                      "patches": patches}, cfg,
                             max_len=P + S + 1)
        per_pre = ops.launch_counts()
        ops.reset_launch_counts()
        _, dec = M.decode_step(params, cache, toks[:, S:], P + S, cfg)
        per_dec = ops.launch_counts()
        del cache
        _, pre = M.prefill(params, {"tokens": toks, "patches": patches}, cfg)
    V = cfg.vocab_size
    dec, pre = dec[:, 0, :V].float(), pre[:, :V].float()
    err, big = float((dec - pre).abs().max()), float(pre.abs().max())
    agree = float((dec.argmax(-1) == pre.argmax(-1)).float().mean())
    log(f"[frontends] {cfg.name} B={B} P={P} prompt={S}: decode logits at "
        f"position {P + S} vs prefill of {S + 1} tokens after the patches: "
        f"max|diff|={err:.4e} max|prefill|={big:.4e} ({err / big:.3e} of it; "
        f"tol {SERVE_TOL * big:.4e}) greedy agreement {agree:.3f}; launches "
        f"per prefill {per_pre}, per decode step {per_dec}")
    want_pre = {k: (attn if k == "flash_attention" else 0) for k in per_pre}
    if per_pre != want_pre or any(per_dec.values()):
        raise AssertionError(f"{cfg.name}: launches per prefill {per_pre} "
                             f"(want {want_pre}), per decode {per_dec}")
    if not (bool(torch.isfinite(dec).all()) and err <= SERVE_TOL * big):
        raise AssertionError(f"{cfg.name} decode vs prefill: {err} > "
                             f"{SERVE_TOL} * {big}")
    del dec, pre
    _free_card_keep(torch)
    prompts = toks[:, :S].contiguous()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.generate(params, cfg, prompts, spec["gen"], patches)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tok = res["tokens"]
    log(f"[frontends] {cfg.name} serve.generate B={B} patches={P} prompt={S} "
        f"gen={spec['gen']}: prefill {res['prefill_s']:.4f}s "
        f"({B * (P + S) / res['prefill_s']:.0f} positions/s), "
        f"{res['decode_steps']} decode steps {res['decode_s']:.4f}s "
        f"({1e3 * res['decode_s'] / res['decode_steps']:.2f} ms/step, "
        f"{res['decode_tok_s']:.1f} tok/s), peak device memory "
        f"{peak / 2**30:.2f} GiB, init {init_s:.1f}s, launches={counts} on "
        f"{smi}")
    want = {k: (attn if k == "flash_attention" else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{cfg.name} serve: launches {counts} != {want}")
    if tuple(tok.shape) != (B, spec["gen"]) or int(tok.min()) < 0 \
            or int(tok.max()) >= V:
        raise AssertionError(f"{cfg.name} serve: tokens {tuple(tok.shape)}")
    stats = dict(prefill_s=res["prefill_s"], decode_ms_per_step=1e3
                 * res["decode_s"] / res["decode_steps"],
                 decode_tok_s=res["decode_tok_s"], peak_bytes=peak,
                 gap=err, prefill_max_abs=big, greedy_agreement=agree)
    del params, batch, toks, patches, prompts, res
    _free_card(torch)
    return counts, stats


def _front_encode(torch, dev, smi: str) -> tuple:
    """hubert-xlarge encoded at full width through ``make_encode_step``: B =
    8, 2,048 frames, flash_attention once a layer; finite logits (B, S,
    vocab_padded). Then its first ``FRONT_ENCODE_GATE_LAYERS`` superblocks
    in f32 arithmetic (the bf16 weights): the kernel path within
    ``FRONT_ENCODE_TOL`` x max|logit| of the same forward with
    flash_attention_plain in the layers. Returns (counts, stats)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import layers
    spec = FRONT_ENCODE
    _free_card(torch)
    cfg, params = _front_params(torch, dev, spec["arch"], spec["seed"])
    B, S = spec["batch"], spec["frames"]
    batch = _front_batch(torch, dev, cfg, B, S, spec["seed"])
    feats = {"features": batch["features"]}
    encode = steps.make_encode_step(cfg)
    with torch.no_grad():
        encode(params, feats)           # warm (cuBLAS handles)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = encode(params, feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        shape = tuple(logits.shape)
        del logits
        n = FRONT_ENCODE_GATE_LAYERS
        c2 = dataclasses.replace(cfg, num_layers=n, dtype="float32")
        p2 = dict(params, blocks=tree_map(lambda a: a[:n], params["blocks"]))
        got = steps.make_encode_step(c2)(p2, feats)
        kernel = layers.flash_attention
        layers.flash_attention = fa.flash_attention_plain
        try:
            want = steps.make_encode_step(c2)(p2, feats)
        finally:
            layers.flash_attention = kernel
        err = float((got - want)[..., :cfg.vocab_size].abs().max())
        big = float(want[..., :cfg.vocab_size].abs().max())
    want_counts = {k: (cfg.num_superblocks if k == "flash_attention" else 0)
                   for k in counts}
    log(f"[frontends] {cfg.name} encode B={B} frames={S}: {wall:.4f}s "
        f"({B * S / wall:.0f} frames/s), logits {shape} finite {finite}, peak "
        f"device memory {peak / 2**30:.2f} GiB, launches={counts}; "
        f"{n} superblocks in f32 arithmetic, kernel vs flash_attention_plain: "
        f"max|diff|={err:.4e} max|logit|={big:.4e} ({err / big:.3e} of it, "
        f"tol {FRONT_ENCODE_TOL:g}) on {smi}")
    if counts != want_counts or not finite \
            or shape != (B, S, cfg.vocab_padded) \
            or not err <= FRONT_ENCODE_TOL * big:
        raise AssertionError(f"{cfg.name} encode: launches {counts} (want "
                             f"{want_counts}), finite {finite}, {shape}, "
                             f"gap {err} of {big}")
    stats = dict(encode_s=wall, peak_bytes=peak, gate_gap=err,
                 gate_max_abs=big)
    del params, p2, got, want, batch, feats
    _free_card(torch)
    return counts, stats


def _front_train(torch, dev, smi: str, spec: dict) -> tuple:
    """``make_train_step`` at full width, FRONT_TRAIN_STEPS steps, twice
    from the same init: per step and microbatch flash_attention twice a
    layer (remat "full" recomputes the forward) and its backward once, the
    two runs bit-equal (every leaf and every loss), finite. Returns (counts
    of one run, stats)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    _free_card(torch)
    cfg, params = _front_params(torch, dev, spec["arch"], 0,
                                grad_accum=spec["grad_accum"])
    batch = _front_batch(torch, dev, cfg, spec["batch"], spec["seq"], 1)
    step = steps.make_train_step(cfg)
    m, L = spec["grad_accum"], cfg.num_superblocks
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        p, losses = params, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRONT_TRAIN_STEPS):
            p, loss = step(p, batch, FRONT_LR)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(params=p, losses=[float(x) for x in losses],
                         counts=ops.launch_counts(), wall=wall,
                         peak=torch.cuda.max_memory_allocated()))
    a, b = runs
    same = a["losses"] == b["losses"] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                          tree_leaves(b["params"])))
    finite = all(np.isfinite(a["losses"])) and all(
        bool(torch.isfinite(x).all()) for x in tree_leaves(a["params"]))
    moved = not all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(a["params"]), tree_leaves(params)))
    n = FRONT_TRAIN_STEPS * m * L
    want = {k: 0 for k in a["counts"]}
    want.update(flash_attention=2 * n, flash_attention_bwd=n)
    toks = spec["batch"] * (spec["seq"] + (cfg.num_prefix_tokens if
                                           cfg.frontend == "vision" else 0))
    log(f"[frontends] {cfg.name} make_train_step B={spec['batch']} "
        f"({toks} positions) grad_accum={m}: losses {a['losses']}, "
        f"{a['wall'] / FRONT_TRAIN_STEPS:.4f} and "
        f"{b['wall'] / FRONT_TRAIN_STEPS:.4f} s a step, peak device memory "
        f"{a['peak'] / 2**30:.2f} GiB, launches={a['counts']} (want {want}); "
        f"the two runs bit-equal {same}, finite {finite}, moved {moved} on "
        f"{smi}")
    if not (same and finite and moved and a["counts"] == want
            and b["counts"] == want):
        raise AssertionError(f"{cfg.name} train: bit-equal {same}, finite "
                             f"{finite}, moved {moved}, launches "
                             f"{a['counts']} / {b['counts']} (want {want})")
    stats = dict(s_per_step=[r["wall"] / FRONT_TRAIN_STEPS for r in runs],
                 peak_bytes=a["peak"], losses=a["losses"])
    del params, runs, a, b, p, batch
    _free_card(torch)
    return want, stats


def _front_sketch(torch, dev, smi: str, flush) -> tuple:
    """``make_sketch_step`` on hubert-xlarge at full width (d =
    946,260,480): one sens_sketch launch. The kernel on the same trees'
    flat rows against its plain version, summed over chunks of every leaf
    (each chunk hashed from its index in the leaf), within ``_sketch_tol``;
    the step's own sketch too. The layout table's build on the host (no
    cache), the kernel's time beside the chunked plain version's and the
    bound. Returns (counts, stats)."""
    from repro_torch.common.tree import FlatSpec, grad
    from repro_torch.core.sensitivity import fisher_diagonal
    from repro_torch.kernels import ops
    from repro_torch.kernels import sens_sketch as ss
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    _free_card(torch)
    sp = FRONT_SKETCH
    cfg, params = _front_params(torch, dev, "hubert-xlarge", 0)
    calib = _front_batch(torch, dev, cfg, sp["batch"], sp["frames"], 2)
    step = steps.make_sketch_step(cfg, k=sp["k"], seed=sp["seed"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_step = step(params, calib)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_superblocks
    want = {k: 0 for k in counts}
    want.update(sens_sketch=1, flash_attention=4 * L, flash_attention_bwd=2 * L)
    if counts != want:
        raise AssertionError(f"{cfg.name} sketch step: launches {counts} != "
                             f"{want}")

    def loss(p, b):
        return M.loss_fn(p, b, cfg)

    spec = FlatSpec(params)
    g_tree = grad(loss, params, calib)
    f_tree = fisher_diagonal(loss, params, calib, num_micro=1)
    with torch.no_grad():
        w, g, f = (spec.flatten(t)[None] for t in (params, g_tree, f_tree))
        del g_tree, f_tree
        t0 = time.perf_counter()
        fresh = ss.layout_table.__wrapped__(spec.sizes, sp["seed"], sp["k"],
                                            str(dev))
        torch.cuda.synchronize()
        table_s = time.perf_counter() - t0
        ntiles = fresh.tiles.shape[0]
        del fresh
        table = ss.layout_table(spec.sizes, sp["seed"], sp["k"], str(dev))
        got = ss.sens_sketch_rows(w, g, f, table)[0]
        t0 = time.perf_counter()
        want_s = torch.zeros(sp["k"], dtype=torch.float32, device=dev)
        for off, n, seed, base in table.leaves:
            for lo in range(0, n, FRONT_SKETCH_CHUNK):
                c = min(FRONT_SKETCH_CHUNK, n - lo)
                part = ss.SketchTable(sp["k"], c, ((0, c, seed, base + lo),),
                                      None)
                sl = slice(off + lo, off + lo + c)
                want_s += ss.sens_sketch_rows_plain(w[:, sl], g[:, sl],
                                                    f[:, sl], part)[0]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = _sketch_tol(torch, w, g, f, sp["k"])[0].float()
        share = float(((got - want_s).abs() / tol).max())
        step_share = float(((s_step - want_s).abs() / tol).max())
        step_same = torch.equal(s_step, got)
        ms = _time_ms(torch, lambda: ss.sens_sketch_rows(w, g, f, table), 5,
                      flush)
    d = spec.size
    bound, by = _sketch_bound(d, sp["k"])
    log(f"[frontends] {cfg.name} make_sketch_step (calibration {sp['batch']} "
        f"x {sp['frames']} frames): {wall:.3f}s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches={counts}; sens_sketch over d={d} "
        f"({len(spec.sizes)} leaves, {ntiles} tile records built in "
        f"{table_s:.3f}s on the host, uncached): max|err| vs the chunked "
        f"plain version {float((got - want_s).abs().max()):.4e}, worst at "
        f"{share:.3f} of _sketch_tol; the step's own sketch at "
        f"{step_share:.3f} of it (bit-equal to the kernel on the same trees "
        f"{step_same}); kernel {ms * 1e3:.1f}us, plain (chunked, one run) "
        f"{plain_ms * 1e3:.1f}us, bound {bound * 1e3:.1f}us by {by} "
        f"({100 * bound / ms:.1f}% of it) on {smi}")
    if not (share <= 1.0 and step_share <= 1.0
            and bool(torch.isfinite(s_step).all())):
        raise AssertionError(f"{cfg.name} sketch: {share}, {step_share} of "
                             f"the tolerance")
    stats = dict(s=wall, peak_bytes=peak, d=d, tiles=ntiles, table_s=table_s,
                 max_abs_err=float((got - want_s).abs().max()), share=share,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 step_bit_equal=step_same)
    del params, calib, w, g, f, got, want_s, tol, s_step
    _free_card(torch)
    return counts, stats


def _front_pretrain(torch, dev, smi: str) -> tuple:
    """``repro_torch.examples.pretrain_lm --preset 20m`` for a few rounds
    on the card (AdamW, warmup_cosine, client_sketch, server_step), after
    buffer_agg against its plain version at the example's d (its buffer of
    2). Launches exact: sens_sketch once a receive, once an aggregation and
    once for the initial global sketch; buffer_agg once an aggregation;
    flash_attention and its backward once a layer a pass (remat "none"):
    the local steps and 5 passes a sketch (the gradient and 4 Fisher
    microbatches). Returns (counts, stats, buffer_agg's max|err|)."""
    from repro_torch.examples import pretrain_lm
    from repro_torch.kernels import buffer_agg as ba
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = pretrain_lm.make_cfg(FRONT_PRETRAIN[1])
    d, _ = M.count_params(cfg)
    rng = np.random.default_rng(26)
    wts = torch.softmax(_rand(torch, rng, (2,), dev), 0)
    glob, u = _rand(torch, rng, (d,), dev), _rand(torch, rng, (2, d), dev)
    got, exp = ba.buffer_agg(wts, glob, u), ba.buffer_agg_plain(wts, glob, u)
    err = float((got - exp).abs().max())
    tol = 1e-6 * (1.0 + float(exp.abs().max())) * 2
    if not err <= tol:
        raise AssertionError(f"buffer_agg d={d}: {err} > {tol}")
    del glob, u, got, exp
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pretrain_lm.main(list(FRONT_PRETRAIN))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    R, V, S = res["receives"], res["versions"], res["local_steps"]
    passes = cfg.num_superblocks * (S + 5 * (R + V + 1))
    want = dict(buffer_agg=V, sens_sketch=R + V + 1, grouped_matmul=0,
                flash_attention=passes, flash_attention_bwd=passes)
    log(f"[frontends] pretrain_lm {' '.join(FRONT_PRETRAIN)}: d={d}, "
        f"buffer_agg L=2 max|err|={err:.3e} (tol {tol:.3e}); {R} receives, "
        f"{V} aggregations, {S} local steps in {wall:.2f}s "
        f"({wall / R:.4f} s/receive), losses {res['losses'][0]:.4f} -> "
        f"{res['losses'][-1]:.4f}, launches={counts} (want {want}) on {smi}")
    if counts != want or not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"pretrain_lm: launches {counts} != {want} or "
                             f"losses {res['losses']}")
    stats = dict(s=wall, s_per_receive=wall / R, receives=R, versions=V,
                 d=d, losses=res["losses"])
    del res
    _free_card(torch)
    return counts, stats, err


def phase_frontends(torch, dev, smi: str) -> tuple:
    """[frontends]: the kernels at the frontends' shapes against their
    plain versions, timed; internvl2-1b served and hubert-xlarge encoded at
    full width; both trained through ``make_train_step`` at full width
    (hubert with grad_accum 2), two runs bit-equal; ``make_sketch_step`` on
    hubert (one sens_sketch launch over d = 946,260,480); the pretrain
    example on the card. Returns (kernel results, launch counts by path,
    stats)."""
    t_phase = time.perf_counter()
    paths, stats = {}, {}
    kern = _front_kernels(torch, dev)
    log(f"[frontends] kernels {time.perf_counter() - t_phase:.1f}s")
    t0 = time.perf_counter()
    paths["frontends-internvl2-1b-serve"], stats["serve"] = _front_serve(
        torch, dev, smi)
    paths["frontends-hubert-xlarge-encode"], stats["encode"] = _front_encode(
        torch, dev, smi)
    log(f"[frontends] serve and encode {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for spec in FRONT_TRAIN:
        paths[f"frontends-{spec['arch']}-train"], stats[
            f"train-{spec['arch']}"] = _front_train(torch, dev, smi, spec)
    log(f"[frontends] train steps {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    paths["frontends-hubert-xlarge-sketch"], kern["sketch"] = _front_sketch(
        torch, dev, smi, flush)
    del flush
    paths["frontends-pretrain-20m"], stats["pretrain"], kern["buffer_agg"] = \
        _front_pretrain(torch, dev, smi)
    log(f"[frontends] sketch step and pretrain example "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"[frontends] the whole phase took {time.perf_counter() - t_phase:.1f}s")
    return kern, paths, stats


# ---------------------------------------------------------------------------
# [legacy]: the class-based servers; [examples]: the reference's examples
# ---------------------------------------------------------------------------

# the reference's benchmarks/kernel_micro.py server-step cell at CIFAR full
# width: arrivals a pass (a warm-up pass, then a timed one)
LEGACY_ARRIVALS = 60
# the five other legacy servers against their policies, on the same stream
LEGACY_OTHERS = ("fedasync", "fedbuff", "ca2fl", "fedfa", "fedpac")
LEGACY_CLIENTS = 10
LEGACY_TOL = 1e-4        # kernel_micro's legacy/fused gate
LEGACY_POLICY_TOL = 1e-5  # tests/test_policies.py's


def _legacy_stream(torch, params, k: int):
    """``kernel_micro.bench_server_step``'s arrivals at ``params``' shapes
    on the card: deltas of 0.01 N(0, 1) (numpy seed 0, leaf by leaf in
    sorted-key order), random sketches, tau = i % 3, client i % 10."""
    from repro_torch.common.tree import tree_map
    rng = np.random.RandomState(0)
    deltas, metas = [], []
    for i in range(LEGACY_ARRIVALS):
        deltas.append(tree_map(lambda x: torch.from_numpy(
            (rng.randn(*x.shape) * 0.01).astype(np.float32)).cuda(), params))
    for i in range(LEGACY_ARRIVALS):
        metas.append({"tau": i % 3, "client_id": i % LEGACY_CLIENTS,
                      "data_size": 10.0, "sketch": torch.from_numpy(
                          rng.randn(k).astype(np.float32)).cuda()})
    return deltas, metas


def _tree_gap(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) if not isinstance(a[k], dict)
               else _tree_gap(a[k], b[k]) for k in a)


def phase_legacy(torch, smi: str) -> tuple:
    """[legacy]: ``kernel_micro.bench_server_step`` at CIFAR full width
    (``paper-cifar10-cnn``, d = 1,756,426): legacy FedPSA
    (``federated.legacy``: a Python-list buffer, one tree op at a time)
    against the fused policy server (``servers.make_server``: the flat
    ring, ``buffer_agg`` once an aggregation), both with the simulator's
    ``make_sketch_fn`` (one ``sens_sketch`` launch a tree), each driven by
    ``LEGACY_ARRIVALS`` arrivals twice (a warm-up pass, then a timed pass;
    the state carries over): µs an arrival, ``speedup_x``, the final
    parameters within 1e-4 of each other, launches exact on each side
    (legacy: ``sens_sketch`` once at init and once an aggregation, no
    ``buffer_agg``; fused: the same ``sens_sketch`` and ``buffer_agg`` once
    an aggregation). Then the five other legacy servers against their
    policies on one pass of the same stream (client model = global +
    delta): flags and versions equal, parameters within 1e-5, launches
    exact. Returns (the JSON row, launch counts by path)."""
    from repro_torch.common.tree import tree_add, tree_size
    from repro_torch.core.psa import PSAConfig
    from repro_torch.federated import legacy, servers
    from repro_torch.federated.simulator import make_sketch_fn
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    cfg, clients, test, calib, params = _main_world(torch)
    psa = PSAConfig()
    sketch_fn = make_sketch_fn(cfg, calib, psa, "cuda")
    deltas, metas = _legacy_stream(torch, params, psa.sketch_k)

    def drive(server):
        for delta, meta in zip(deltas, metas):
            server.receive(delta, delta, meta)
        torch.cuda.synchronize()

    def timed(make):
        ops.reset_launch_counts()
        server = make()
        drive(server)                 # warm-up pass
        t0 = time.perf_counter()
        drive(server)                 # timed pass (the state carries over)
        return ((time.perf_counter() - t0) / LEGACY_ARRIVALS, server,
                ops.launch_counts())

    t_leg, srv_l, c_leg = timed(lambda: legacy.make_legacy_server(
        "fedpsa", params, psa_cfg=psa, sketch_fn=sketch_fn))
    t_fus, srv_f, c_fus = timed(lambda: servers.make_server(
        "fedpsa", params, psa_cfg=psa, sketch_fn=sketch_fn))
    diff = _tree_gap(srv_l.params, srv_f.params)
    aggs = 2 * LEGACY_ARRIVALS // psa.buffer_size
    want_l = {"sens_sketch": aggs + 1, "buffer_agg": 0}
    want_f = {"sens_sketch": aggs + 1, "buffer_agg": aggs}
    got_l = {k: c_leg[k] for k in want_l}
    got_f = {k: c_fus[k] for k in want_f}
    row = {"model": cfg.name, "params_d": tree_size(params),
           "arrivals": LEGACY_ARRIVALS, "buffer_size": psa.buffer_size,
           "legacy_us_per_arrival": t_leg * 1e6,
           "fused_us_per_arrival": t_fus * 1e6, "speedup_x": t_leg / t_fus,
           "max_param_diff": diff, "versions": srv_f.version,
           "legacy_launches": got_l, "fused_launches": got_f}
    log(f"[legacy] server_step fedpsa d={row['params_d']}: legacy "
        f"{t_leg * 1e6:.1f}us an arrival, fused {t_fus * 1e6:.1f}us, "
        f"speedup {t_leg / t_fus:.3f}x; final parameters max|diff| "
        f"{diff:.3e} (tol {LEGACY_TOL}); versions {srv_l.version}/"
        f"{srv_f.version}; launches legacy {got_l}, fused {got_f} on {smi}")
    if not (diff <= LEGACY_TOL and srv_l.version == srv_f.version == aggs
            and got_l == want_l and got_f == want_f
            and len(srv_l.log) == aggs):
        raise AssertionError(f"[legacy] fedpsa: {row} (want launches "
                             f"{want_l}, {want_f})")
    paths = {"legacy-fedpsa-server-step": c_leg,
             "fused-fedpsa-server-step": c_fus}
    del srv_l, srv_f
    clients_params = [tree_add(params, d) for d in deltas]
    for name in LEGACY_OTHERS:
        kw = {"num_clients": LEGACY_CLIENTS}
        ops.reset_launch_counts()
        old = legacy.make_legacy_server(name, params, **kw)
        flags_l = [old.receive(d, c, m)
                   for d, c, m in zip(deltas, clients_params, metas)]
        torch.cuda.synchronize()
        c_old = ops.launch_counts()
        ops.reset_launch_counts()
        new = servers.make_server(name, params, **kw)
        flags_p = [new.receive(d, c, m)
                   for d, c, m in zip(deltas, clients_params, metas)]
        torch.cuda.synchronize()
        c_new = ops.launch_counts()
        gap = _tree_gap(old.params, new.params)
        applies = LEGACY_ARRIVALS if name == "fedfa" else (
            0 if name == "fedasync" else new.version)
        want = ({"buffer_agg": 0, "sens_sketch": 0},
                {"buffer_agg": applies, "sens_sketch": 0})
        got = ({k: c_old[k] for k in want[0]}, {k: c_new[k] for k in want[1]})
        log(f"[legacy] {name}: legacy vs policy max|diff| {gap:.3e} (tol "
            f"{LEGACY_POLICY_TOL}), versions {old.version}/{new.version}, "
            f"launches legacy {got[0]}, policy {got[1]} on {smi}")
        if not (gap <= LEGACY_POLICY_TOL and flags_l == flags_p
                and old.version == new.version > 0 and got == want):
            raise AssertionError(f"[legacy] {name}: gap {gap}, versions "
                                 f"{old.version}/{new.version}, launches "
                                 f"{got} (want {want})")
        paths[f"legacy-{name}"], paths[f"policy-{name}"] = c_old, c_new
        del old, new
    del clients_params, deltas, metas
    gc.collect()
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_phase
    log(f"[legacy] the whole phase took {row['seconds']:.1f}s")
    return row, paths


# the examples' horizons on the card, cut for the script's time limit: the
# quickstart's from its 30,000 (its two sweeps took 78.3-108.8 s there on
# an H100 80GB HBM3 at 700 W; its main has no --horizon, so the phase sets
# the module's HORIZON for the call), paper_protocol's from its 60,000
# through its --horizon (69 receives a run, past the thermometer's 50)
EXAMPLE_QUICKSTART_HORIZON = 6_000
EXAMPLE_PROTOCOL_HORIZON = 1_500


def _example_main(torch, what: str, main, argv: list) -> tuple:
    """``main(argv)`` of an example with its standard output captured and
    logged line by line: (its results, wall s, launch counts, the text)."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    text = io.StringIO()
    gc.collect()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        results = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in text.getvalue().splitlines():
        if line.strip():
            log(f"[examples] {what}: {line}")
    return results, wall, ops.launch_counts(), text.getvalue()


def _summed(wants) -> dict:
    out = {"grouped_matmul": 0}
    for want in wants:
        for k, v in want.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_examples(torch, smi: str) -> tuple:
    """[examples]: the two examples' entry points on the card.
    ``repro_torch.examples.quickstart.main(["--device", "cuda"])`` with its
    ``HORIZON`` set to ``EXAMPLE_QUICKSTART_HORIZON`` (FedBuff and FedPSA,
    each one 3-lane ``run_sweep``) and ``repro_torch.examples.
    paper_protocol.main(["--horizon", EXAMPLE_PROTOCOL_HORIZON, "--device",
    "cuda"])`` (every algorithm of ``ALGORITHMS``, then the ordering,
    thermometer and kappa lines): each call's printed lines, each run's
    line among them, and its launches exact in total
    (``_want_sweep_launches``, ``_want_launches``; no ``grouped_matmul`` on
    the examples' default member kernel). Returns (the JSON row, launch
    counts by path)."""
    from repro_torch.examples import paper_protocol, quickstart
    from repro_torch.federated import ALGORITHMS
    t_phase = time.perf_counter()
    row, paths = {}, {}
    own = quickstart.HORIZON
    quickstart.HORIZON = EXAMPLE_QUICKSTART_HORIZON
    try:
        log(f"[examples] quickstart.main(['--device', 'cuda']) at horizon "
            f"{quickstart.HORIZON:,} (cut from {own:,})")
        sweeps, wall, counts, text = _example_main(
            torch, "quickstart", quickstart.main, ["--device", "cuda"])
    finally:
        quickstart.HORIZON = own
    want = _summed(_want_sweep_launches(alg, "l2", sweeps[alg])
                   for alg in quickstart.ALGS)
    receives = sum(sweeps[alg].dispatches for alg in quickstart.ALGS)
    missing = [alg for alg in quickstart.ALGS
               if quickstart.line(alg, sweeps[alg]) not in text]
    if {k: counts[k] for k in want} != want or missing:
        raise AssertionError(f"[examples] quickstart: launches {counts} != "
                             f"{want}, or lines missing for {missing}")
    log(f"[examples] quickstart: {len(sweeps)} sweeps of 3 lanes, receives "
        f"{receives} {wall:.2f}s ({wall / receives:.4f} s/receive) "
        f"launches={counts} on {smi}")
    paths["quickstart"] = counts
    row["quickstart"] = {"horizon": EXAMPLE_QUICKSTART_HORIZON, "s": wall,
                         "receives": receives, **{
                             f"{alg}_final_accuracy": sweeps[alg].final_accuracy
                             for alg in quickstart.ALGS}}
    H = EXAMPLE_PROTOCOL_HORIZON
    argv = ["--horizon", str(H), "--device", "cuda"]
    log(f"[examples] paper_protocol.main({argv}) (cut from 60,000)")
    results, wall, counts, text = _example_main(
        torch, "paper_protocol", paper_protocol.main, argv)
    want = _summed(_want_launches(alg, "l2", results[alg])
                   for alg in ALGORITHMS)
    receives = sum(results[alg].dispatches for alg in ALGORITHMS)
    missing = [alg for alg in ALGORITHMS
               if paper_protocol.line(alg, results[alg]) not in text]
    if {k: counts[k] for k in want} != want or missing or \
            "FedPSA thermometer" not in text:
        raise AssertionError(f"[examples] paper_protocol: launches {counts} "
                             f"!= {want}, or lines missing for {missing} or "
                             f"the thermometer's")
    log(f"[examples] paper_protocol: {len(results)} runs, receives "
        f"{receives} {wall:.2f}s ({wall / receives:.4f} s/receive) "
        f"launches={counts} on {smi}")
    paths["paper_protocol"] = counts
    row["paper_protocol"] = {"horizon": H, "s": wall, "receives": receives,
                             "final_accuracy": {
                                 alg: results[alg].final_accuracy
                                 for alg in ALGORITHMS}}
    row["seconds"] = time.perf_counter() - t_phase
    log(f"[examples] the whole phase took {row['seconds']:.1f}s on {smi}")
    return row, paths


def _dryrun_cases() -> list:
    """``DRYRUN_CASES`` through the dry-run CLI, one process each, side by
    side, with no card visible: their records."""
    out = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", sh, "--mesh", "pod", "--out", out], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, sh in DRYRUN_CASES]
    recs = []
    for (a, sh), p in zip(DRYRUN_CASES, procs):
        stdout, stderr = p.communicate(timeout=600)
        if p.returncode != 0 or "1 ok, 0 skipped, 0 errors" not in stdout:
            raise AssertionError(f"[dryrun] {a} x {sh}: exit {p.returncode}"
                                 f"\n{stdout[-2000:]}\n{stderr[-3000:]}")
        with open(os.path.join(out, f"{a}__{sh}__pod.json")) as fh:
            rec = json.load(fh)
        if rec["status"] != "ok" or rec["unparsed_loops"] != 0:
            raise AssertionError(f"[dryrun] {a} x {sh}: {rec['status']}")
        coll = {k: {"count": int(v["count"]), "ici_bytes": v["ici_bytes"]}
                for k, v in rec["collectives"].items()}
        log(f"[dryrun] {a} x {sh} x pod: flops/dev "
            f"{rec['flops_per_device']:.4e}, bytes/dev "
            f"{rec['bytes_per_device']:.4e}, ici {rec['collective_ici_bytes']:.4e} B, "
            f"trace {rec['trace_s']}s, argument bytes "
            f"{rec['memory_analysis']['argument_size_in_bytes']}, "
            f"collectives {json.dumps(coll)}, kernels "
            f"{json.dumps({k: int(v['count']) for k, v in rec['kernels'].items()})}")
        recs.append(rec)
    return recs


def phase_dryrun(torch, dev, smi: str) -> dict:
    """``[dryrun]``: the four dry runs (started first, in their own
    processes), then phase 9's prefill counted by ``op_cost`` on the card
    and on meta tensors, and timed on the card against the bound of its
    count."""
    from repro_torch.launch import op_cost
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    pending = {}

    def cases():
        pending["recs"] = _dryrun_cases()
    worker = threading.Thread(target=cases)
    worker.start()
    _free_card(torch)
    cfg, params, toks = _serve_world(torch, dev)
    S = SERVE["prompt"]
    batch = {"tokens": toks[:, :S]}

    def prefill(p, b):
        with torch.no_grad():
            return M.prefill(p, b, cfg, max_len=S + SERVE["gen"])
    prefill(params, batch)          # warm: cuBLAS's first calls
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with op_cost.OpCounter() as card:
        prefill(params, batch)
        torch.cuda.synchronize()
    del params
    _free_card(torch)
    meta_params = M.init_params(None, cfg, "meta")
    with op_cost.OpCounter() as meta:
        prefill(meta_params, {"tokens": torch.empty(
            batch["tokens"].shape, dtype=batch["tokens"].dtype,
            device="meta")})
    a, b = card.result(), meta.result()
    for key in ("flops_per_device", "bytes_per_device", "transcendentals",
                "kernels"):
        if a[key] != b[key]:
            raise AssertionError(f"[dryrun] prefill on the card and on meta "
                                 f"differ in {key}: {a[key]} vs {b[key]}")
    fa = a["kernels"]["flash_attention"]
    if fa["count"] != cfg.num_layers:
        raise AssertionError(f"[dryrun] flash_attention counted "
                             f"{fa['count']} times, not {cfg.num_layers}")
    per_us = fa["flops"] / fa["count"] / BF16_TC_FLOPS_PER_S * 1e6
    if abs(per_us - 208.6) > 0.05:
        raise AssertionError(f"[dryrun] flash_attention's formula gives "
                             f"{per_us:.3f}us a launch, not 208.6")
    bound = max(a["flops_per_device"] / BF16_TC_FLOPS_PER_S,
                a["bytes_per_device"] / HBM_BYTES_PER_S)
    measured = min(times)
    log(f"[dryrun] {cfg.name} prefill B={SERVE['batch']} S={S}: "
        f"{a['flops_per_device']:.4e} flops ({fa['flops']:.4e} in "
        f"{int(fa['count'])} flash_attention launches, {per_us:.2f}us each "
        f"at 989 TFLOP/s), {a['bytes_per_device']:.4e} bytes, equal on the "
        f"card and on meta; measured {measured:.4f}s (runs "
        f"{', '.join(f'{t:.4f}' for t in times)}) against the bound "
        f"{bound:.4f}s (flops {a['flops_per_device'] / BF16_TC_FLOPS_PER_S:.4f}s, "
        f"bytes {a['bytes_per_device'] / HBM_BYTES_PER_S:.4f}s): "
        f"{100 * bound / measured:.1f}% of it, on {smi}")
    for row in meta.table(8):
        log(f"[dryrun]   {row[0]}: {int(row[1])} ops, {row[2]:.4e} flops, "
            f"{row[3]:.4e} bytes")
    worker.join(timeout=900)
    if "recs" not in pending:
        raise AssertionError("[dryrun] the dry-run processes failed")
    seconds = time.perf_counter() - t_phase
    log(f"[dryrun] the whole phase took {seconds:.1f}s on {smi}")
    return {"records": [{k: r[k] for k in (
        "arch", "shape", "flops_per_device", "bytes_per_device",
        "collective_ici_bytes", "n_collectives", "trace_s")}
        for r in pending["recs"]],
        "prefill": {"flops": a["flops_per_device"],
                    "bytes": a["bytes_per_device"],
                    "flash_attention_us_per_launch": per_us,
                    "measured_s": measured, "bound_s": bound,
                    "share_of_bound": bound / measured},
        "seconds": seconds}


def _seconds(what: str, fn, *args):
    """``fn(*args)``, printing its seconds as a ``[fed-lm]`` sub-phase."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[fed-lm] {what}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:
        # one rank of a [mesh] job that this script spawned
        return _mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.federated.simulator  # noqa: F401  (fail before any output)
    import repro_torch.launch.serve  # noqa: F401
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f}s")

    name, count, smi = phase_device(torch)
    dev = torch.device("cuda")
    # full float32 throughout (cuDNN's TF32 default would move the convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    mark("build")
    errs = phase_parity(torch, dev)
    timing = phase_timing(torch, dev)
    mark("parity and timing")
    golden_ref = phase_golden(torch)
    mark("golden")
    phase_sweeps_golden(torch)
    phase_resume_fedavg(torch)
    mark("sweeps, resume, FedAvg")
    by_path = {"sequential": phase_main(torch),
               "cohort": phase_main_cohort(torch)}
    policy_paths, full_ref = phase_policies(torch)
    by_path.update(policy_paths)
    mark("main paths and policies")
    full_width, mono, mono_wall = phase_full_width(torch, smi)
    mark("full width")
    full_ref["fedpsa", "l2"] = _run_ref(mono[0], mono[1], mono_wall)
    pop_cases, pop_paths = phase_population(torch, dev, smi, mono)
    mark("population")
    del mono
    by_path.update(full_width, **pop_paths)
    # [fed-lm]'s small world first: its single-device runs are what [mesh]
    # holds the fed-lm mesh runs to
    t0 = time.perf_counter()
    fedlm_kern = _seconds("kernels", phase_fedlm_kernels, torch, dev)
    fedlm_paths, fedlm_ref = _seconds("goldens", phase_fedlm, torch, smi)
    paths, refs = _seconds("window", phase_fedlm_window, torch, smi)
    fedlm_paths.update(paths)
    fedlm_ref.update(refs)
    fedlm_paths.update(_seconds("sweeps", phase_fedlm_sweeps, torch, smi,
                                fedlm_ref))
    fedlm_paths.update(_seconds("policies", phase_fedlm_policies, torch,
                                smi))
    log(f"[fed-lm] small-world phases {time.perf_counter() - t0:.1f}s")
    mark("fed-lm small world")
    fam_errs, fam_paths, fam_ref = phase_families_fedlm(torch, dev, smi)
    mark("families small world")
    by_path["mesh-n2-cifar"], paths = phase_mesh(torch, smi, golden_ref,
                                                 full_ref, fedlm_ref, fam_ref)
    mark("mesh")
    fedlm_paths.update(paths)
    # the timed serve runs come before any profiler session, so no profiler
    # state is live while they run
    serve_check = phase_serve_checks(torch, dev)
    serve_counts, serve_stats = phase_serve(torch, dev, smi)
    serve_paths, serve_more = phase_serve_more(torch, dev, smi)
    mark("serve")
    t0 = time.perf_counter()
    _seconds("remat", phase_fedlm_remat, torch, smi)
    fedlm_full = _seconds("full width", phase_fedlm_full, torch, dev, smi)
    fedlm_paths["fed-lm-full-width"] = fedlm_full["launches"]
    by_path.update(fedlm_paths)
    log(f"[fed-lm] full-width phases {time.perf_counter() - t0:.1f}s")
    mark("fed-lm full width")
    paths, fam_serve = phase_families(torch, dev, smi)
    fam_paths.update(paths)
    by_path.update(fam_paths)
    mark("families")
    front, front_paths, front_stats = phase_frontends(torch, dev, smi)
    by_path.update(front_paths)
    mark("frontends")
    legacy_row, legacy_paths = phase_legacy(torch, smi)
    examples_row, examples_paths = phase_examples(torch, smi)
    by_path.update(legacy_paths, **examples_paths)
    mark("legacy and examples")
    dryrun_row = phase_dryrun(torch, dev, smi)
    mark("dryrun")
    phase_profile(torch)
    phase_profile_serve(torch, dev)
    mark("profiles")
    sources = {"buffer_agg": ("src/repro_torch/csrc/buffer_agg.cu",
                              "src/repro/kernels/buffer_agg.py:38",
                              "1e-6 * (1 + max|plain|) * L"),
               "sens_sketch": ("src/repro_torch/csrc/sens_sketch.cu",
                               "src/repro/kernels/sens_sketch.py:69",
                               "1e-5 * sum|s| / sqrt(k) + 1e-7"),
               "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                                  "src/repro/kernels/grouped_matmul.py:55",
                                  "1e-5 * max|plain| (f32)")}
    kernels = []
    for k, (src, rep, tol) in sources.items():
        r = timing[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": by_path["cohort"][k],
                        "launches_by_path": {p: c[k] for p, c in by_path.items()},
                        "max_abs_err": max(errs[k], fam_errs[k]),
                        "tolerance": tol, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"],
                        "population_shape": pop_cases[k],
                        **{x: r[x] for x in ("device_ms", "host_us", "design",
                                             "cases", "probe") if x in r}})
    kernels[0]["frontends"] = {"pretrain_20m_max_abs_err": front["buffer_agg"]}
    kernels[1]["frontends"] = front["sketch"]
    from repro_torch.kernels import flash_attention as fa
    r = timing["flash_attention"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:74",
        "launches": serve_counts["flash_attention"],
        "launches_by_path": {"serve": serve_counts["flash_attention"]},
        "max_abs_err": max(errs["flash_attention"],
                           errs["flash_attention_window"]["f32"]),
        "max_abs_err_bf16": max(errs["flash_attention_bf16"],
                                errs["flash_attention_window"]["bf16"]),
        "bf16_worst_share_of_limit": max(
            errs["flash_attention_bf16_share"],
            errs["flash_attention_window"]["bf16_share"]),
        "window_parity": errs["flash_attention_window"],
        "tolerance": f"f32 2e-5 * max(1, max|plain|); bf16 elementwise "
                     f"{fa.BF16_LIMIT}",
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "design": r["design"],
        "window": timing["flash_attention_window"],
        "frontends": {"max_abs_err": front["fwd_f32_err"],
                      "max_abs_err_bf16": front["fwd_bf16_err"],
                      "bf16_worst_share_of_limit": front["fwd_bf16_share"],
                      "timing": [t for t in front["timing"]
                                 if not t["shape"].startswith("backward")]}})
    kernels[-1]["launches_by_path"].update(
        {p: c["flash_attention"] for p, c in
         {**serve_paths, **fedlm_paths, **fam_paths, **front_paths}.items()})
    r = fedlm_kern["timing"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:111",
        "replaces_note": "no TPU kernel: the reference's JAX autodiff of "
                         "chunked_attention",
        "launches": fedlm_paths["fed-lm-train-cli"]["flash_attention_bwd"],
        "launches_by_path": {p: c["flash_attention_bwd"]
                             for p, c in {**fedlm_paths, **fam_paths,
                                          **front_paths}.items()},
        "max_abs_err": fedlm_kern["f32"]["max_abs_err"],
        "max_abs_err_bf16": fedlm_kern["bf16"]["max_abs_err"],
        "bf16_worst_share_of_limit": fedlm_kern["bf16"]["share"],
        "bf16_worst_share_of_cuda_core_limit": fedlm_kern["bf16"]["old_share"],
        "bf16_edges_worst_share": fedlm_kern["edges_worst_share"],
        "window_worst_share": fedlm_kern["window"],
        "tensor_core_kernel_launches_full_width": fedlm_full["tc_kernels"],
        "tolerance": "f32 2e-5 * max(1, max|plain|); bf16 hd <= 128 (tensor "
                     "cores) elementwise vs float64 2^-8 |ref| + (2^-8 + (n + "
                     "2 hd + 16) 2^-24) sum|terms|; bf16 hd > 128 (CUDA "
                     "cores) 2^-8 |ref| + (n + 2 hd + 16) 2^-24 sum|terms|",
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "fp32_bound_ms": r["fp32_bound_ms"],
        "cuda_core_ms": r["cuda_core_ms"],
        "library_ms": r["library_ms"], "shape": r["shape"],
        "design": r["design"], "window": fedlm_kern["window_timing"],
        "window_empty_rows": fedlm_kern["empty_rows_timing"],
        "frontends": {"max_abs_err": front["bwd_f32_err"],
                      "bf16_worst_share_of_limit": front["bwd_bf16_share"],
                      "timing": [t for t in front["timing"]
                                 if t["shape"].startswith("backward")]}})
    log(json.dumps({"serve": {**serve_stats, **serve_check}}))
    log(json.dumps({"serve_more": serve_more}))
    log(json.dumps({"families": fam_serve}))
    log(json.dumps({"frontends": front_stats}))
    log(json.dumps({"legacy": legacy_row, "examples": examples_row}))
    log(json.dumps({"dryrun": dryrun_row}))
    log(json.dumps({"fed_lm_full_width": {
        k: fedlm_full[k] for k in (
            "s_per_step", "peak_bytes", "busy_share", "tc_kernel_us",
            "dots_s_per_step", "dots_peak_bytes", "dots_busy_share")}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
