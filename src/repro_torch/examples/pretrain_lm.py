"""End-to-end driver: federated pretraining of a transformer LM with FedPSA.

    PYTHONPATH=src python -m repro_torch.examples.pretrain_lm           # ~20M, card
    PYTHONPATH=src python -m repro_torch.examples.pretrain_lm --preset tiny \
        --rounds 2 --device cpu                                        # CPU smoke

The port of the reference's ``examples/pretrain_lm.py``, with its presets
and its loop: clients hold disjoint shards of a synthetic bigram corpus,
train locally with AdamW under ``warmup_cosine``, and upload deltas and
sensitivity sketches (``client_sketch``: one ``sens_sketch`` launch on the
card); the server runs Algorithm 1 (``server_step``: the Eq. 20 apply
through ``buffer_agg`` and the global sketch's refresh on each
aggregation). Runs on the CUDA card by default and raises without one
(``--device cpu`` runs the kernels' plain versions). The weights are a
random init from a ``torch.Generator`` seeded with 0, the corpus and the
client order come from numpy seeds, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.common import tree as tu
from repro_torch.common.device import setup_device
from repro_torch.core import PSAConfig, client_sketch, init_state, server_step
from repro_torch.data import make_lm_corpus
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, apply_updates, warmup_cosine

PRESETS = {
    # ~2M params: CI smoke
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                 d_ff=512, vocab_size=1024),
    # ~20M params: quick demo
    "20m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
                d_ff=1024, vocab_size=2048),
    # ~100M params: the "train a ~100M model" scale
    "100m": dict(num_layers=8, d_model=768, num_heads=12, num_kv_heads=12,
                 d_ff=3072, vocab_size=8192),
}


def make_cfg(preset: str) -> ModelConfig:
    p = PRESETS[preset]
    return ModelConfig(
        name=f"pretrain-{preset}", family="dense",
        block_pattern=("attn",), ffn_pattern=("dense",),
        dtype="float32", param_dtype="float32", remat="none",
        q_chunk=128, kv_chunk=128, **p)


def main(argv=None) -> dict:
    """Run the driver; returns the counts of the run (receives, versions,
    local steps), the last local loss of each receive and the final
    parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=40,
                    help="global aggregations (x buffer = client updates)")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = setup_device(args.device)
    cfg = make_cfg(args.preset)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    total, _ = M.count_params(cfg)
    print(f"[pretrain] {cfg.name}: {total/1e6:.1f}M params, "
          f"{args.clients} clients, buffer 2, on {args.device}")

    corpus = make_lm_corpus(400_000, vocab=cfg.vocab_size, seed=0)
    shards = np.array_split(corpus, args.clients)

    opt = adamw(weight_decay=0.01)
    schedule = warmup_cosine(args.lr, 20, args.rounds * 2)

    def loss_fn(p, batch):
        return M.loss_fn(p, batch, cfg)

    def local_step(p, opt_state, batch, lr):
        loss, g = tu.value_and_grad(loss_fn, p, batch)
        upd, opt_state = opt.update(g, opt_state, p, lr)
        return apply_updates(p, upd), opt_state, loss

    def sample_batch(shard, rng):
        starts = rng.randint(0, len(shard) - args.seq - 1, size=args.batch)
        toks = torch.from_numpy(np.stack([shard[s:s + args.seq + 1]
                                          for s in starts]).astype(np.int64))
        toks = toks.to(dev)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    psa_cfg = PSAConfig(buffer_size=2, queue_len=10, sketch_k=16)
    rng = np.random.RandomState(0)
    calib = sample_batch(corpus, rng)

    def sketch_of(p):
        return client_sketch(loss_fn, p, calib, psa_cfg)

    # the server core: the flat parameter vector and Algorithm 1's step
    # (receive, aggregate once the buffer fills, refresh the global sketch)
    spec = tu.FlatSpec(params)
    psa = init_state(psa_cfg, spec.size, sketch_of(params), device=dev)
    g_vec = spec.flatten(params)

    t0 = time.time()
    losses = []
    step = version = receives = 0
    while version < args.rounds:
        cid = rng.randint(args.clients)
        p_local = params
        opt_state = opt.init(p_local)
        for _ in range(args.local_steps):
            p_local, opt_state, loss = local_step(
                p_local, opt_state, sample_batch(shards[cid], rng),
                schedule(step))
            step += 1
        delta = tu.tree_sub(p_local, params)
        psa, g_vec, info = server_step(
            psa, g_vec, spec.flatten(delta), sketch_of(p_local), psa_cfg,
            lambda vec: sketch_of(spec.unflatten(vec)))
        receives += 1
        losses.append(float(loss))
        if info.updated:
            version += 1
            params = spec.unflatten(g_vec)
            if version % 5 == 0 or version == args.rounds:
                temp = float(info.temp) if info.temp_valid else None
                print(f"[pretrain] agg {version:4d} "
                      f"loss {np.mean(losses[-8:]):.3f} temp={temp} "
                      f"({time.time()-t0:.0f}s)")

    if args.ckpt:
        save_pytree(params, args.ckpt, step=args.rounds)
        print(f"[pretrain] checkpoint -> {args.ckpt}")
    ppl0 = np.exp(losses[0])
    ppl1 = np.exp(np.mean(losses[-8:]))
    print(f"[pretrain] perplexity {ppl0:.1f} -> {ppl1:.1f} "
          f"(bigram floor ~ branching=8)")
    return {"params": params, "losses": losses, "receives": receives,
            "versions": version, "local_steps": step}


if __name__ == "__main__":
    main()
