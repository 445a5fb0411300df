"""Serving entry point of the port: prefill + batched greedy decode with the
decode cache (the reference's ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # the smoke

The ported archs are the token LMs: dense (``phi4-mini-3.8b``,
``codeqwen1.5-7b``, ``minitron-8b``, ``llama3-405b``), ssm
(``xlstm-350m``), moe (``qwen2-moe-a2.7b``, ``arctic-480b``) and hybrid
(``jamba-v0.1-52b``), the ``fed-lm-*`` scenarios, and their ``-smoke``
variants. The cache holds each attention layer's KV cache and each
recurrent layer's state. ``generate`` also serves a config's
``for_long_context()`` variant: sliding-window attention (8,192 for every
config with attention) with a ring KV cache of ``min(window, prompt +
gen)`` slots.

Runs on the CUDA card by default and raises without one (``--device cpu``
runs the kernels' plain versions). Weights are a random init from a
``torch.Generator`` seeded with ``--seed`` (on the run's device), and so
are the prompt tokens. The prefill sizes the cache for ``prompt + gen``
tokens; ``gen - 1`` greedy decode steps follow. Prints the prefill's
seconds and the decode's tokens per second; the first call on a card also
pays one-time setup (kernel load, cuBLAS handles). The default arch is the
reference's, ``xlstm-350m-smoke``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.common.device import setup_device
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int) -> dict:
    """Prefill ``prompts`` (B, S) and greedily decode ``gen`` tokens (the
    prefill's argmax, then ``gen - 1`` decode steps). Returns the tokens
    (B, gen) and the host seconds of each phase (each ends in a device
    synchronize)."""
    dev = prompts.device
    B, S = prompts.shape
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        cache, logits = model_lib.prefill(params, {"tokens": prompts}, cfg,
                                          max_len=S + gen)
        out = [torch.argmax(logits, dim=-1)[:, None]]
        _sync(dev)
        t1 = time.perf_counter()
        for i in range(gen - 1):
            cache, lg = model_lib.decode_step(params, cache, out[-1], S + i, cfg)
            out.append(torch.argmax(lg[:, 0], dim=-1)[:, None])
        tokens = torch.cat(out, dim=1)
        _sync(dev)
        t2 = time.perf_counter()
    steps = gen - 1
    return {"tokens": tokens, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_steps": steps,
            "decode_tok_s": B * steps / (t2 - t1) if steps else float("nan")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")

    cfg = get_config(args.arch)
    model_lib.check_lm(cfg)
    dev = setup_device(args.device)
    params = model_lib.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(args.seed))
    res = generate(params, cfg, prompts.to(dev), args.gen)
    print(f"[serve] {cfg.name} on {args.device}: prefill({args.batch}x"
          f"{args.prompt_len}) {res['prefill_s']:.4f} s; "
          f"{res['decode_steps']} decode steps {res['decode_s']:.4f} s "
          f"({res['decode_tok_s']:.1f} tok/s)")
    print("[serve] generated token ids:\n", res["tokens"].cpu().numpy())
    return res


if __name__ == "__main__":
    main()
