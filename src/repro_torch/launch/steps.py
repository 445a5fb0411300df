"""Step builders: train_step / prefill_step / encode_step / serve_step and
the FedPSA sketch step, the reference's ``repro.launch.steps``.

Each builder binds ``cfg`` and returns a plain function of the parameter
tree and the batch; the reference's sharding ``rules`` have no counterpart
on one device and are dropped. The training step is the paper's client
local step (SGD); the serving steps are the inference paths.
``make_train_step`` keeps every leaf in its own dtype, ``(p - lr * g)`` in
f32 cast back, as the reference does; the federated clients' local SGD
(``federated/client.py``) instead promotes bf16 leaves to f32.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.common.tree import grad, tree_map, value_and_grad
from repro_torch.core.sensitivity import fisher_diagonal
from repro_torch.core.sketch import DEFAULT_K
from repro_torch.kernels.ops import sketch_tree_fused
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig) -> Callable:
    """``train_step(params, batch, lr) -> (new_params, loss)``: one SGD
    step. With ``cfg.grad_accum = m > 1`` the batch's leading axis splits
    into m microbatches, one forward and backward each; the gradients
    accumulate in f32, and the gradients and the loss are divided by m."""
    def loss_fn(p, b):
        return model_lib.loss_fn(p, b, cfg)

    def train_step(params, batch, lr):
        m = max(cfg.grad_accum, 1)
        if m > 1:
            n = next(iter(batch.values())).shape[0]
            if n % m:
                raise ValueError(f"{cfg.name}: batch {n} does not split into "
                                 f"grad_accum={m} microbatches")
            grads, loss = None, None
            for i in range(m):
                mb = {k: v[i * (n // m):(i + 1) * (n // m)]
                      for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    grads, loss = tree_map(lambda x: x.float(), g), l
                else:
                    grads = tree_map(lambda a, x: a.add_(x.float()), grads, g)
                    loss = loss + l
            grads = tree_map(lambda a: a.div_(m), grads)
            loss = loss / m
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        new_params = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_params, loss
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return model_lib.prefill(params, batch, cfg)
    return prefill_step


def make_encode_step(cfg: ModelConfig) -> Callable:
    def encode_step(params, batch):
        return model_lib.encode(params, batch, cfg)
    return encode_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens, pos: int):
        return model_lib.decode_step(params, cache, tokens, pos, cfg)
    return serve_step


def make_sketch_step(cfg: ModelConfig, *, k: int = DEFAULT_K,
                     seed: int = 42) -> Callable:
    """FedPSA's client upload at production scale: the gradient and the
    Fisher diagonal on a calibration batch, then the (k,) sketch of the
    Eq. 8 sensitivity through ``kernels.ops.sketch_tree_fused`` (one
    ``sens_sketch`` launch on the card, its plain version on the CPU)."""
    def loss_fn(p, b):
        return model_lib.loss_fn(p, b, cfg)

    def sketch_step(params, calib_batch):
        grads = grad(loss_fn, params, calib_batch)
        fisher = fisher_diagonal(loss_fn, params, calib_batch, num_micro=1)
        return sketch_tree_fused(params, grads, fisher, k=k, seed=seed)
    return sketch_step


def make_step(mode: str, cfg: ModelConfig) -> Callable:
    if mode == "train":
        return make_train_step(cfg)
    if mode == "prefill":
        return make_prefill_step(cfg)
    if mode == "encode":
        return make_encode_step(cfg)
    if mode == "decode":
        return make_serve_step(cfg)
    raise ValueError(mode)
