"""Model configuration: the paper's image families and the LMs.

The reference ``repro.models.config.ModelConfig`` covers every architecture
family; the port carries the fields its ported paths read: the image models
(cnn / mlp), the token LMs of the dense, moe, ssm and hybrid families
(prefill, decode and training) and the frontends, vision (vlm: patch
embeddings in front of the tokens) and audio (an encoder-only stack over
frame embeddings). The reference's sharding fields (``pure_data_parallel``,
``seq_shard``, ``expert_tensor_parallel``) come with ROADMAP.md Queue 1
item 12. A model is described, as in the reference,
by a *superblock pattern*: ``block_pattern`` gives the sequence mixer per
layer inside one superblock (``"attn" | "mamba" | "mlstm" | "slstm"``) and
``ffn_pattern`` the feed-forward kind (``"dense" | "moe" | "moe+dense" |
"none"``); the pattern tiles to ``num_layers``. ``dispatch_groups`` is
part of the MoE's function, not a sharding knob: the capacity is computed
per group of tokens, so it decides which tokens drop. ``grad_accum``
splits ``launch.steps.make_train_step``'s batch into microbatches.
``scan_groups``
is the reference's two-level remat: ``G > 1`` groups of superblocks, each
checkpointed, around a checkpoint per superblock. ``q_chunk`` and
``kv_chunk`` are the reference's attention chunking: the port's attention
kernel computes the same function without chunks, so they have no
numerical effect and are kept so that the configs compare field for field.
Frozen, so a config hashes and can key caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str        # cnn | mlp | dense | moe | ssm | hybrid | vlm | audio
    # LM fields (the reference's; zero for the image families)
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None
    causal: bool = True
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    block_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)
    sliding_window: Optional[int] = None
    long_context_window: Optional[int] = 8192
    # MoE (the reference's fields; dispatch_groups splits the tokens into
    # groups that each route within their own capacity)
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    dispatch_groups: int = 1
    # SSM (mamba)
    ssm_expand: int = 2
    ssm_state_dim: int = 16
    conv_kernel: int = 4
    dt_rank: int = 0                # 0 => ceil(d_model / 16)
    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_ffn_factor: float = 4.0 / 3.0
    frontend: Optional[str] = None               # None | "audio" | "vision"
    pad_vocab_to: int = 128
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    ffn_act: str = "swiglu"                      # swiglu | gelu | relu | relu2
    tie_embeddings: bool = False
    remat: str = "full"                          # none | full | dots
    scan_groups: int = 0                         # 0 = one level of remat
    grad_accum: int = 1
    num_prefix_tokens: int = 256                 # vlm patch tokens
    q_chunk: int = 512
    kv_chunk: int = 2048
    # image fields (the paper's own models)
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 5
    mlp_hidden: Tuple[int, ...] = ()
    input_hw: Tuple[int, int, int] = (0, 0, 0)   # H, W, C for cnn; (features,) via H
    num_classes: int = 10

    def __post_init__(self):
        if self.head_dim is None and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} must tile block_pattern "
            f"of length {len(self.block_pattern)}")
        assert len(self.block_pattern) == len(self.ffn_pattern)

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-self.d_model // 16)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def slstm_ffn_dim(self) -> int:
        """sLSTM post-cell FFN width, rounded up to a multiple of 128 (the
        reference's rule)."""
        f = int(self.d_model * self.slstm_ffn_factor)
        return -(-f // 128) * 128

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder_only

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m if self.vocab_size else 0

    def for_long_context(self) -> "ModelConfig":
        """The 500k-decode variant: sliding-window attention on every
        attention layer."""
        if self.long_context_window is None:
            return self
        return dataclasses.replace(self, sliding_window=self.long_context_window)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant, the reference's rule: <= 2 superblocks,
        d_model <= 256, <= 4 heads, <= 4 experts, top-k <= 2 at the lossless
        capacity ``max(cf, E / k)`` (no token drops), f32. The image
        families have no smoke variant."""
        if self.family in ("cnn", "mlp"):
            raise NotImplementedError(
                f"{self.name}: the image models have no -smoke variant; "
                f"reduced() is for the LM families (ROADMAP.md Queue 1 item 10)")
        if len(self.block_pattern) > 1:
            bp = (self.block_pattern[0], self.block_pattern[-1])
            fp = (self.ffn_pattern[0], self.ffn_pattern[-1])
        else:
            bp, fp = self.block_pattern, self.ffn_pattern
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = min(self.num_kv_heads, n_heads)
        while n_heads % n_kv:       # keep the GQA ratio valid
            n_kv -= 1
        n_exp = min(self.num_experts, 4) if self.num_experts else 0
        n_topk = min(self.top_k, 2) if self.top_k else 0
        cf = (max(self.capacity_factor, n_exp / max(n_topk, 1)) if n_exp
              else self.capacity_factor)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            block_pattern=bp,
            ffn_pattern=fp,
            num_layers=2 * len(bp) if len(bp) == 1 else len(bp),
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=max(1, n_kv),
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=n_exp,
            top_k=n_topk,
            capacity_factor=cf,
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            shared_d_ff=min(self.shared_d_ff, 128) if self.shared_d_ff else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            dtype="float32",
            param_dtype="float32",
            remat="none",
            q_chunk=64,
            kv_chunk=64,
        )
