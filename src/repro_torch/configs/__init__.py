"""Architecture registry of the port: ``get_config(arch_id)``.

Only the paper's image models are ported; every other id of the reference
registry (the LM families) raises, naming ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs.paper_models import CONFIGS
from repro_torch.models.config import ModelConfig


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch (ported: "
            f"{sorted(CONFIGS)}); the LM families are ROADMAP.md Queue 1 "
            f"item 10")
    return CONFIGS[arch]


def list_archs():
    return sorted(CONFIGS)
