"""Architecture registry of the port: ``get_config(arch_id)``.

The paper's image models, the reference's token LMs — dense
(``phi4-mini-3.8b``, ``codeqwen1.5-7b``, ``minitron-8b``, ``llama3-405b``),
ssm (``xlstm-350m``), moe (``qwen2-moe-a2.7b``, ``arctic-480b``) and hybrid
(``jamba-v0.1-52b``) — and the federated-LM scenarios (``fed-lm-smoke``,
``fed-lm-ssm-smoke``, ``fed-lm-moe-smoke``) are ported; as in the
reference, ``<id>-smoke`` is ``get_config(<id>).reduced()`` unless the id
is registered itself, and ``cfg.for_long_context()`` is the sliding-window
variant. The frontend models, vision (``internvl2-1b``) and audio
(``hubert-xlarge``, encoder-only), are ported too. ``SCHED_PRESETS`` are
the reference's scheduler-benchmark presets.
"""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, codeqwen15_7b, fed_lm,
                                 hubert_xlarge, internvl2_1b, jamba_v01_52b,
                                 llama3_405b, minitron_8b, phi4_mini_38b,
                                 qwen2_moe_a27b, xlstm_350m)
from repro_torch.configs.paper_models import CONFIGS as _PAPER
from repro_torch.configs.population import (POPULATION_PRESETS,  # noqa: F401
                                            PopulationPreset,
                                            get_population_preset)
from repro_torch.configs.sched import (SCHED_PRESETS,  # noqa: F401
                                       SchedBenchPreset, get_sched_preset)
from repro_torch.models.config import ModelConfig

CONFIGS = {**_PAPER,
           **{m.CONFIG.name: m.CONFIG for m in (
               phi4_mini_38b, codeqwen15_7b, minitron_8b, llama3_405b,
               xlstm_350m, qwen2_moe_a27b, jamba_v01_52b, arctic_480b,
               internvl2_1b, hubert_xlarge)},
           **fed_lm.CONFIGS}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS and arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).reduced()
    if arch not in CONFIGS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch (ported: "
            f"{sorted(CONFIGS)} and their -smoke variants)")
    return CONFIGS[arch]


def list_archs():
    return sorted(CONFIGS)
