"""Architecture registry of the port: ``get_config(arch_id)``.

The paper's image models, the reference's four dense LMs
(``phi4-mini-3.8b``, ``codeqwen1.5-7b``, ``minitron-8b`` and
``llama3-405b``) and the dense federated-LM scenario ``fed-lm-smoke`` are
ported; as in the reference, ``<id>-smoke`` is ``get_config(<id>).reduced()``
unless the id is registered itself, and ``cfg.for_long_context()`` is the
sliding-window variant of a dense LM. Every other id of the reference
registry (the other LM families) raises, naming ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs import (codeqwen15_7b, fed_lm, llama3_405b,
                                 minitron_8b, phi4_mini_38b)
from repro_torch.configs.paper_models import CONFIGS as _PAPER
from repro_torch.configs.population import (POPULATION_PRESETS,  # noqa: F401
                                            PopulationPreset,
                                            get_population_preset)
from repro_torch.models.config import ModelConfig

CONFIGS = {**_PAPER,
           **{m.CONFIG.name: m.CONFIG for m in (phi4_mini_38b, codeqwen15_7b,
                                                minitron_8b, llama3_405b)},
           **fed_lm.CONFIGS}


def get_config(arch: str) -> ModelConfig:
    if arch in fed_lm.UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} needs the {fed_lm.UNPORTED[arch]} family, which "
            f"is not ported to repro_torch (ROADMAP.md Queue 1 item 10c)")
    if arch not in CONFIGS and arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).reduced()
    if arch not in CONFIGS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch (ported: "
            f"{sorted(CONFIGS)} and their -smoke variants); the other LM "
            f"families are ROADMAP.md Queue 1 item 10")
    return CONFIGS[arch]


def list_archs():
    return sorted(CONFIGS)
