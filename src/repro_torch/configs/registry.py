"""Architecture registry: --arch <id> lookup for every entry point."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
