"""Architecture configs of the port: `get_config(arch_id)` returns the full
ArchConfig, `get_smoke_config(arch_id)` the CPU-sized reduction.  Each
ported arch has its own module, copied from `repro/configs/<arch>.py`;
every arch of the reference is ported.  `get_card_config(arch_id)` is the config
one 80 GB card serves: the module's CARD (the full widths, cut in depth)
for a model the card cannot hold, else CONFIG."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = (
    "phi3_5_moe_42b",
    "granite_moe_3b",
    "mistral_nemo_12b",
    "starcoder2_3b",
    "gemma3_12b",
    "minitron_4b",
    "qwen2_vl_2b",
    "jamba_1_5_large",
    "mamba2_370m",
    "whisper_large_v3",
    "opt_2_7b",
)

PORTED = ("starcoder2_3b", "mamba2_370m", "gemma3_12b", "mistral_nemo_12b",
          "opt_2_7b", "minitron_4b", "qwen2_vl_2b", "granite_moe_3b",
          "phi3_5_moe_42b", "jamba_1_5_large", "whisper_large_v3")

# ROADMAP.md queue 1 items that port each arch not yet ported (none left)
_ROADMAP_ITEM: dict = {}


def _module(arch_id: str):
    if arch_id in PORTED:
        return importlib.import_module(f"repro_torch.configs.{arch_id}")
    if arch_id in _ROADMAP_ITEM:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md queue 1 "
            f"{_ROADMAP_ITEM[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


def get_card_config(arch_id: str) -> ArchConfig:
    module = _module(arch_id)
    return getattr(module, "CARD", module.CONFIG)
