"""Architecture configs of the port: `get_config(arch_id)` returns the full
ArchConfig, `get_smoke_config(arch_id)` the CPU-sized reduction.  Each
ported arch has its own module, copied from `repro/configs/<arch>.py`;
every arch of the reference is ported.  `get_card_config(arch_id)` is the config
one 80 GB card serves: the module's CARD (the full widths, cut in depth)
for a model the card cannot hold, else CONFIG.  `SHAPES`,
`shape_supported` and `input_specs` are the dry-run's benchmark shapes,
as the reference's: `input_specs` gives meta tensors (shapes and dtypes,
no storage) for every model input of a shape."""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

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


# Benchmark shapes: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, tuple] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs, else the skip reason."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("skip: 500k-token decode requires sub-quadratic attention; "
                f"{cfg.arch_id} has full-attention layers (DESIGN.md SS4)")
    return None


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def input_specs(cfg: ArchConfig, shape_name: str
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for the model inputs of one benchmark shape (global
    shapes, no storage): tokens / labels (B, S) int32, a stub frontend's
    or an encoder's `embeds` in the model dtype (an encoder's capped at
    its `enc_len`), and a decode's one token a row (B, 1)."""
    seq, batch, kind = SHAPES[shape_name]

    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    dt, i32 = _dtype(cfg), torch.int32
    if cfg.enc_dec:
        enc = {"embeds": f((batch, min(seq, cfg.enc_len), cfg.d_model), dt)}
        if kind == "train":
            return {**enc, "tokens": f((batch, seq), i32),
                    "labels": f((batch, seq), i32)}
        if kind == "prefill":
            return {**enc, "tokens": f((batch, seq), i32)}
        return {"tokens": f((batch, 1), i32)}
    if kind == "train":
        if cfg.frontend != "none":
            return {"embeds": f((batch, seq, cfg.d_model), dt),
                    "labels": f((batch, seq), i32)}
        return {"tokens": f((batch, seq), i32),
                "labels": f((batch, seq), i32)}
    if kind == "prefill":
        if cfg.frontend != "none":
            return {"embeds": f((batch, seq, cfg.d_model), dt)}
        return {"tokens": f((batch, seq), i32)}
    return {"tokens": f((batch, 1), i32)}
