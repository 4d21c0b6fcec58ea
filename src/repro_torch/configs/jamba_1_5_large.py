"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE every other
layer (16 experts top-2).  Sub-quadratic: runs long_500k.
[arXiv:2403.19887; hf]

CARD is CONFIG cut in depth only, for one 80 GB card: one MoE layer's
experts alone are 19.3 GB in bf16, and a depth must be a multiple of the
8-layer pattern, so even one whole block (4 MoE layers) does not fit.
CARD is the real model's first five layers (four mamba, then the first
attention layer; MoE at 0, 2 and 4), 65.0 GB: the least depth that runs
an attention layer.  Every width, the 16 experts, top-2 and `moe_every`
are CONFIG's."""
import dataclasses

from repro_torch.models.config import ArchConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "full", "mamba", "mamba",
            "mamba")

CONFIG = ArchConfig(
    arch_id="jamba_1_5_large", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    eos_token=2,               # </s>
    n_experts=16, top_k=2, moe_every=2,
    block_pattern=_PATTERN,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    subquadratic=True,
)

SMOKE = ArchConfig(
    arch_id="jamba_1_5_large_smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, head_dim=16,
    eos_token=2,
    n_experts=4, top_k=2, moe_every=2,
    block_pattern=_PATTERN,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    subquadratic=True,
)

CARD = dataclasses.replace(CONFIG, arch_id="jamba_1_5_large_card5",
                           n_layers=5, block_pattern=_PATTERN[:5])
