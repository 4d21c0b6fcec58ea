"""Phi-3.5-MoE-instruct: 42B total / 6.6B active params.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

CARD is CONFIG cut in depth only, for one 80 GB card: the 32 layers hold
83.5 GB in bf16 (the experts 80.5 GB, 2.52 GB a layer, kept fp under
weight quantization as in the reference), so CARD keeps the first 24
layers, 62.7 GB.  Every width, the 16 experts and top-2 are CONFIG's."""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi3_5_moe_42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, head_dim=128,
    eos_token=32000,               # <|endoftext|>
    n_experts=16, top_k=2, moe_every=1,
    block_pattern=("full",), rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    arch_id="phi3_5_moe_42b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, head_dim=16,
    eos_token=2,
    n_experts=4, top_k=2, moe_every=1,
    block_pattern=("full",),
)

CARD = dataclasses.replace(CONFIG, arch_id="phi3_5_moe_42b_card24",
                           n_layers=24)
