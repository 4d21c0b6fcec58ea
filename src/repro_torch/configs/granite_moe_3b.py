"""IBM Granite-3.0 MoE: 3B total / 800M active; 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

All 32 layers fit one 80 GB card in bf16 (6.6 GB of weights), so the
card serves CONFIG itself."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite_moe_3b", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    eos_token=0,               # <|end_of_text|>
    n_experts=40, top_k=8, moe_every=1,
    block_pattern=("full",),
)

SMOKE = ArchConfig(
    arch_id="granite_moe_3b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=6, n_kv_heads=2, d_ff=32,
    vocab=515, head_dim=16,     # deliberately non-multiple-of-256 vocab
    eos_token=2,
    n_experts=5, top_k=2, moe_every=1,
    block_pattern=("full",),
)
