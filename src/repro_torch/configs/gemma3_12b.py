"""Gemma-3 12B class: 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3_12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256,
    eos_token=1,               # <eos>
    block_pattern=("local", "local", "local", "local", "local", "full"),
    sliding_window=1024, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    arch_id="gemma3_12b_smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    block_pattern=("local", "local", "local", "local", "local", "full"),
    sliding_window=32,
)
