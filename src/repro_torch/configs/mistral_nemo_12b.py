"""Mistral-Nemo-Base-2407 (12B dense, 128k context).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral_nemo_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128,
    eos_token=2,               # </s>
    block_pattern=("full",), rope_theta=1_000_000.0,
    draft_arch="self:10",      # 10-of-40-layer self-draft (DESIGN.md §7)
)

SMOKE = ArchConfig(
    arch_id="mistral_nemo_12b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    block_pattern=("full",), rope_theta=1_000_000.0,
    draft_arch="self:1",
)
