"""Minitron-4B (pruned Nemotron).  [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="minitron_4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000, head_dim=128,
    eos_token=3,               # <extra_id_1>-family stop [unverified]
    block_pattern=("full",),
)

SMOKE = ArchConfig(
    arch_id="minitron_4b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    block_pattern=("full",),
)
