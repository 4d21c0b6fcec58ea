"""StarCoder2-3B: GQA (kv=2), RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2_3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, head_dim=128,
    eos_token=0,               # <|endoftext|>
    block_pattern=("full",),
    draft_arch="self:7",       # 7-of-30-layer self-draft (DESIGN.md §7)
)

SMOKE = ArchConfig(
    arch_id="starcoder2_3b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    block_pattern=("full",),
    draft_arch="self:1",
)
