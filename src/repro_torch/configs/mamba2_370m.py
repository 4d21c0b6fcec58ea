"""Mamba2-370M: attention-free SSD (state-space duality).  d_ff=0 => no FFN
sublayer.  Sub-quadratic: runs long_500k.  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2_370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab=50280,
    eos_token=0,               # <|endoftext|> (gpt-neox)
    block_pattern=("mamba",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    subquadratic=True,
    draft_arch="self:12",       # 12-of-48-layer self-draft (DESIGN.md §7)
)

SMOKE = ArchConfig(
    arch_id="mamba2_370m_smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=512,
    eos_token=2,
    block_pattern=("mamba",),
    ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    subquadratic=True,
    draft_arch="self:1",
)
