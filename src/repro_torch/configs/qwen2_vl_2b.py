"""Qwen2-VL-2B backbone: M-RoPE; vision frontend stubbed (input_specs
provides precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2_vl_2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128, mrope=True, frontend="patch",
    eos_token=151645,               # <|im_end|>
    block_pattern=("full",),
)

SMOKE = ArchConfig(
    arch_id="qwen2_vl_2b_smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, mrope=True, frontend="patch",
    eos_token=2,
    block_pattern=("full",),
)
