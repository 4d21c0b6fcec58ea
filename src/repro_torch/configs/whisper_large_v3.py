"""Whisper-large-v3: encoder-decoder; conv audio frontend stubbed (input
specs provide precomputed frame embeddings, max 1500 encoder positions).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper_large_v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, head_dim=64,
    eos_token=50257,               # <|endoftext|>
    enc_dec=True, n_enc_layers=32, enc_len=1500, frontend="audio_conv",
    block_pattern=("full",),
    draft_arch="self:8",       # 8-of-32-decoder-layer self-draft (§7)
)

SMOKE = ArchConfig(
    arch_id="whisper_large_v3_smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    enc_dec=True, n_enc_layers=2, enc_len=32, frontend="audio_conv",
    block_pattern=("full",),
    draft_arch="self:1",
)
