"""Architecture configuration for every supported model family: a copy of
`repro/models/config.py`, kept here so the port imports nothing of `repro`."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture.  Heterogeneous layer patterns are expressed as a
    repeating *block* of `block_pattern` layers scanned `n_blocks` times, so
    the lowered HLO stays compact regardless of depth."""

    arch_id: str
    family: str                    # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0             # 0 => dense FFN everywhere
    top_k: int = 0
    moe_every: int = 1             # MoE FFN on layers where l % moe_every == 0

    # --- attention pattern ---------------------------------------------------
    # Per-layer-in-block attention kind: 'full', 'local' (sliding window),
    # 'mamba' (SSD), or 'none'.  The block repeats over depth.
    block_pattern: Tuple[str, ...] = ("full",)
    sliding_window: int = 4096
    rope_theta: float = 10_000.0
    mrope: bool = False            # multimodal 3D rotary (qwen2-vl)

    # --- SSM (mamba2 / jamba) -------------------------------------------------
    ssm_state: int = 128
    ssm_head_dim: int = 64         # P
    ssm_expand: int = 2            # d_inner = expand * d_model
    conv_width: int = 4

    # --- serving ----------------------------------------------------------------
    # end-of-sequence token id: the default stop token serving callers put
    # in SamplingParams.stop_tokens (the registry-level fact the serve
    # loop's per-request stop sets are seeded from)
    eos_token: int = 0
    # default draft for speculative draft-and-verify serving (DESIGN.md
    # §7): "self:N" slices the target's first N blocks into a truncated-
    # layer self-draft ("self" = half the depth); any registered arch_id
    # with the same vocabulary works too.  None disables speculative
    # serving unless the server is handed an explicit draft.
    draft_arch: Optional[str] = None

    # --- structure -------------------------------------------------------------
    enc_dec: bool = False          # whisper: encoder-decoder
    n_enc_layers: int = 0
    enc_len: int = 1500            # encoder positions (whisper 30 s)
    frontend: str = "none"         # none | patch (vlm) | audio_conv (stub)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # --- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"

    # --- technique applicability (DESIGN.md SS4) ---------------------------------
    subquadratic: bool = False     # may run the long_500k shape

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, self.arch_id

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def padded_vocab(self) -> int:
        # Megatron-style vocab padding: MXU-aligned and shardable by the
        # model axis on every mesh we target.
        return pad_to(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_mamba(self) -> bool:
        return "mamba" in self.block_pattern

    @property
    def has_attention(self) -> bool:
        return any(p in ("full", "local") for p in self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_layers_per_block(self) -> int:
        return sum(1 for p in self.block_pattern if p in ("full", "local"))

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim_
        total = self.padded_vocab * d  # tied embedding
        per_block = 0
        for i, kind in enumerate(self.block_pattern):
            if kind in ("full", "local"):
                per_block += d * (self.n_heads * hd) * 2   # wq, wo
                per_block += d * (self.n_kv_heads * hd) * 2
            elif kind == "mamba":
                di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
                per_block += d * (2 * di + 2 * ns + nh) + di * d
            per_block += 2 * d  # norms
            if kind != "none":
                layer_idx = i
                if self.is_moe and layer_idx % self.moe_every == 0:
                    per_block += self.n_experts * 3 * d * ff + d * self.n_experts
                else:
                    per_block += 3 * d * ff
        total += per_block * self.n_blocks
        if self.enc_dec:
            # encoder layers + cross attention in decoder
            enc = self.n_enc_layers * (4 * d * d + 3 * d * ff + 2 * d)
            cross = self.n_layers * 4 * d * d
            total += enc + cross
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        moe_layers = sum(1 for i, k in enumerate(self.block_pattern)
                         if k != "none" and i % self.moe_every == 0)
        moe_layers *= self.n_blocks
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * ff
        return self.n_params() - inactive
