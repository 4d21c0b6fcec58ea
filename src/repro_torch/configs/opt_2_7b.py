"""OPT-2.7B: the paper's own LLM-inference workload (Table IV (h)): the
attention block is the offloaded operation, the MLP runs host-side."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="opt_2_7b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=50272, head_dim=80,
    eos_token=2,               # </s>
    block_pattern=("full",),
    draft_arch="self:8",       # 8-of-32-layer self-draft (DESIGN.md §7)
)

SMOKE = ArchConfig(
    arch_id="opt_2_7b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16,
    eos_token=2,
    block_pattern=("full",),
    draft_arch="self:1",
)
