"""olmoe-1b-7b [moe] — 64 experts, top-8. [arXiv:2409.02060]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab=50304, head_dim=128, n_experts=64, top_k=8, expert_d_ff=1024,
    fsdp=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    attn_4d=True,
)
