"""granite-3-8b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0-8b-base]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab=49155, head_dim=128, mlp="swiglu",
    fsdp=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    attn_4d=True, gqa_expand=True, kv_seq_parallel=True,
)
