"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2. [arXiv:2402.19427]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, mlp="geglu", attn_period=3, window=2048,
    tie_embeddings=True,
    fsdp=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    attn_4d=True, gqa_expand=True,
)
