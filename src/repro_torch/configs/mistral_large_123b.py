"""mistral-large-123b [dense] — GQA kv=8. [hf:mistralai/Mistral-Large-2407]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, mlp="swiglu",
    seq_shard=True, opt_moment_dtype="bfloat16",
    fsdp=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    attn_4d=True, gqa_expand=True, kv_seq_parallel=True,
    train_microbatches=2,
)
