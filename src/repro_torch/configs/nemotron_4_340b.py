"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]

Largest assigned arch: sequence-sharded residual (Megatron-SP) and bf16
optimizer moments are on by default so train_4k fits 256 x 16 GB HBM.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab=256000, head_dim=192, mlp="squared_relu",
    seq_shard=True, opt_moment_dtype="bfloat16",
    fsdp=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    attn_4d=True, gqa_expand=True, kv_seq_parallel=True,
    train_microbatches=2,
)
