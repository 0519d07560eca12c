"""whisper-small [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356]

enc_frames padded 1500 -> 1536 for block-divisible flash cross-attention.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, head_dim=64, mlp="gelu", enc_layers=12, enc_frames=1536,
    tie_embeddings=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    kv_seq_parallel=True  # attn_4d off: H<16 heads cannot shard,
)
