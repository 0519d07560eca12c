"""paligemma-3b [vlm] — SigLIP patch STUB + gemma decoder (MQA kv=1).
[arXiv:2407.07726]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, mlp="geglu", n_patches=256,
    tie_embeddings=True,
    # SSPerf-validated optimized defaults (baseline: override these False)
    kv_seq_parallel=True  # attn_4d off: H<16 heads cannot shard,
)
