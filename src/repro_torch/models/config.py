"""Architecture configuration: one frozen dataclass drives every family.

A copy of the reference's `repro.models.config` (plain dataclasses; the port
imports nothing of the reference). `reduced()` returns the smoke-test scale
config of the same family (small layers and widths, few experts, a tiny
vocab) that the CPU tests use; the full configs run on the card.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "ssm", "hybrid", "audio", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | geglu | squared_relu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 2048            # tokens per dispatch group (memory bound)
    moe_parallel_groups: int = 16    # groups processed per scan step (vmapped;
                                     # keeps the group dim data-sharded)
    pad_experts_to: int = 16         # pad expert count to a TP-divisible
                                     # multiple (dummy experts never routed)
    train_microbatches: int = 0      # 0 = auto; SP archs use fewer, larger
                                     # microbatches (per-micro grad reduces
                                     # dominate otherwise — SSPerf)
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128             # SSD chunk length
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    attn_period: int = 0             # 3 -> every 3rd layer is local attention
    window: int = 2048               # local attention window
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500           # stub audio frontend frames
    # --- VLM (paligemma) ---
    n_patches: int = 0               # stub SigLIP patch embeddings
    # --- numerics & distribution ---
    dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = False               # shard params+opt over 'data' too (ZeRO-3)
    seq_shard: bool = False          # Megatron-SP: shard residual seq over model
    page_size: int = 128             # paged-KV page tokens
    attend_impl: str = "ref"         # paged decode attention: 'ref' | 'kernel'
    opt_moment_dtype: str = "float32"
    pad_vocab_to: int = 256          # Megatron-style vocab padding (clean TP)
    attn_4d: bool = False            # [D,H,hd] attention weights (SSPerf iter)
    flash_min_seq: int = 8193        # flash attention above this many tokens
    kv_seq_parallel: bool = False    # shard_map flash-decoding (SSPerf iter)
    gqa_expand: bool = False         # expand KV to H heads pre-attention so
                                     # every S^2 tensor shards on 'model' (SSPerf)

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        p = self.pad_vocab_to
        return -(-self.vocab // p) * p

    @property
    def padded_experts(self) -> int:
        p = max(self.pad_experts_to, 1)
        return -(-self.n_experts // p) * p

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is runnable (constant-ish per-token state)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        return dataclasses.replace(
            self,
            # hybrid keeps one full (rec, rec, attn) group
            n_layers=3 if self.family == "hybrid" else min(self.n_layers, 2),
            d_model=128,
            n_heads=max(min(self.n_heads, 4), 1),
            n_kv_heads=max(min(self.n_kv_heads, 2), 1) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=64 if self.expert_d_ff else 0,
            moe_group=64,
            pad_experts_to=1,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            window=32,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=16 if self.enc_frames else 0,
            n_patches=min(self.n_patches, 8),
            dtype="float32",
            remat=False,
            seq_shard=False,
            page_size=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
