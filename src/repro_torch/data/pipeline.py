"""Deterministic synthetic data pipeline.

The port of `repro.data.pipeline`. `StreamConfig` and `TokenStream` are
the reference's, unchanged: host NumPy from ``Philox(key=seed,
counter=step)``, so every batch is byte-identical to the reference's and a
restore at step k resumes the exact byte stream (the fault-tolerance
invariant). The reference's `shard_batch(mesh, batch)` becomes
`to_device(batch, device)`: one device, no mesh (its `batch_pspec` waits
for ROADMAP A7b).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    d_model: int = 0          # for frontend-stub streams
    enc_frames: int = 0
    n_patches: int = 0
    dtype: str = "bfloat16"


class TokenStream:
    """Stateless-per-step synthetic LM stream: batch(step) is pure."""

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        toks = rng.integers(0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len),
                            dtype=np.int32)
        out = {"tokens": toks, "labels": toks.copy()}
        if cfg.enc_frames:
            out["enc_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.enc_frames, cfg.d_model),
                dtype=np.float32)
        if cfg.n_patches:
            out["patch_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.n_patches, cfg.d_model),
                dtype=np.float32)
        return out


def to_device(batch: dict, device="cuda") -> dict:
    """A host batch's arrays as tensors on `device` (the card unless the
    caller asks for the CPU), dtypes kept."""
    dev = _device.resolve(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}
