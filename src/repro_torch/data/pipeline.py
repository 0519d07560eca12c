"""Deterministic synthetic data pipeline.

The port of `repro.data.pipeline`. `StreamConfig` and `TokenStream` are
the reference's, unchanged: host NumPy from ``Philox(key=seed,
counter=step)``, so every batch is byte-identical to the reference's and a
restore at step k resumes the exact byte stream (the fault-tolerance
invariant). On a live ``("data", "model")`` `DeviceMesh` of processes,
`shard_batch(mesh, batch)` (the reference's) gives each process a DTensor
that holds only its rows, the leading dimension split over every axis
but ``"model"`` (`batch_pspec`); without a mesh, `to_device(batch,
device)` puts the whole batch on one device.
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


def batch_pspec(mesh, batch: dict) -> dict:
    """Each leaf's placement tuple on `mesh` (a live `DeviceMesh`): the
    leading (global-batch) dimension over all non-``"model"`` axes."""
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return {k: (dp,) + (None,) * (np.ndim(v) - 1) for k, v in batch.items()}


def shard_batch(mesh, batch: dict) -> dict:
    """A host batch as DTensors on `mesh` by `batch_pspec`: each process
    copies only its own rows to its device. The batch must split evenly
    over the data axes."""
    from ..parallel.sharding import mesh_device, named
    placed = named(mesh, batch_pspec(mesh, batch))
    dev = mesh_device(mesh)
    dp = mesh.size() // mesh.size(mesh.mesh_dim_names.index("model")) \
        if "model" in mesh.mesh_dim_names else mesh.size()
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % dp:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} rows, not "
                             f"divisible over the {dp} data positions")
        out[k] = placed[k].place(torch.from_numpy(v), device=dev)
    return out


def to_device(batch: dict, device="cuda") -> dict:
    """A host batch's arrays as tensors on `device` (the card unless the
    caller asks for the CPU), dtypes kept."""
    dev = _device.resolve(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}
