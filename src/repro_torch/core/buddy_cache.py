"""The HW/SW design point's 16-entry LRU buddy cache: config and state.

A fully-associative CAM of 4-byte metadata words (16 tree nodes per word,
2 bits per node) with true LRU replacement; the access itself runs inside
the fused round (`repro_torch.kernels.heap_step`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import device as _device

NODES_PER_WORD = 16  # 2 bits/node, 4-byte words
WORD_BYTES = 4


@dataclasses.dataclass(frozen=True)
class BuddyCacheConfig:
    n_entries: int = 16  # 16 x 4 B = 64 B (paper's design point)


class BuddyCacheState(NamedTuple):
    tags: torch.Tensor       # int32[..., E] word addresses, -1 invalid
    last_used: torch.Tensor  # int32[..., E] LRU timestamps (-1 = first victim)
    clock: torch.Tensor      # int32[...] access counter


def buddy_cache_init(cfg: BuddyCacheConfig, device="cuda") -> BuddyCacheState:
    """An empty cache on `device` (the card unless the caller asks for the
    CPU; raises without a GPU)."""
    device = _device.resolve(device)
    e = cfg.n_entries
    return BuddyCacheState(
        tags=torch.full((e,), -1, dtype=torch.int32, device=device),
        last_used=torch.full((e,), -1, dtype=torch.int32, device=device),
        clock=torch.zeros((), dtype=torch.int32, device=device))
