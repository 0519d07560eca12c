"""Array buddy allocator (the backend), the part the fused round needs.

Same ``longest[]`` encoding as `repro.core.buddy`: ``longest[i]`` is the size
in bytes of the largest free block under tree node ``i`` (1-indexed, root =
1, slot 0 unused). The batched alloc/free walks of a round live in the fused
kernel and its plain version (`repro_torch.kernels.heap_step`); this module
keeps the geometry, the initial tree, the int32 bit helpers, and the serial
host-side `alloc` that `pim_malloc.init` carves its prepopulated blocks with.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device

INVALID = -1


def next_pow2(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x, by int32 bit-smear.

    Inputs above 2^30 wrap to INT32_MIN, exactly as the reference does
    (the REALLOC-of-INT32_MAX request reaches this)."""
    x = torch.clamp(x.to(torch.int32), min=1) - 1
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return x + 1


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """log2 of a power-of-two int32, as ``popcount(x - 1)``.

    torch has no popcount, so the 32 bits are summed; INT32_MIN gives 31,
    as in the reference."""
    v = x.to(torch.int32) - 1
    shifts = torch.arange(32, dtype=torch.int32, device=v.device)
    return ((v.unsqueeze(-1) >> shifts) & 1).sum(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class BuddyConfig:
    """Static heap geometry. depth = log2(heap/min_block) levels below root."""

    heap_bytes: int
    min_block: int

    def __post_init__(self):
        if self.heap_bytes & (self.heap_bytes - 1):
            raise ValueError("heap must be pow2")
        if self.min_block & (self.min_block - 1):
            raise ValueError("min_block must be pow2")
        if self.heap_bytes < self.min_block:
            raise ValueError("heap smaller than min_block")

    @property
    def depth(self) -> int:
        return (self.heap_bytes // self.min_block).bit_length() - 1

    @property
    def n_leaf(self) -> int:
        return self.heap_bytes // self.min_block

    @property
    def n_nodes(self) -> int:  # 1-indexed array size (slot 0 unused)
        return 2 * self.n_leaf


class BuddyState(NamedTuple):
    longest: torch.Tensor  # int32[..., n_nodes]


def init(cfg: BuddyConfig, device="cuda") -> BuddyState:
    """The all-free tree on `device` (the card unless the caller asks for
    the CPU; raises without a GPU)."""
    dev = _device.resolve(device)
    idx = np.arange(cfg.n_nodes)
    level = np.zeros(cfg.n_nodes, np.int64)
    level[1:] = np.floor(np.log2(idx[1:])).astype(np.int64)
    longest = np.where(idx > 0, cfg.heap_bytes >> level, 0).astype(np.int32)
    return BuddyState(longest=torch.from_numpy(longest).to(dev))


def alloc(cfg: BuddyConfig, st: BuddyState, size: int):
    """Serial leftmost-fit allocation of `size` bytes on a host tree.

    Returns (state, offset); offset is -1 on failure. Host-side set-up code
    (the prepopulate carve): `st.longest` must be a 1-D CPU tensor."""
    size = max(int(next_pow2(torch.tensor([size]))[0]), cfg.min_block)
    longest = st.longest.clone()
    lg = longest.numpy()
    if size > cfg.heap_bytes or lg[1] < size:
        return BuddyState(longest=longest), INVALID
    node, node_size = 1, cfg.heap_bytes
    while node_size > size:
        node = 2 * node if lg[2 * node] >= size else 2 * node + 1
        node_size >>= 1
    offset = node * node_size - cfg.heap_bytes
    lg[node] = 0
    while node > 1:
        node >>= 1
        lg[node] = max(lg[2 * node], lg[2 * node + 1])
    return BuddyState(longest=longest), offset
