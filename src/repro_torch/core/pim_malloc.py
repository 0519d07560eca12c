"""PIM-malloc-SW state: per-thread freelist frontend over the buddy backend.

Two levels, as in Fig 8 of the paper: per-thread LIFO freelists of
sub-blocks carved from `block_bytes` blocks (frontend), and a shared buddy
allocator with minimum grain `block_bytes` (backend). The batched round
that serves requests against this state is the fused kernel
(`repro_torch.kernels.heap_step`); this module holds the config, the state
layout, the prepopulating `init` and the calloc size guard.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import device as _device
from . import buddy
from .buddy import BuddyConfig, BuddyState

INVALID = -1
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class PimMallocConfig:
    heap_bytes: int = 32 * 1024 * 1024
    num_threads: int = 16          # paper: up to 24 tasklets per DPU
    size_classes: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048)
    block_bytes: int = 4096        # thread-cache refill unit == buddy grain
    cap: int = 1024                # freelist capacity per (thread, class)

    def __post_init__(self):
        if not all(s & (s - 1) == 0 for s in self.size_classes):
            raise ValueError("size classes must be powers of two")
        if tuple(sorted(self.size_classes)) != tuple(self.size_classes):
            raise ValueError("size classes must be ascending")
        if self.block_bytes <= max(self.size_classes):
            raise ValueError("block_bytes must exceed the largest class")
        if self.cap < self.block_bytes // min(self.size_classes):
            raise ValueError("cap must hold a whole carved block")

    @property
    def nc(self) -> int:
        return len(self.size_classes)

    @property
    def nb(self) -> int:  # number of blocks in the heap
        return self.heap_bytes // self.block_bytes

    @property
    def max_sub(self) -> int:  # sub-blocks per block for the smallest class
        return self.block_bytes // min(self.size_classes)

    @property
    def buddy_cfg(self) -> BuddyConfig:
        return BuddyConfig(heap_bytes=self.heap_bytes,
                           min_block=self.block_bytes)


class Stats(NamedTuple):
    front_hits: torch.Tensor
    front_misses: torch.Tensor
    bypass: torch.Tensor
    fails: torch.Tensor
    frees_small: torch.Tensor
    frees_big: torch.Tensor
    dropped_frees: torch.Tensor
    gc_blocks: torch.Tensor


class PimMallocState(NamedTuple):
    buddy: BuddyState
    counts: torch.Tensor      # int32[..., T, NC] free sub-blocks per freelist
    stacks: torch.Tensor      # int32[..., T, NC, CAP] LIFO freelists
    block_cls: torch.Tensor   # int32[..., NB] owning class, -1 if not cached
    block_free: torch.Tensor  # int32[..., NB] free sub-blocks cached per block
    big_log2: torch.Tensor    # int32[..., NB] log2(size) of bypass blocks, -1
    stats: Stats


def init(cfg: PimMallocConfig, prepopulate: bool = True,
         device="cuda") -> PimMallocState:
    """initAllocator() for one core: reset metadata; optionally pre-carve
    one block per (thread, class) freelist, thread-major, in the order of
    the reference's ``meshgrid(..., indexing="ij")`` scan. The carve runs
    on the host; the state is then moved to `device` (the card unless the
    caller asks for the CPU; raises without a GPU)."""
    device = _device.resolve(device)
    T, nc, cap = cfg.num_threads, cfg.nc, cfg.cap
    i32 = torch.int32
    bst = buddy.init(cfg.buddy_cfg, device="cpu")  # the host-side carve
    counts = torch.zeros((T, nc), dtype=i32)
    stacks = torch.full((T, nc, cap), INVALID, dtype=i32)
    block_cls = torch.full((cfg.nb,), INVALID, dtype=i32)
    block_free = torch.zeros((cfg.nb,), dtype=i32)
    big_log2 = torch.full((cfg.nb,), INVALID, dtype=i32)
    if prepopulate:
        for t in range(T):
            for c, csize in enumerate(cfg.size_classes):
                bst, off = buddy.alloc_host(cfg.buddy_cfg, bst,
                                              cfg.block_bytes)
                if off < 0:
                    continue
                sub = cfg.block_bytes // csize
                stacks[t, c, :sub] = torch.arange(sub, dtype=i32) * csize + off
                counts[t, c] = sub
                block_cls[off // cfg.block_bytes] = c
                block_free[off // cfg.block_bytes] = sub
    z = torch.zeros((), dtype=i32, device=device)
    return PimMallocState(
        buddy=BuddyState(longest=bst.longest.to(device)),
        counts=counts.to(device), stacks=stacks.to(device),
        block_cls=block_cls.to(device), block_free=block_free.to(device),
        big_log2=big_log2.to(device), stats=Stats(*([z] * 8)))


def total_calloc_bytes(nmemb, elem_sizes) -> torch.Tensor:
    """nmemb * size in int32 with the C-calloc overflow guard: a wrapping
    product maps to INT32_MAX (which no heap can satisfy), never to a small
    positive size."""
    nmemb = torch.as_tensor(nmemb, dtype=torch.int32)
    elem_sizes = torch.as_tensor(elem_sizes, dtype=torch.int32,
                                 device=nmemb.device)
    prod = nmemb * elem_sizes
    exact = (prod > 0) & (prod // torch.clamp(elem_sizes, min=1) == nmemb)
    requested = (nmemb > 0) & (elem_sizes > 0)
    big = torch.full_like(prod, INT32_MAX)
    return torch.where(requested, torch.where(exact, prod, big),
                       torch.zeros_like(prod))
