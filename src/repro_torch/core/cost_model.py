"""DPU cycle cost model (UPMEM-PIM timing, Table 3 of the paper).

Latencies are modeled DPU cycles derived from the functional round's
counters, not device time. Every term is an integer or a half (odd calloc
sizes over 2 B/cycle), far below 2^24, so the float32 sums are exact in
any order and match the reference bitwise.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DPUCost:
    freq_hz: float = 350e6
    # frontend (thread cache)
    cyc_front_hit: int = 30      # size-class calc + LIFO pop + counters
    cyc_front_push: int = 26     # free-path push
    cyc_refill: int = 190        # carve a 4 KB block into sub-blocks
    # backend (buddy)
    cyc_node: int = 40           # per-level compare/branch/address arithmetic
    cyc_meta_hit: int = 2        # metadata access served from the buddy cache
    cyc_mutex: int = 44          # mutex acquire/release (WRAM atomic rmw)
    # MRAM (per-bank DRAM) DMA
    mram_setup_cyc: int = 88     # ~250 ns engine setup
    mram_bytes_per_cyc: float = 2.0   # ~700 MB/s per-DPU streaming


def mram_access_cyc(cost: DPUCost, bytes_moved: torch.Tensor) -> torch.Tensor:
    """Cycles for one DMA moving `bytes_moved` (0 -> 0 cycles)."""
    b = bytes_moved.to(torch.float32)
    return torch.where(b > 0, cost.mram_setup_cyc + b / cost.mram_bytes_per_cyc,
                       torch.zeros_like(b))


def backend_op_cyc(cost: DPUCost, levels_down, levels_up, meta_hits,
                   meta_misses, dram_bytes) -> torch.Tensor:
    """Cycles for one buddy operation (excluding queuing): one DMA per
    metadata miss, `cyc_meta_hit` per hit."""
    levels = (levels_down + levels_up).to(torch.float32)
    dma_cyc = meta_misses.to(torch.float32) * cost.mram_setup_cyc + (
        dram_bytes.to(torch.float32) / cost.mram_bytes_per_cyc)
    meta_cyc = meta_hits.to(torch.float32) * cost.cyc_meta_hit
    return cost.cyc_mutex + (levels + 1.0) * cost.cyc_node + meta_cyc + dma_cyc
