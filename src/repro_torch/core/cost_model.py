"""DPU cycle cost model (UPMEM-PIM timing, Table 3 of the paper).

Latencies are modeled DPU cycles derived from the functional round's
counters, not device time. Every term is an integer or a half (odd calloc
sizes over 2 B/cycle), far below 2^24, so the float32 sums are exact in
any order and match the reference bitwise. `HostCost` and `XferCost`
model the host CPU and host <-> PIM transfers for the design-space study
(`repro_torch.core.design_space`).
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
    # arena frontend (bump pointer), the reference's arena kinds
    cyc_bump: int = 6            # size-class calc + bump-pointer add
    cyc_bump_atomic: int = 2     # per-contender serialization on the add
    cyc_epoch_reset: int = 64    # rewind + epoch counter + map clear
    # MRAM (per-bank DRAM) DMA
    mram_setup_cyc: int = 88     # ~250 ns engine setup
    mram_bytes_per_cyc: float = 2.0   # ~700 MB/s per-DPU streaming


@dataclasses.dataclass(frozen=True)
class HostCost:
    freq_hz: float = 3.8e9
    threads: int = 16            # pthreads running host-executed allocs
    dram_latency_s: float = 80e-9  # random access: a traversal over N
    # cores' metadata (N x 512 KB >> LLC) is latency-bound per node visit
    cyc_node: int = 8            # OoO core per-level compute, overlapped


@dataclasses.dataclass(frozen=True)
class XferCost:
    """host <-> PIM transfers (dpu_push_xfer): PrIM-style bandwidth
    curves."""

    setup_s: float = 20e-6
    h2p_per_core_gbs: float = 0.33
    h2p_cap_gbs: float = 6.7
    p2h_per_core_gbs: float = 0.25
    p2h_cap_gbs: float = 4.7

    def h2p_s(self, bytes_total: float, n_cores: int) -> float:
        bw = min(self.h2p_per_core_gbs * n_cores, self.h2p_cap_gbs) * 1e9
        return self.setup_s + bytes_total / bw

    def p2h_s(self, bytes_total: float, n_cores: int) -> float:
        bw = min(self.p2h_per_core_gbs * n_cores, self.p2h_cap_gbs) * 1e9
        return self.setup_s + bytes_total / bw


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


def round_latency_cyc(cost: DPUCost, path, backend_pos, backend_cyc):
    """Per-thread latency for one request round, including mutex busy-wait.

    path int32[..., T] (0 hit / 1 refill / 2 bypass / 3 fail / -1 idle),
    backend_pos the serialization order among backend users (-1 =
    frontend only), backend_cyc float32 own backend service cycles. A
    backend user at position k busy-waits for the service of positions
    < k (the paper's Fig 7 'lock' time)."""
    used = backend_pos >= 0
    key = torch.where(used, backend_pos, 1 << 30)
    order = torch.argsort(key, dim=-1, stable=True)
    svc = backend_cyc.to(torch.float32).gather(-1, order)
    wait = torch.zeros_like(svc).scatter(-1, order, torch.cumsum(svc, -1)
                                         - svc)
    zero = torch.zeros_like(wait)
    wait = torch.where(used, wait, zero)
    own = (torch.where(path == 0, zero + cost.cyc_front_hit, zero)
           + torch.where(path == 1,
                         zero + (cost.cyc_front_hit + cost.cyc_refill), zero)
           + backend_cyc)
    return torch.where(path >= 0, own + wait, zero)


def cyc_to_us(cost: DPUCost, cyc) -> torch.Tensor:
    return torch.as_tensor(cyc, dtype=torch.float32) / cost.freq_hz * 1e6
