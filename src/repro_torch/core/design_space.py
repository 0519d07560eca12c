"""Design-space exploration of PIM memory allocators (Table 1 / Fig 5).

The port of `repro.core.design_space`: plain Python arithmetic over the
configs, with its own copy of the strategies and constants.

Four strategies = {metadata on host | metadata in PIM banks}
              x {allocator executed by host CPU | by PIM cores}
evaluated on the paper's Fig 5 scenario: N PIM cores each requesting 128
identical 32 B allocations concurrently, over the straw-man
buddy_alloc_PIM_DRAM (32 MB heap, min 32 B, 20-level tree).

The *functional* result of all four is identical (same buddy algorithm);
what differs is where metadata lives and who traverses it, i.e. the cost:

  Host-Meta/Host-Exec  : host runs allocs for all N cores with P pthreads;
                         returned ptrs copied HOST2PIM.
  Host-Meta/PIM-Exec   : per-core metadata (512 KB at 2 b/node) shipped
                         HOST2PIM before PIM cores execute locally.
  PIM-Meta/Host-Exec   : metadata shipped PIM2HOST, host executes, metadata
                         + ptrs shipped back HOST2PIM.
  PIM-Meta/PIM-Exec    : fully local + parallel (the paper's winner; flat
                         latency in N) — the design PIM-malloc builds on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .buddy import BuddyConfig
from .cost_model import DPUCost, HostCost, XferCost

STRATEGIES = (
    "host_meta_host_exec",
    "host_meta_pim_exec",
    "pim_meta_host_exec",
    "pim_meta_pim_exec",
)


@dataclasses.dataclass(frozen=True)
class Fig5Scenario:
    n_allocs: int = 128
    alloc_bytes: int = 32
    heap_bytes: int = 32 * 1024 * 1024
    min_block: int = 32

    @property
    def buddy_cfg(self) -> BuddyConfig:
        return BuddyConfig(heap_bytes=self.heap_bytes, min_block=self.min_block)

    @property
    def metadata_bytes_per_core(self) -> int:
        # paper: 2 bits x 2^21 nodes = 512 KB per core for the 32 MB heap
        return self.buddy_cfg.metadata_bytes


def pim_alloc_latency_s(scn: Fig5Scenario, dpu: DPUCost, sw_buf_bytes: int = 512,
                        avg_meta_miss_frac: float = None) -> float:
    """Single straw-man alloc on a DPU (no contention), analytic form.

    Traversal: depth+1 node visits down + depth up. Metadata accesses beyond
    the SW buffer's reach miss and cost a full coarse refill each.
    """
    depth = scn.buddy_cfg.depth
    # levels whose metadata fits in the staging buffer (top of tree is hot)
    nodes_in_buf = sw_buf_bytes * 4  # 2 bits/node -> 4 nodes per byte
    hot_levels = max(int(math.log2(max(nodes_in_buf, 1))), 0)
    visits_down = depth + 1
    visits_up = depth
    total_visits = visits_down + visits_up
    cold = max(total_visits - 2 * hot_levels, 0)
    hot = total_visits - cold
    dma_cyc = dpu.mram_setup_cyc + sw_buf_bytes / dpu.mram_bytes_per_cyc
    cyc = (
        dpu.cyc_mutex
        + total_visits * dpu.cyc_node
        + hot * dpu.cyc_meta_hit
        + cold * dma_cyc
    )
    return cyc / dpu.freq_hz


def host_alloc_latency_s(scn: Fig5Scenario, host: HostCost, n_cores: int) -> float:
    """One alloc executed on the host over N cores' metadata.

    Working set = N x 512 KB >> LLC, so each tree-node visit is DRAM-latency
    bound (pointer-chase); compute overlaps.
    """
    depth = scn.buddy_cfg.depth
    visits = 2 * depth + 1
    per_visit = max(host.dram_latency_s, host.cyc_node / host.freq_hz)
    # small working sets (few cores) partially fit in LLC: scale latency in
    llc_bytes = 32 * 1024 * 1024
    ws = n_cores * scn.metadata_bytes_per_core
    cached_frac = min(llc_bytes / max(ws, 1), 1.0)
    eff = per_visit * (1.0 - 0.9 * cached_frac)
    return visits * max(eff, host.cyc_node / host.freq_hz)


def strategy_latency_s(strategy: str, n_cores: int,
                       scn: Fig5Scenario = Fig5Scenario(),
                       dpu: DPUCost = DPUCost(),
                       host: HostCost = HostCost(),
                       xfer: XferCost = XferCost()) -> Dict[str, float]:
    """End-to-end Fig 5 latency (seconds) + breakdown for one design point."""
    meta_total = n_cores * scn.metadata_bytes_per_core
    ptr_bytes = n_cores * scn.n_allocs * 8

    t_pim_one = pim_alloc_latency_s(scn, dpu)
    t_host_one = host_alloc_latency_s(scn, host, n_cores)

    if strategy == "pim_meta_pim_exec":
        exec_s = scn.n_allocs * t_pim_one  # all cores in parallel
        return {"exec": exec_s, "xfer": 0.0, "total": exec_s}
    if strategy == "host_meta_host_exec":
        exec_s = n_cores * scn.n_allocs * t_host_one / host.threads
        x = xfer.h2p_s(ptr_bytes, n_cores)  # ship returned ptrs to cores
        return {"exec": exec_s, "xfer": x, "total": exec_s + x}
    if strategy == "host_meta_pim_exec":
        x = xfer.h2p_s(meta_total, n_cores)  # ship metadata to cores
        exec_s = scn.n_allocs * t_pim_one
        return {"exec": exec_s, "xfer": x, "total": exec_s + x}
    if strategy == "pim_meta_host_exec":
        x1 = xfer.p2h_s(meta_total, n_cores)   # metadata to host
        exec_s = n_cores * scn.n_allocs * t_host_one / host.threads
        x2 = xfer.h2p_s(meta_total + ptr_bytes, n_cores)  # metadata + ptrs back
        return {"exec": exec_s, "xfer": x1 + x2, "total": exec_s + x1 + x2}
    raise ValueError(strategy)


def sweep(n_cores_list=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512), **kw):
    """Fig 5(a): avg per-alloc latency (us) per strategy vs #cores."""
    scn = kw.pop("scn", Fig5Scenario())
    out = {}
    for s in STRATEGIES:
        out[s] = {}
        for n in n_cores_list:
            r = strategy_latency_s(s, n, scn=scn, **kw)
            out[s][n] = {k: v / scn.n_allocs * 1e6 for k, v in r.items()}
    return out
