"""Allocator design points behind the protocol, priced by the DPU cost model.

  fused : PIM-malloc-HW/SW semantics (per-thread freelists, buddy backend,
          16-entry LRU buddy cache) served by ONE fused round per call
          (`repro_torch.kernels.heap_step`): the hand-written CUDA kernel on
          the card, its plain PyTorch version on CPU tensors. The
          counterpart of the reference's ``pallas`` kind, and bitwise-equal
          to its ``hwsw`` kind.

A step serves one mixed-op round for C cores at once (``[C, T]`` requests),
persists the metadata-cache state across rounds, and returns per-thread
latencies including mutex busy-wait, payload-copy DMA for relocating
reallocs, and zero-fill DMA for callocs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from . import buddy_cache, cost_model, heap, pim_malloc
from .buddy import BuddyState
from .buddy_cache import BuddyCacheConfig
from .cost_model import DPUCost
from .heap import (OP_CALLOC, OP_FREE, OP_MALLOC, OP_NOOP, OP_REALLOC,
                   AllocRequest, AllocResponse)
from .pim_malloc import INVALID, PimMallocConfig


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    kind: str = "fused"
    heap_bytes: int = 32 * 1024 * 1024
    num_threads: int = 16
    pm: PimMallocConfig = None
    bc: BuddyCacheConfig = BuddyCacheConfig()
    dpu: DPUCost = DPUCost()
    # the fused round's batched run-carve refill (kind ``fused``). None
    # defers to PIM_MALLOC_BATCH_REFILL (default on); False forces the
    # serial walk. Bitwise-identical either way: a speed knob, not a
    # semantic one.
    kernel_batch_refill: bool | None = None

    def __post_init__(self):
        heap._ensure_backends()
        if self.kind not in heap.REGISTRY:
            raise ValueError(f"unknown kind {self.kind!r} "
                             f"(registered: {tuple(heap.REGISTRY)})")
        if self.pm is None:
            object.__setattr__(self, "pm", PimMallocConfig(
                heap_bytes=self.heap_bytes, num_threads=self.num_threads))

    @property
    def dma_bytes_per_miss(self) -> int:
        return buddy_cache.WORD_BYTES


class HeapTelemetry(NamedTuple):
    """Per-core heap-health counters in rounded allocator bytes: live bytes
    and their high-water mark (int32[C]). For a well-formed stream

        live_bytes + buddy free bytes + cached thread-cache bytes
            == heap_bytes

    after every round (see `repro_torch.core.telemetry`)."""

    live_bytes: torch.Tensor
    hwm_bytes: torch.Tensor


def _advance_telemetry(t: HeapTelemetry, alloc_bytes, freed_bytes):
    live = t.live_bytes + alloc_bytes - freed_bytes
    return HeapTelemetry(live_bytes=live,
                         hwm_bytes=torch.maximum(t.hwm_bytes, live))


class SystemState(NamedTuple):
    alloc: pim_malloc.PimMallocState
    cache: buddy_cache.BuddyCacheState
    telem: HeapTelemetry


def system_init(cfg: SystemConfig, prepopulate: bool = True,
                num_cores: int = 1, device="cuda") -> SystemState:
    """One core's initial state, stacked to ``[num_cores, ...]`` leaves, on
    `device` (the card unless the caller asks for the CPU; raises without a
    GPU)."""
    device = _device.resolve(device)
    z = torch.zeros((), dtype=torch.int32, device=device)
    one = SystemState(
        alloc=pim_malloc.init(cfg.pm, prepopulate=prepopulate, device=device),
        cache=buddy_cache.buddy_cache_init(cfg.bc, device=device),
        telem=HeapTelemetry(live_bytes=z, hwm_bytes=z))
    return _stack(one, num_cores)


def _stack(tree, n):
    if isinstance(tree, torch.Tensor):
        return tree.unsqueeze(0).expand((n,) + tree.shape).contiguous()
    return type(tree)(*(_stack(x, n) for x in tree))


def _price_round(cfg: SystemConfig, req: AllocRequest, *, mptrs, m_path,
                 m_bpos, m_lvdown, m_lvup, fpath, f_bpos, f_lvup, hits_m,
                 miss_m, dram_m, hits_f, miss_f, dram_f, in_place, moved,
                 mok, valid_old, old_bytes, new_bytes, re_free0):
    """Price one ``[C, T]`` round; returns (AllocResponse, alloc_bytes[C],
    freed_bytes[C]) — the heap-telemetry deltas in rounded bytes.

    Float32 terms are integers or halves far below 2^24, so every sum is
    exact and the latencies equal the reference's bitwise."""
    op, size, ptr = req.op, req.size, req.ptr
    f32 = torch.float32
    is_alloc = (op == OP_MALLOC) | (op == OP_CALLOC)
    is_free = op == OP_FREE
    T = op.shape[-1]

    n_back_m = (m_bpos >= 0).sum(-1, keepdim=True, dtype=torch.int32)
    bpos = torch.cat([m_bpos, torch.where(f_bpos >= 0, f_bpos + n_back_m,
                                          torch.full_like(f_bpos, INVALID))],
                     -1)
    zf = torch.zeros(op.shape, dtype=f32, device=op.device)
    cyc_m = cost_model.backend_op_cyc(cfg.dpu, m_lvdown, m_lvup, hits_m,
                                      miss_m, dram_m)
    cyc_m = torch.where(m_bpos >= 0, cyc_m, zf)
    cyc_f = cost_model.backend_op_cyc(cfg.dpu, torch.zeros_like(f_lvup),
                                      f_lvup, hits_f, miss_f, dram_f)
    cyc_f = torch.where(f_bpos >= 0, cyc_f, zf)

    # mutex busy-wait: position k waits for the service of positions < k
    svc = torch.cat([cyc_m, cyc_f], -1)
    key = torch.where(bpos >= 0, bpos, torch.full_like(bpos, 1 << 30))
    order = torch.argsort(key, dim=-1, stable=True)
    svc_sorted = svc.gather(-1, order)
    wait_sorted = torch.cumsum(svc_sorted, -1) - svc_sorted
    wait = torch.zeros_like(svc).scatter(-1, order, wait_sorted)
    wait = torch.where(bpos >= 0, wait, torch.zeros_like(wait))
    wait_m, wait_f = wait[..., :T], wait[..., T:]

    dpu = cfg.dpu
    own_m = (torch.where(m_path == 0, zf + dpu.cyc_front_hit, zf)
             + torch.where(m_path == 1,
                           zf + (dpu.cyc_front_hit + dpu.cyc_refill), zf)
             + cyc_m)
    lat_m = torch.where(m_path >= 0, own_m + wait_m, zf)
    own_f = torch.where(fpath == 0, zf + dpu.cyc_front_push, zf) + cyc_f
    lat_f = torch.where(fpath >= 0, own_f + wait_f, zf)
    # relocating realloc DMAs the surviving payload; calloc zero-fills
    copy_cyc = torch.where(
        moved & mok & valid_old,
        cost_model.mram_access_cyc(dpu, torch.minimum(old_bytes, new_bytes)),
        zf)
    zero_cyc = torch.where((op == OP_CALLOC) & mok,
                           cost_model.mram_access_cyc(dpu, size), zf)
    # in-place realloc: O(1) metadata peek, no heap traffic
    inplace_cyc = torch.where(in_place, zf + dpu.cyc_front_hit, zf)
    latency = lat_m + lat_f + copy_cyc + zero_cyc + inplace_cyc

    m_active = (is_alloc & (size > 0)) | moved
    neg = torch.full_like(ptr, INVALID)
    out_ptr = torch.where(is_alloc & mok, mptrs,
                          torch.where(in_place, ptr,
                                      torch.where(moved & mok, mptrs, neg)))
    served_free = (fpath == 0) | (fpath == 1)
    ok = (is_alloc & mok) | in_place | (moved & mok) | (
        (is_free | re_free0) & served_free)
    path = torch.where(m_active, m_path,
                       torch.where(is_free | re_free0, fpath,
                                   torch.where(in_place,
                                               torch.zeros_like(neg), neg)))
    # telemetry deltas: rounded bytes handed out / returned this round; a
    # capacity-dropped free (fpath 2) leaks its block, which stays live
    new_alloc = (is_alloc & mok) | (moved & mok)
    zi = torch.zeros_like(new_bytes)
    alloc_bytes = torch.where(new_alloc, new_bytes, zi).sum(
        -1, dtype=torch.int32)
    freed_served = (is_free | re_free0 | (moved & mok & valid_old)) & \
        served_free
    freed_bytes = torch.where(freed_served, old_bytes, zi).sum(
        -1, dtype=torch.int32)
    resp = AllocResponse(
        ptr=out_ptr, ok=ok, path=path.to(torch.int32), moved=moved & mok,
        latency_cyc=latency, backend_cyc=cyc_m + cyc_f,
        meta_hits=hits_m + hits_f, meta_misses=miss_m + miss_f,
        dram_bytes=dram_m + dram_f)
    return resp, alloc_bytes, freed_bytes


@heap.register("fused")
def _step_fused(cfg: SystemConfig, st: SystemState, req: AllocRequest):
    """The fused-kernel design point: hwsw semantics, one kernel launch.

    The whole round runs in `fused_heap_step`; this wrapper rebuilds the
    state tree from its outputs, folds its per-thread records into the
    allocator stats, and prices the round. The nine allocator and cache
    tensors of `st` are updated in place, on either device."""
    from ..kernels import heap_step

    pmc = cfg.pm
    al, ca = st.alloc, st.cache
    out = heap_step.fused_heap_step(
        req.op, req.size, req.ptr, al.buddy.longest, al.counts, al.stacks,
        al.block_cls, al.block_free, al.big_log2, ca.tags, ca.last_used,
        ca.clock, heap_bytes=pmc.heap_bytes, block_bytes=pmc.block_bytes,
        size_classes=pmc.size_classes, batch_refill=cfg.kernel_batch_refill)

    b = lambda x: x.to(torch.bool)  # noqa: E731
    m_hit, m_refill, m_bypass, m_okb = (b(out.m_hit), b(out.m_refill),
                                        b(out.m_bypass), b(out.m_okb))
    f_push, f_big = b(out.f_push), b(out.f_big)
    in_place, moved, valid_old = (b(out.in_place), b(out.moved_raw),
                                  b(out.valid_old))

    need = m_refill | m_bypass
    is_alloc = (req.op == OP_MALLOC) | (req.op == OP_CALLOC)
    m_active = (is_alloc & (req.size > 0)) | moved
    too_big = m_active & (req.size > pmc.heap_bytes)
    def full(v):
        return torch.full_like(req.op, v)

    m_path = torch.where(
        m_hit, full(0),
        torch.where(m_refill & m_okb, full(1),
                    torch.where(m_bypass & m_okb, full(2),
                                torch.where(need | too_big, full(3),
                                            full(INVALID)))))
    mok = m_active & (out.m_ptr >= 0)
    re_free0 = (req.op == OP_REALLOC) & (req.size <= 0) & (req.ptr >= 0)
    # every requested free that neither pushed nor reached the buddy is
    # dropped (NULL == -1 exempt)
    f_active = (req.op == OP_FREE) | (moved & valid_old & mok) | re_free0
    f_drop = f_active & (req.ptr != -1) & ~f_push & ~f_big
    fpath = torch.where(f_push, full(0),
                        torch.where(f_big, full(1),
                                    torch.where(f_drop, full(2),
                                                full(INVALID))))

    def count(m):
        return m.sum(-1, dtype=torch.int32)

    s = al.stats
    stats = s._replace(
        front_hits=s.front_hits + count(m_hit),
        front_misses=s.front_misses + count(m_refill),
        bypass=s.bypass + count(m_bypass),
        fails=s.fails + count((need & ~m_okb) | too_big),
        frees_small=s.frees_small + count(f_push),
        frees_big=s.frees_big + count(f_big),
        dropped_frees=s.dropped_frees + count(f_drop))
    new_alloc = pim_malloc.PimMallocState(
        buddy=BuddyState(longest=out.longest), counts=out.counts,
        stacks=out.stacks, block_cls=out.block_cls,
        block_free=out.block_free, big_log2=out.big_log2, stats=stats)
    new_cache = buddy_cache.BuddyCacheState(
        tags=out.tags, last_used=out.last_used, clock=out.clock)

    dma = cfg.dma_bytes_per_miss
    resp, alloc_bytes, freed_bytes = _price_round(
        cfg, req, mptrs=out.m_ptr, m_path=m_path, m_bpos=out.m_bpos,
        m_lvdown=out.m_lvdown, m_lvup=out.m_lvup, fpath=fpath,
        f_bpos=out.f_bpos, f_lvup=out.f_lvup,
        hits_m=out.m_hits, miss_m=out.m_miss, dram_m=out.m_miss * dma,
        hits_f=out.f_hits, miss_f=out.f_miss, dram_f=out.f_miss * dma,
        in_place=in_place, moved=moved, mok=mok, valid_old=valid_old,
        old_bytes=out.old_bytes, new_bytes=out.new_bytes, re_free0=re_free0)
    telem = _advance_telemetry(st.telem, alloc_bytes, freed_bytes)
    return SystemState(alloc=new_alloc, cache=new_cache, telem=telem), resp


def fleet_accounting(req: AllocRequest, resp: AllocResponse) -> dict:
    """Cost-model accounting of one batched round (any leading shape)."""
    def np_(x):
        return x.detach().cpu().numpy()

    op = np_(req.op)
    active = op != OP_NOOP
    lat = np_(resp.latency_cyc)
    return {
        "ops": int(active.sum()),
        "ok": int(np_(resp.ok).sum()),
        "latency_cyc": float(lat.sum()),
        "max_latency_cyc": float(lat.max()) if lat.size else 0.0,
        "backend_cyc": float(np_(resp.backend_cyc).sum()),
        "meta_hits": int(np_(resp.meta_hits).sum()),
        "meta_misses": int(np_(resp.meta_misses).sum()),
        "dram_bytes": int(np.asarray(np_(resp.dram_bytes), np.int64).sum()),
    }
