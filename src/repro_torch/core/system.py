"""Allocator design points behind the protocol, priced by the DPU cost model.

The port of `repro.core.system`:

  strawman : buddy_alloc_PIM_DRAM, a single-level buddy over the whole
             heap, min block 32 B (a 20-level tree for 32 MiB), a shared
             mutex, the coarse SW metadata buffer (Sections 3.2-3.3).
  sw       : PIM-malloc-SW, per-thread caches over a 13-level buddy
             backend, the coarse SW metadata buffer (Section 4.1).
  hwsw     : PIM-malloc-HW/SW, the same frontend and backend, the backend's
             metadata served by the 16-entry LRU buddy cache (Section 4.2).
  sanitizer: hwsw wrapped in a shadow map and a quarantine ring
             (`repro_torch.core.sanitizer`): double free, use after free,
             realloc after free and wild pointers become deterministic
             tagged reports.
  arena    : a shared bump-pointer region in front of the full hwsw stack
             (`repro_torch.core.arena`): small allocs in O(1), whole
             epochs retired by one EPOCH_RESET op, the rest spilled to the
             backend (``arena_inner``: ``hwsw`` or ``fused``).
  tlregion : the arena frontend with one region per thread: no
             cross-thread atomic on the bump path, per-thread resets.
  fused    : hwsw semantics served by ONE fused round per call
             (`repro_torch.kernels.heap_step`): the hand-written CUDA kernel
             on the card, its plain PyTorch version on CPU tensors. The
             counterpart of the reference's ``pallas`` kind, and
             bitwise-equal to ``hwsw``.

The scan-based rounds (`_protocol_round` over `pim_malloc` or the
straw-man allocator, then one metadata-cache pass over the round's backend
ops in mutex order) and the three wrapper kinds are plain PyTorch ops on an
explicit core axis, on whichever device the state lives; they launch no
kernel of their own, except the arena kinds' spills when ``arena_inner``
is ``fused``.

A step serves one mixed-op round for C cores at once (``[C, T]`` requests),
persists the metadata-cache state across rounds, and returns per-thread
latencies including mutex busy-wait, payload-copy DMA for relocating
reallocs, and zero-fill DMA for callocs. `malloc_round` / `free_round`
and the two round drivers are single-op conveniences over `heap.step`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from . import buddy, buddy_cache, cost_model, heap, pim_malloc
from .buddy import BuddyConfig, BuddyState, _put, ilog2, next_pow2
from .buddy_cache import (BuddyCacheConfig, SWBufferConfig,
                          buddy_cache_access, buddy_cache_init,
                          sw_buffer_access, sw_buffer_init)
from .cost_model import DPUCost
from .heap import (OP_CALLOC, OP_FREE, OP_MALLOC, OP_NOOP, OP_REALLOC,
                   AllocRequest, AllocResponse)
from .pim_malloc import INVALID, PimMallocConfig



# The kinds have one source of truth, the protocol registry
# (`heap.REGISTRY`, filled by the `@heap.register` decorators below):
# `KINDS` is read from it on attribute access (PEP 562), as the
# reference's is, with ``fused`` where the reference says ``pallas``.
def __getattr__(name: str):
    if name == "KINDS":
        return heap.kinds()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# kinds whose backend metadata goes through the LRU buddy cache
HW_CACHE_KINDS = ("hwsw", "fused", "sanitizer", "arena", "tlregion")
# the backends an arena kind can spill to (the reference's "pallas" is the
# port's "fused")
ARENA_INNER = ("hwsw", "fused")


# --------------------------------------------------------------------------
# Straw-man allocator: buddy-only over the full heap, min 32 B
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StrawmanConfig:
    heap_bytes: int = 32 * 1024 * 1024
    num_threads: int = 16
    min_block: int = 32

    @property
    def buddy_cfg(self) -> BuddyConfig:
        return BuddyConfig(heap_bytes=self.heap_bytes,
                           min_block=self.min_block)


class StrawmanState(NamedTuple):
    buddy: BuddyState
    leaf_log2: torch.Tensor  # int8[..., n_leaf] size exponent at base leaf


def strawman_init(cfg: StrawmanConfig, device="cuda") -> StrawmanState:
    """One core's empty straw-man heap on `device` (the card unless the
    caller asks for the CPU; raises without a GPU)."""
    device = _device.resolve(device)
    return StrawmanState(
        buddy=buddy.init(cfg.buddy_cfg, device=device),
        leaf_log2=torch.full((cfg.buddy_cfg.n_leaf,), -1, dtype=torch.int8,
                             device=device))


def strawman_malloc(cfg: StrawmanConfig, st: StrawmanState, sizes,
                    active=None):
    """One all-malloc round of ``[C, T]`` threads, each request a buddy
    walk, in thread (mutex) order. Consumes `st` (its tree and leaf table
    are updated in place). Returns (state, ptrs, MallocEvent)."""
    C, T = sizes.shape
    dev = sizes.device
    i32 = torch.int32
    if active is None:
        active = torch.ones((C, T), dtype=torch.bool, device=dev)
    requested = active & (sizes > 0)
    # heap-exceeding sizes fail without reaching next_pow2 (wraps > 2^30)
    active = requested & (sizes <= cfg.heap_bytes)
    bcfg = cfg.buddy_cfg
    longest, leaf_log2 = st.buddy.longest, st.leaf_log2
    ptrs = torch.full((C, T), INVALID, dtype=i32, device=dev)
    bpos = ptrs.clone()
    lv_down = torch.zeros((C, T), dtype=i32, device=dev)
    lv_up = lv_down.clone()
    trace = torch.full((C, T, bcfg.trace_len), INVALID, dtype=i32,
                       device=dev)
    ok_all = torch.zeros((C, T), dtype=torch.bool, device=dev)
    border = torch.zeros((C,), dtype=i32, device=dev)
    for t, used in enumerate(active.any(0).tolist()):
        if not used:
            continue  # no core sends this thread to the backend: a no-op
        need, size = active[:, t], sizes[:, t]
        off, bev = buddy._alloc_(bcfg, longest, size, live=need)
        ok = need & (off >= 0)
        leaf = torch.where(ok, off // cfg.min_block, 0)
        lg = ilog2(next_pow2(torch.clamp(size, min=cfg.min_block)))
        _put(leaf_log2, leaf, lg.to(torch.int8), ok)
        ptrs[:, t] = torch.where(ok, off, INVALID)
        bpos[:, t] = torch.where(need, border, INVALID)
        border += need.to(i32)
        lv_down[:, t] = torch.where(need, bev.levels_down, 0)
        lv_up[:, t] = torch.where(need, bev.levels_up, 0)
        trace[:, t] = torch.where(need[:, None], bev.trace, INVALID)
        ok_all[:, t] = ok
    path = torch.where(active & ok_all, 2,
                       torch.where(requested, 3, INVALID)).to(i32)
    ev = pim_malloc.MallocEvent(path=path, backend_pos=bpos,
                                levels_down=lv_down, levels_up=lv_up,
                                trace=trace)
    return st, ptrs, ev


def strawman_free(cfg: StrawmanConfig, st: StrawmanState, ptrs,
                  active=None):
    """Straw-man free round. Same misuse accounting as `pim_malloc.free`:
    NULL (-1) frees are benign no-ops (path -1); any other requested free
    that is out of range or untracked is dropped (path 2). Consumes `st`.
    Returns (state, FreeEvent)."""
    C, T = ptrs.shape
    dev = ptrs.device
    i32 = torch.int32
    if active is None:
        active = torch.ones((C, T), dtype=torch.bool, device=dev)
    requested = active & (ptrs != INVALID)
    active = requested & (ptrs >= 0) & (ptrs < cfg.heap_bytes)
    bcfg = cfg.buddy_cfg
    longest, leaf_log2 = st.buddy.longest, st.leaf_log2
    bpos = torch.full((C, T), INVALID, dtype=i32, device=dev)
    lv_up = torch.zeros((C, T), dtype=i32, device=dev)
    trace = torch.full((C, T, bcfg.trace_len), INVALID, dtype=i32,
                       device=dev)
    border = torch.zeros((C,), dtype=i32, device=dev)
    minus1 = torch.full((C,), -1, dtype=torch.int8, device=dev)
    for t, used in enumerate(active.any(0).tolist()):
        if not used:
            continue
        need, ptr = active[:, t], ptrs[:, t]
        leaf = torch.where(need, ptr // cfg.min_block, 0)
        lg = leaf_log2.gather(1, leaf.long()[:, None])[:, 0].to(i32)
        need = need & (lg >= 0)
        size = torch.ones_like(lg) << torch.clamp(lg, min=0)
        bev = buddy._free_(bcfg, longest, ptr, size, live=need)
        _put(leaf_log2, leaf, minus1, need)
        bpos[:, t] = torch.where(need, border, INVALID)
        border += need.to(i32)
        lv_up[:, t] = torch.where(need, bev.levels_up, 0)
        trace[:, t] = torch.where(need[:, None], bev.trace, INVALID)
    dropped = requested & (bpos < 0)
    path = torch.where(bpos >= 0, 1, torch.where(dropped, 2, INVALID))
    ev = pim_malloc.FreeEvent(path=path.to(i32), backend_pos=bpos,
                              levels_up=lv_up, trace=trace)
    return st, ev


# --------------------------------------------------------------------------
# Composite simulator
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SystemConfig:
    kind: str = "sw"
    heap_bytes: int = 32 * 1024 * 1024
    num_threads: int = 16
    pm: PimMallocConfig = None
    straw: StrawmanConfig = None
    sw_buf: SWBufferConfig = SWBufferConfig()
    bc: BuddyCacheConfig = BuddyCacheConfig()
    dpu: DPUCost = DPUCost()
    # the fused round's batched run-carve refill (kind ``fused``). None
    # defers to PIM_MALLOC_BATCH_REFILL (default on); False forces the
    # serial walk. Bitwise-identical either way: a speed knob, not a
    # semantic one.
    kernel_batch_refill: bool | None = None
    # kinds ``arena`` / ``tlregion`` only: the backend their spills go to,
    # ``hwsw`` (the scan-based rounds) or ``fused`` (the fused round: the
    # heap-step kernel on the card). Bitwise-identical either way.
    arena_inner: str = "hwsw"

    def __post_init__(self):
        heap._ensure_backends()
        if self.kind not in heap.REGISTRY:
            raise ValueError(f"unknown kind {self.kind!r} "
                             f"(registered: {tuple(heap.REGISTRY)})")
        if self.arena_inner not in ARENA_INNER:
            raise ValueError(f"unknown arena_inner {self.arena_inner!r} "
                             f"(one of {ARENA_INNER})")
        if self.pm is None:
            object.__setattr__(self, "pm", PimMallocConfig(
                heap_bytes=self.heap_bytes, num_threads=self.num_threads))
        if self.straw is None:
            object.__setattr__(self, "straw", StrawmanConfig(
                heap_bytes=self.heap_bytes, num_threads=self.num_threads))

    @property
    def trace_len(self) -> int:
        cfg = self.straw.buddy_cfg if self.kind == "strawman" else \
            self.pm.buddy_cfg
        return cfg.trace_len

    @property
    def access_fn(self):
        if self.kind in HW_CACHE_KINDS:
            return functools.partial(buddy_cache_access, self.bc)
        return functools.partial(sw_buffer_access, self.sw_buf)

    def cache_init(self, device="cuda"):
        """One core's empty metadata cache of this kind, on `device`."""
        if self.kind in HW_CACHE_KINDS:
            return buddy_cache_init(self.bc, device=device)
        return sw_buffer_init(self.sw_buf, device=device)

    @property
    def dma_bytes_per_miss(self) -> int:
        if self.kind in HW_CACHE_KINDS:
            return buddy_cache.WORD_BYTES
        return self.sw_buf.line_bytes


class HeapTelemetry(NamedTuple):
    """Per-core heap-health counters in rounded allocator bytes: live bytes
    and their high-water mark (int32[C]). For a well-formed stream

        live_bytes + buddy free bytes + cached thread-cache bytes
            == heap_bytes

    after every round (see `repro_torch.core.telemetry`)."""

    live_bytes: torch.Tensor
    hwm_bytes: torch.Tensor


def telemetry_init(device="cuda") -> HeapTelemetry:
    """One core's zeroed counters (int32 scalars) on `device` (the card
    unless the caller asks for the CPU)."""
    device = _device.resolve(device)
    return HeapTelemetry(
        live_bytes=torch.zeros((), dtype=torch.int32, device=device),
        hwm_bytes=torch.zeros((), dtype=torch.int32, device=device))


def _advance_telemetry(t: HeapTelemetry, alloc_bytes, freed_bytes):
    live = t.live_bytes + alloc_bytes - freed_bytes
    return HeapTelemetry(live_bytes=live,
                         hwm_bytes=torch.maximum(t.hwm_bytes, live))


class SystemState(NamedTuple):
    alloc: object            # PimMallocState | StrawmanState
    cache: object            # BuddyCacheState | SWBufferState
    telem: HeapTelemetry


class RoundInfo(NamedTuple):
    latency_cyc: torch.Tensor   # float32[C, T]
    path: torch.Tensor          # int32[C, T]
    meta_hits: torch.Tensor     # int32[C, T]
    meta_misses: torch.Tensor   # int32[C, T]
    dram_bytes: torch.Tensor    # int32[C, T]
    backend_cyc: torch.Tensor   # float32[C, T] service time excl. queuing


def system_init(cfg: SystemConfig, prepopulate: bool = True,
                num_cores: int = 1, device="cuda") -> SystemState:
    """One core's initial state of `cfg.kind`, stacked to ``[num_cores,
    ...]`` leaves, on `device` (the card unless the caller asks for the
    CPU; raises without a GPU)."""
    device = _device.resolve(device)
    if cfg.kind in ("arena", "tlregion"):
        # the layered frontend owns its region carve: the freelists start
        # empty and refill from spills on demand
        from . import arena
        return _stack(arena.init_state(cfg, device=device), num_cores)
    if cfg.kind == "strawman":
        alloc = strawman_init(cfg.straw, device=device)
    else:
        alloc = pim_malloc.init(cfg.pm, prepopulate=prepopulate,
                                device=device)
    one = SystemState(alloc=alloc, cache=cfg.cache_init(device),
                      telem=telemetry_init(device))
    if cfg.kind == "sanitizer":
        from . import sanitizer
        one = sanitizer.init_state(cfg, one)
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


def _cache_pass(cfg: SystemConfig, cache_st, backend_pos, traces):
    """Run the metadata cache over this round's backend ops in mutex
    order: ``backend_pos [C, B]``, ``traces [C, B, L]``. Returns (state,
    TraceStats with [C, B] fields in the ops' own order)."""
    key = torch.where(backend_pos >= 0, backend_pos, 1 << 30)
    order = torch.argsort(key, dim=1, stable=True)
    traces_sorted = traces.gather(
        1, order[..., None].expand(-1, -1, traces.shape[-1]))
    cache_st, stats = buddy_cache.simulate_traces(cfg.access_fn, cache_st,
                                                  traces_sorted)

    def unsort(x):  # position order[c, i] takes sorted entry i
        return torch.zeros_like(x).scatter_(1, order, x)

    return cache_st, buddy_cache.TraceStats(*(unsort(x) for x in stats))


def _strawman_realloc_meta(cfg: StrawmanConfig, st: StrawmanState, ptrs,
                           sizes):
    """Straw-man counterpart of `pim_malloc.realloc_meta` over leaf_log2."""
    valid = (ptrs >= 0) & (ptrs < cfg.heap_bytes)
    leaf = torch.where(valid, ptrs // cfg.min_block, 0)
    lg = st.leaf_log2.gather(1, leaf.long()).to(torch.int32)
    valid_old = valid & (lg >= 0)
    old_bytes = torch.where(valid_old,
                            torch.ones_like(lg) << torch.clamp(lg, min=0), 0)
    new_bytes = next_pow2(torch.clamp(sizes, min=cfg.min_block))
    return pim_malloc.ReallocMeta(
        valid_old=valid_old, in_place=valid_old & (new_bytes == old_bytes),
        old_bytes=old_bytes, new_bytes=new_bytes)


def _protocol_round(cfg: SystemConfig, st: SystemState, req: AllocRequest,
                    malloc_fn, free_fn, meta_fn, free_path_fn):
    """One mixed-op ``[C, T]`` round over kind-specific allocator
    primitives.

    Phases: (1) realloc size-class analysis on the pre-round metadata,
    (2) one batched malloc round (MALLOC/CALLOC + relocating REALLOCs),
    (3) one batched free round (FREE + released old realloc blocks), then
    a single metadata-cache pass + mutex queue over both phases' backend
    ops in serialization order (the malloc phase drains first: mutex
    FIFO)."""
    op, size, ptr = req.op, req.size, req.ptr
    is_alloc = (op == OP_MALLOC) | (op == OP_CALLOC)
    is_re = op == OP_REALLOC
    is_free = op == OP_FREE
    T = op.shape[-1]

    meta = meta_fn(st.alloc, ptr, size)
    re_live = is_re & (size > 0)
    in_place = re_live & meta.in_place
    moved = re_live & ~meta.in_place
    re_free0 = is_re & (size <= 0) & (ptr >= 0)

    # ---- phase 1: batched malloc (new blocks) ----------------------------
    m_active = (is_alloc & (size > 0)) | moved
    alloc_st, mptrs, mev = malloc_fn(st.alloc, torch.where(m_active, size, 0),
                                     m_active)
    mok = m_active & (mptrs >= 0)

    # ---- phase 2: batched free (explicit frees + vacated realloc blocks) -
    f_active = is_free | (moved & meta.valid_old & mok) | re_free0
    alloc_st, fev = free_fn(alloc_st, torch.where(f_active, ptr, INVALID),
                            f_active)
    fpath = free_path_fn(fev)

    # ---- one cache pass + shared pricing over both phases ----------------
    n_back_m = (mev.backend_pos >= 0).sum(-1, keepdim=True, dtype=torch.int32)
    bpos = torch.cat([mev.backend_pos,
                      torch.where(fev.backend_pos >= 0,
                                  fev.backend_pos + n_back_m, INVALID)], -1)
    traces = torch.cat([mev.trace, fev.trace], 1)
    cache_st, ts = _cache_pass(cfg, st.cache, bpos, traces)
    resp, alloc_bytes, freed_bytes = _price_round(
        cfg, req, mptrs=mptrs, m_path=mev.path, m_bpos=mev.backend_pos,
        m_lvdown=mev.levels_down, m_lvup=mev.levels_up, fpath=fpath,
        f_bpos=fev.backend_pos, f_lvup=fev.levels_up,
        hits_m=ts.hits[:, :T], miss_m=ts.misses[:, :T],
        dram_m=ts.dram_bytes[:, :T], hits_f=ts.hits[:, T:],
        miss_f=ts.misses[:, T:], dram_f=ts.dram_bytes[:, T:],
        in_place=in_place, moved=moved, mok=mok, valid_old=meta.valid_old,
        old_bytes=meta.old_bytes, new_bytes=meta.new_bytes,
        re_free0=re_free0)
    telem = _advance_telemetry(st.telem, alloc_bytes, freed_bytes)
    return SystemState(alloc=alloc_st, cache=cache_st, telem=telem), resp


@heap.register("strawman")
def _step_strawman(cfg: SystemConfig, st: SystemState, req: AllocRequest):
    return _protocol_round(
        cfg, st, req,
        malloc_fn=lambda s, z, a: strawman_malloc(cfg.straw, s, z, a),
        free_fn=lambda s, p, a: strawman_free(cfg.straw, s, p, a),
        meta_fn=lambda s, p, z: _strawman_realloc_meta(cfg.straw, s, p, z),
        free_path_fn=lambda ev: ev.path)


@heap.register("hwsw")
@heap.register("sw")
def _step_pim(cfg: SystemConfig, st: SystemState, req: AllocRequest):
    """``sw`` and ``hwsw``: one round over `pim_malloc`; the kinds differ
    only in the metadata cache (`SystemConfig.access_fn`)."""
    return _protocol_round(
        cfg, st, req,
        malloc_fn=lambda s, z, a: pim_malloc.malloc(cfg.pm, s, z, a),
        free_fn=lambda s, p, a: pim_malloc.free(cfg.pm, s, p, a),
        meta_fn=lambda s, p, z: pim_malloc.realloc_meta(cfg.pm, s, p, z),
        free_path_fn=lambda ev: ev.path)


@heap.register("sanitizer")
def _step_sanitizer(cfg: SystemConfig, st, req: AllocRequest):
    """The shadow-heap wrapper over the hwsw design point: every
    FREE/REALLOC operand is classified against a 16 B-granule shadow map,
    legitimate frees wait in a FIFO quarantine, only clean work reaches
    `_step_pim`, and poisoned operands get deterministic tagged reports
    (`repro_torch.core.sanitizer`)."""
    from . import sanitizer
    return sanitizer.step(cfg, st, req, _step_pim)


@heap.register("tlregion")
@heap.register("arena")
def _step_arena(cfg: SystemConfig, st, req: AllocRequest):
    """The layered design points: a bump-pointer frontend over the pim
    stack (`repro_torch.core.arena`). Small allocs bump into a region
    carved out of the heap at init, OP_EPOCH_RESET retires whole epochs,
    and everything else (big allocs, non-arena pointers, spills when the
    region is full) goes to `_step_pim`, or to `_step_fused` (the
    heap-step kernel on the card) when ``cfg.arena_inner == "fused"``.
    ``arena`` shares one region; ``tlregion`` gives each thread its
    own."""
    from . import arena
    inner = _step_fused if cfg.arena_inner == "fused" else _step_pim
    return arena.step(cfg, st, req, inner)


@heap.register("fused")
def _step_fused(cfg: SystemConfig, st: SystemState, req: AllocRequest):
    """The fused-kernel design point: hwsw semantics, one kernel launch.

    The whole round runs in `fused_heap_step`; this wrapper rebuilds the
    state tree from its outputs, folds its per-thread records into the
    allocator stats, and prices the round. The nine allocator and cache
    tensors of `st` are updated in place, on either device. Nothing here
    reads ``cfg.kind``: the arena kinds spill through it too."""
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
    """Cost-model accounting of one batched round (any leading shape;
    tensors on any device, or host arrays). With ``[R, C, T]`` leaves (a
    `ShardedHeap` round) ``per_rank`` breaks the totals down by rank."""
    def np_(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else \
            np.asarray(x)

    op = np_(req.op)
    active = op != OP_NOOP
    lat = np_(resp.latency_cyc)
    dram = np.asarray(np_(resp.dram_bytes), np.int64)
    out = {
        "ops": int(active.sum()),
        "ok": int(np_(resp.ok).sum()),
        "latency_cyc": float(lat.sum()),
        "max_latency_cyc": float(lat.max()) if lat.size else 0.0,
        "backend_cyc": float(np_(resp.backend_cyc).sum()),
        "meta_hits": int(np_(resp.meta_hits).sum()),
        "meta_misses": int(np_(resp.meta_misses).sum()),
        "dram_bytes": int(dram.sum()),
    }
    if op.ndim >= 3:  # [R, ...]: per-rank breakdown over the leading axis
        rest = tuple(range(1, op.ndim))
        out["per_rank"] = {
            "ops": active.sum(axis=rest).tolist(),
            "latency_cyc": lat.sum(axis=rest).tolist(),
            "dram_bytes": dram.sum(axis=rest).tolist(),
        }
    return out


def _round_info(resp: AllocResponse) -> RoundInfo:
    return RoundInfo(latency_cyc=resp.latency_cyc, path=resp.path,
                     meta_hits=resp.meta_hits, meta_misses=resp.meta_misses,
                     dram_bytes=resp.dram_bytes, backend_cyc=resp.backend_cyc)


def malloc_round(cfg: SystemConfig, st: SystemState, sizes, active=None):
    """One all-MALLOC round: sizes int32[C, T]. Returns (state, ptrs,
    RoundInfo)."""
    st, resp = heap.step(cfg, st, heap.malloc_request(sizes, active))
    return st, resp.ptr, _round_info(resp)


def free_round(cfg: SystemConfig, st: SystemState, ptrs, active=None):
    """One all-FREE round: ptrs int32[C, T]. Returns (state, RoundInfo)."""
    st, resp = heap.step(cfg, st, heap.free_request(ptrs, active))
    return st, _round_info(resp)


def _stack_rounds(xs):
    return type(xs[0])(*(torch.stack(f) for f in zip(*xs)))


def run_alloc_rounds(cfg: SystemConfig, st: SystemState, sizes_rounds):
    """Malloc rounds over ``[R, C, T]`` sizes; returns (state, ptrs [R, C,
    T], RoundInfo with [R, C, T] leaves)."""
    ptrs, infos = [], []
    for sizes in sizes_rounds:
        st, p, info = malloc_round(cfg, st, sizes)
        ptrs.append(p)
        infos.append(info)
    return st, torch.stack(ptrs), _stack_rounds(infos)


def run_alloc_free_rounds(cfg: SystemConfig, st: SystemState, sizes_rounds):
    """Each round: alloc, then free what it got at once (Fig 6's
    (de)allocation loop). Returns (state, alloc infos, free infos)."""
    infos_a, infos_f = [], []
    for sizes in sizes_rounds:
        st, p, info_a = malloc_round(cfg, st, sizes)
        st, info_f = free_round(cfg, st, p)
        infos_a.append(info_a)
        infos_f.append(info_f)
    return st, _stack_rounds(infos_a), _stack_rounds(infos_f)
