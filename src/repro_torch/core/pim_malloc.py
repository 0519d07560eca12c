"""PIM-malloc-SW: the paper's hierarchical per-core allocator (Section 4.1).

The port of `repro.core.pim_malloc`. Two levels, as in Fig 8:

  frontend  per-thread LIFO freelists of sub-blocks carved from
            `block_bytes` blocks, one per size class (16 B ... 2 KiB); pops
            and pushes are vectorized over threads;
  backend   a shared buddy allocator with minimum grain `block_bytes`,
            behind a mutex: its users are served one thread at a time, in
            thread order.

Workflow cases of Fig 9 (`MallocEvent.path`): 0 thread-cache hit, 1 miss
and refill, 2 bypass (> the largest class), 3 fail, -1 idle.

`malloc` / `free` / `realloc` / `calloc` / `gc` take states with an
explicit leading core axis (``counts [C, T, NC]``, ``stacks [C, T, NC,
CAP]``, block tables and trees ``[C, ...]``) and requests ``[C, T]``; core
i's requests never touch core j's state. They consume the state: its
tensors are updated in place and returned in the new state (the stats are
new tensors). Each backend user updates the core's one tree in place
through `buddy._alloc_` / `buddy._free_`. Where the reference scatter-adds
with duplicate indices (two threads popping from, or pushing into, one
block in a round), the port adds with `scatter_add_`, which keeps every
duplicate. `init` carves the prepopulated blocks on the host, for one
core.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import device as _device
from . import buddy
from .buddy import BuddyConfig, BuddyState, _put, ilog2, next_pow2

INVALID = -1
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class PimMallocConfig:
    heap_bytes: int = 32 * 1024 * 1024
    num_threads: int = 16          # paper: up to 24 tasklets per DPU
    size_classes: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048)
    block_bytes: int = 4096        # thread-cache refill unit == buddy grain
    cap: int = 1024                # freelist capacity per (thread, class)
    max_gc: int = 8                # full blocks merged back per gc() pass

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

    @property
    def log2_min_class(self) -> int:
        return min(self.size_classes).bit_length() - 1

    @property
    def max_class(self) -> int:
        return max(self.size_classes)


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


class MallocEvent(NamedTuple):
    """Per-thread record for the cost model and cache sims (all [C, T])."""

    path: torch.Tensor         # 0 hit / 1 refill / 2 bypass / 3 fail / -1
    backend_pos: torch.Tensor  # serialization order at the backend, -1
    levels_down: torch.Tensor
    levels_up: torch.Tensor
    trace: torch.Tensor        # int32[C, T, trace_len] nodes touched


class FreeEvent(NamedTuple):
    path: torch.Tensor         # 0 small / 1 big / 2 dropped / -1 idle
    backend_pos: torch.Tensor
    levels_up: torch.Tensor
    trace: torch.Tensor


class ReallocMeta(NamedTuple):
    """Size-class analysis of live pointers for realloc (all [C, T])."""

    valid_old: torch.Tensor  # bool: ptr maps to tracked metadata
    in_place: torch.Tensor   # bool: rounded size class unchanged
    old_bytes: torch.Tensor  # int32 rounded bytes of the live block (0)
    new_bytes: torch.Tensor  # int32 rounded bytes of the requested size


class ReallocEvent(NamedTuple):
    malloc: MallocEvent       # alloc phase of moved reallocs
    free: FreeEvent           # release phase of moved reallocs
    in_place: torch.Tensor    # bool: served without touching the heap
    moved: torch.Tensor       # bool: relocated (new ptr, old freed)
    copy_bytes: torch.Tensor  # int32 payload DMA'd old -> new block


def _class_of(cfg: PimMallocConfig, sizes: torch.Tensor) -> torch.Tensor:
    rounded = next_pow2(torch.clamp(sizes, min=min(cfg.size_classes)))
    return torch.clamp(ilog2(rounded) - cfg.log2_min_class, 0, cfg.nc - 1)


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


# ---------------------------------------------------------------------------
# the batched operations, over an explicit core axis
# ---------------------------------------------------------------------------
def _classes(cfg: PimMallocConfig, device) -> torch.Tensor:
    return torch.tensor(cfg.size_classes, dtype=torch.int32, device=device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1, dtype=torch.int32)


def malloc(cfg: PimMallocConfig, st: PimMallocState, sizes, active=None):
    """Serve one batched request round: ``sizes int32[C, T]``.

    Returns (state, ptrs int32[C, T], MallocEvent); ptr = -1 for failed or
    idle threads. Phase A pops the thread caches (vectorized); phase B
    serves refills and bypasses on the backend, one thread at a time in
    thread (mutex) order. A thread that no core sends to the backend is a
    no-op there and is skipped."""
    C, T = sizes.shape
    if T != cfg.num_threads:
        raise ValueError(f"sizes {tuple(sizes.shape)}: {cfg.num_threads} "
                         "threads per core")
    dev = sizes.device
    i32 = torch.int32
    if active is None:
        active = torch.ones((C, T), dtype=torch.bool, device=dev)
    classes = _classes(cfg, dev)
    bcfg = cfg.buddy_cfg
    cs = torch.arange(C, device=dev)
    cc, tt = cs[:, None], torch.arange(T, device=dev)[None, :]
    counts, stacks = st.counts, st.stacks
    block_cls, block_free, big_log2 = st.block_cls, st.block_free, \
        st.big_log2
    longest = st.buddy.longest

    # ---- phase A: vectorized thread-cache pops (case 1) -------------------
    # sizes beyond the heap fail outright (next_pow2 wraps above 2^30)
    too_big = active & (sizes > cfg.heap_bytes)
    small = active & (sizes <= cfg.max_class) & (sizes > 0)
    c = _class_of(cfg, sizes)
    cl = c.long()
    cnt = counts[cc, tt, cl]
    hit = small & (cnt > 0)
    ptr_a = stacks[cc, tt, cl, torch.clamp(cnt - 1, min=0).long()]
    counts[cc, tt, cl] = cnt - hit.to(i32)
    # two threads may pop from one block: scatter_add_ keeps both
    block_free.scatter_add_(
        1, torch.where(hit, ptr_a // cfg.block_bytes, 0).long(),
        -hit.to(i32))

    # ---- phase B: the serialized backend (cases 2 and 3, mutex) -----------
    refill = small & ~hit
    bypass = active & (sizes > cfg.max_class) & ~too_big
    need = refill | bypass
    tlen = bcfg.trace_len
    ptr_b = torch.full((C, T), INVALID, dtype=i32, device=dev)
    bpos = ptr_b.clone()
    lv_down = torch.zeros((C, T), dtype=i32, device=dev)
    lv_up = lv_down.clone()
    trace = torch.full((C, T, tlen), INVALID, dtype=i32, device=dev)
    ok_b = torch.zeros((C, T), dtype=torch.bool, device=dev)
    border = torch.zeros((C,), dtype=i32, device=dev)
    sub_idx = torch.arange(cfg.max_sub, dtype=i32, device=dev)
    for t, used in enumerate(need.any(0).tolist()):
        if not used:
            continue
        need_t, refill_t, bypass_t = need[:, t], refill[:, t], bypass[:, t]
        c_t = c[:, t]
        alloc_size = torch.where(
            bypass_t, next_pow2(torch.clamp(sizes[:, t], min=cfg.block_bytes)),
            cfg.block_bytes)
        off, bev = buddy._alloc_(bcfg, longest, alloc_size, live=need_t)
        ok = need_t & (off >= 0)
        b = torch.where(off >= 0, off // cfg.block_bytes, 0)

        # refill: carve the block into sub-blocks, push all, pop the top
        csize = classes[c_t.long()]
        sub = cfg.block_bytes // csize
        row = torch.where(sub_idx < sub[:, None],
                          off[:, None] + sub_idx * csize[:, None], INVALID)
        do_refill = refill_t & ok
        ctl = c_t.long()
        stacks[cs, t, ctl, :cfg.max_sub] = torch.where(
            do_refill[:, None], row, stacks[cs, t, ctl, :cfg.max_sub])
        counts[cs, t, ctl] = torch.where(do_refill, sub - 1,
                                         counts[cs, t, ctl])
        _put(block_cls, b, c_t, do_refill)
        _put(block_free, b, sub - 1, do_refill)

        # bypass: record the size so a ptr-only free can recover it
        do_bypass = bypass_t & ok
        _put(big_log2, b, ilog2(alloc_size), do_bypass)

        ptr_b[:, t] = torch.where(
            do_refill, off + (sub - 1) * csize,
            torch.where(do_bypass, off, INVALID))
        bpos[:, t] = torch.where(need_t, border, INVALID)
        border += need_t.to(i32)
        lv_down[:, t] = torch.where(need_t, bev.levels_down, 0)
        lv_up[:, t] = torch.where(need_t, bev.levels_up, 0)
        trace[:, t] = torch.where(need_t[:, None], bev.trace, INVALID)
        ok_b[:, t] = ok

    ptrs = torch.where(hit, ptr_a, ptr_b)
    path = torch.where(
        hit, 0, torch.where(refill & ok_b, 1, torch.where(
            bypass & ok_b, 2, torch.where(need | too_big, 3, INVALID))))
    s = st.stats
    stats = s._replace(
        front_hits=s.front_hits + _count(hit),
        front_misses=s.front_misses + _count(refill),
        bypass=s.bypass + _count(bypass),
        fails=s.fails + _count((need & ~ok_b) | too_big))
    new_st = st._replace(stats=stats)
    ev = MallocEvent(path=path.to(i32), backend_pos=bpos,
                     levels_down=lv_down, levels_up=lv_up, trace=trace)
    return new_st, ptrs, ev


def free(cfg: PimMallocConfig, st: PimMallocState, ptrs, active=None):
    """pimFree(ptr) batched over ``[C, T]`` threads: the size is recovered
    from the block metadata.

    C-like misuse accounting: a NULL free (ptr == -1) is a benign no-op
    (path -1); any other requested free that cannot be served (negative
    garbage, out-of-heap offsets, pointers in untracked blocks, double
    frees of bypass blocks, a freelist at capacity) is dropped (path 2)
    and counted in `Stats.dropped_frees`. Big frees reach the buddy one
    thread at a time, in thread order. Returns (state, FreeEvent)."""
    C, T = ptrs.shape
    if T != cfg.num_threads:
        raise ValueError(f"ptrs {tuple(ptrs.shape)}: {cfg.num_threads} "
                         "threads per core")
    dev = ptrs.device
    i32 = torch.int32
    if active is None:
        active = torch.ones((C, T), dtype=torch.bool, device=dev)
    bcfg = cfg.buddy_cfg
    cc, tt = (torch.arange(C, device=dev)[:, None],
              torch.arange(T, device=dev)[None, :])
    counts, stacks = st.counts, st.stacks
    block_free, big_log2 = st.block_free, st.big_log2
    requested = active & (ptrs != INVALID)
    active = requested & (ptrs >= 0) & (ptrs < cfg.heap_bytes)

    b = torch.where(active, ptrs // cfg.block_bytes, 0)
    cls = st.block_cls.gather(1, b.long())
    small = active & (cls >= 0)
    big = (active & (cls < 0) & (big_log2.gather(1, b.long()) >= 0)
           & (ptrs % cfg.block_bytes == 0))

    # ---- small frees: vectorized push to the calling thread's list -------
    csel = torch.clamp(cls, min=0).long()
    pos = counts[cc, tt, csel]
    push = small & ~(pos >= cfg.cap)
    possafe = torch.clamp(pos, max=cfg.cap - 1).long()
    stacks[cc, tt, csel, possafe] = torch.where(
        push, ptrs, stacks[cc, tt, csel, possafe])
    counts[cc, tt, csel] = pos + push.to(i32)
    # two threads may push into one block: scatter_add_ keeps both
    block_free.scatter_add_(1, torch.where(push, b, 0).long(),
                            push.to(i32))

    # ---- big frees: serialized buddy frees (mutex) ------------------------
    tlen = bcfg.trace_len
    bpos = torch.full((C, T), INVALID, dtype=i32, device=dev)
    lv_up = torch.zeros((C, T), dtype=i32, device=dev)
    trace = torch.full((C, T, tlen), INVALID, dtype=i32, device=dev)
    border = torch.zeros((C,), dtype=i32, device=dev)
    for t, used in enumerate(big.any(0).tolist()):
        if not used:
            continue
        big_t, b_t = big[:, t], b[:, t]
        lg = big_log2.gather(1, b_t.long()[:, None])[:, 0]
        size = torch.ones_like(lg) << torch.clamp(lg, min=0)
        bev = buddy._free_(bcfg, st.buddy.longest, ptrs[:, t], size,
                           live=big_t)
        _put(big_log2, b_t, torch.full_like(b_t, INVALID), big_t)
        bpos[:, t] = torch.where(big_t, border, INVALID)
        border += big_t.to(i32)
        lv_up[:, t] = torch.where(big_t, bev.levels_up, 0)
        trace[:, t] = torch.where(big_t[:, None], bev.trace, INVALID)

    dropped = requested & ~push & ~big
    path = torch.where(push, 0, torch.where(
        big, 1, torch.where(dropped, 2, INVALID)))
    s = st.stats
    stats = s._replace(
        frees_small=s.frees_small + _count(push),
        frees_big=s.frees_big + _count(big),
        dropped_frees=s.dropped_frees + _count(dropped))
    ev = FreeEvent(path=path.to(i32), backend_pos=bpos, levels_up=lv_up,
                   trace=trace)
    return st._replace(stats=stats), ev


def realloc_meta(cfg: PimMallocConfig, st: PimMallocState, ptrs,
                 sizes) -> ReallocMeta:
    """Classify live pointers against requested sizes (no state change).

    A pointer is small iff its block is thread-cache-owned (block_cls >=
    0), big iff it is the base of a recorded bypass allocation. Grow or
    shrink stays in place iff the rounded size class (small) or rounded
    pow2 (big) is unchanged."""
    classes = _classes(cfg, ptrs.device)
    valid = (ptrs >= 0) & (ptrs < cfg.heap_bytes)
    b = torch.where(valid, ptrs // cfg.block_bytes, 0).long()
    cls = st.block_cls.gather(1, b)
    lg = st.big_log2.gather(1, b)
    small_old = valid & (cls >= 0)
    big_old = (valid & (cls < 0) & (lg >= 0)
               & (ptrs % cfg.block_bytes == 0))
    old_bytes = torch.where(
        small_old, classes[torch.clamp(cls, min=0).long()],
        torch.where(big_old, torch.ones_like(lg) << torch.clamp(lg, min=0),
                    0))
    new_small = sizes <= cfg.max_class
    new_bytes = torch.where(
        new_small, classes[_class_of(cfg, sizes).long()],
        next_pow2(torch.clamp(sizes, min=cfg.block_bytes)))
    in_place = ((small_old & new_small) | (big_old & ~new_small)) & (
        new_bytes == old_bytes)
    return ReallocMeta(valid_old=small_old | big_old, in_place=in_place,
                       old_bytes=old_bytes.to(torch.int32),
                       new_bytes=new_bytes.to(torch.int32))


def realloc(cfg: PimMallocConfig, st: PimMallocState, ptrs, sizes,
            active=None):
    """pimRealloc(ptr, size) batched over ``[C, T]`` threads, with C
    realloc's semantics: same rounded class -> in place; class changed ->
    malloc new + copy + free old; invalid ptr -> plain malloc; size <= 0
    with a live ptr -> free, returns -1; failed relocation -> -1, the old
    block intact. Returns (state, new_ptrs, ReallocEvent)."""
    C, T = ptrs.shape
    if active is None:
        active = torch.ones((C, T), dtype=torch.bool, device=ptrs.device)
    sizes = sizes.to(torch.int32)
    meta = realloc_meta(cfg, st, ptrs, sizes)
    live = active & (sizes > 0)
    in_place = live & meta.in_place
    moved = live & ~meta.in_place
    free_as_zero = active & (sizes <= 0) & (ptrs >= 0)

    st, mptrs, mev = malloc(cfg, st, torch.where(moved, sizes, 0), moved)
    ok_new = mptrs >= 0
    f_active = (moved & meta.valid_old & ok_new) | free_as_zero
    st, fev = free(cfg, st, torch.where(f_active, ptrs, INVALID), f_active)

    new_ptrs = torch.where(in_place, ptrs,
                           torch.where(moved & ok_new, mptrs, INVALID))
    copy_bytes = torch.where(moved & ok_new & meta.valid_old,
                             torch.minimum(meta.old_bytes, meta.new_bytes), 0)
    ev = ReallocEvent(malloc=mev, free=fev, in_place=in_place,
                      moved=moved & ok_new, copy_bytes=copy_bytes)
    return st, new_ptrs, ev


def calloc(cfg: PimMallocConfig, st: PimMallocState, nmemb, elem_sizes,
           active=None):
    """pimCalloc(nmemb, size): malloc(nmemb * size), with the overflow
    guard of `total_calloc_bytes` (an overflowing product fails)."""
    total = total_calloc_bytes(nmemb, elem_sizes)
    if active is None:
        active = torch.ones(total.shape, dtype=torch.bool,
                            device=total.device)
    return malloc(cfg, st, total, active & (total > 0))


def gc(cfg: PimMallocConfig, st: PimMallocState) -> PimMallocState:
    """Merge fully-free blocks back into the buddy (paper Fig 8(b)).

    Each core takes up to ``cfg.max_gc`` full blocks per call, lowest
    block first (the reference's ``top_k`` over all-tied scores: a stable
    descending sort); leftovers wait for later calls. Each taken block's
    sub-blocks leave every thread's freelist of its class, the kept
    entries compacted to the front in order (a stable sort)."""
    dev = st.counts.device
    classes = _classes(cfg, dev)
    longest, counts, stacks = st.buddy.longest, st.counts, st.stacks
    block_cls, block_free = st.block_cls, st.block_free
    C, T, NC, CAP = stacks.shape
    cs = torch.arange(C, device=dev)
    sub_of = cfg.block_bytes // torch.clamp(
        classes[torch.clamp(block_cls, min=0).long()], min=1)
    full = (block_cls >= 0) & (block_free == sub_of)
    order = torch.sort(full.to(torch.int32), dim=1, descending=True,
                       stable=True).indices
    cand = order[:, :cfg.max_gc]
    cand_ok = full.gather(1, cand)
    pos = torch.arange(CAP, device=dev)
    applied = torch.zeros((C,), dtype=torch.int32, device=dev)
    for k in range(cand.shape[1]):
        b, ok = cand[:, k], cand_ok[:, k]
        c = torch.clamp(block_cls.gather(1, b[:, None])[:, 0], min=0).long()
        rows = stacks[cs, :, c]                          # [C, T, CAP]
        n = counts[cs, :, c]                             # [C, T]
        valid = pos < n[..., None]
        is_b = valid & (rows // cfg.block_bytes == b[:, None, None]) & \
            ok[:, None, None]
        kept = ~is_b & valid
        perm = torch.argsort((~kept).to(torch.int8), dim=2, stable=True)
        compacted = rows.gather(2, perm)
        newcnt = kept.sum(2, dtype=torch.int32)
        compacted = torch.where(pos < newcnt[..., None], compacted, INVALID)
        stacks[cs, :, c] = torch.where(ok[:, None, None], compacted, rows)
        counts[cs, :, c] = torch.where(ok[:, None], newcnt, n)
        buddy._free_(cfg.buddy_cfg, longest, b.to(torch.int32) *
                     cfg.block_bytes,
                     torch.full_like(b, cfg.block_bytes, dtype=torch.int32),
                     live=ok)
        _put(block_cls, b, torch.full_like(b, INVALID, dtype=torch.int32), ok)
        _put(block_free, b, torch.zeros_like(b, dtype=torch.int32), ok)
        applied += ok.to(torch.int32)
    s = st.stats
    return st._replace(stats=s._replace(gc_blocks=s.gc_blocks + applied))
