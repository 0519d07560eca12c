"""ASan-style shadow-heap sanitizer: a wrapper design point over hwsw.

The port of `repro.core.sanitizer`. The ``sanitizer`` kind turns heap
misuse into deterministic tagged reports while serving the full
`repro_torch.core.heap` protocol:

  shadow map   one int8 cell per 16 B heap granule at allocation *start
               granules*: LIVE after a successful malloc / calloc /
               realloc, QUARANTINED after an explicit free, MOVED after a
               relocating realloc retires the old pointer, STALE after an
               EPOCH_RESET round retires every live start.
  poisoning    an op through a non-LIVE start granule never reaches the
               wrapped allocator; it is tagged (double_free /
               use_after_free / realloc_after_free / wild / epoch_stale)
               and answered with a deterministic failing response.
  quarantine   legitimately freed blocks wait in a FIFO ring; the oldest
               entry goes to the wrapped allocator's free path only when
               the ring overflows.

The wrapped allocator is the hwsw design point (`system._step_pim`), so
quarantined bytes stay live in the telemetry and the conservation law
holds after every round. Every tensor carries a leading core axis:
``shadow int8 [C, heap_bytes // 16]``, ``q_ptr [C, Q]``, ``q_head`` /
``q_len [C]``, ``tags [C, T]``, each report counter ``[C]``. `step`
consumes its state (the shadow map is updated in place). The STALE pass
over the map runs only in rounds where some thread of some core resets;
otherwise it would change nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.freelist import RESET_CHUNK, drop_set_
from .heap import (OP_CALLOC, OP_EPOCH_RESET, OP_FREE, OP_MALLOC,
                   OP_REALLOC, AllocRequest, AllocResponse)
from .pim_malloc import INVALID

# every pointer the allocator hands out is GRANULE-aligned (the smallest
# size class is 16 B), so one int8 per granule tells live starts apart
GRANULE = 16

# shadow cell states
SHADOW_FREE = 0    # no allocation starts here
SHADOW_LIVE = 1    # start of a live allocation
SHADOW_QUAR = 2    # start of an explicitly freed block, parked in quarantine
SHADOW_MOVED = 3   # start retired by a relocating realloc
SHADOW_STALE = 4   # start invalidated wholesale by an EPOCH_RESET round

# per-op misuse tags (state.tags / report schema)
TAG_NONE = 0
TAG_DOUBLE_FREE = 1         # free-class op on a QUARANTINED start
TAG_USE_AFTER_FREE = 2      # free-class op on a MOVED start
TAG_REALLOC_AFTER_FREE = 3  # realloc(size>0) on a QUARANTINED/MOVED start
TAG_WILD = 4                # op on an unmapped / misaligned / outside ptr
TAG_EPOCH_STALE = 5         # op on a start retired by an epoch reset

TAG_NAMES = {TAG_NONE: "none", TAG_DOUBLE_FREE: "double_free",
             TAG_USE_AFTER_FREE: "use_after_free",
             TAG_REALLOC_AFTER_FREE: "realloc_after_free", TAG_WILD: "wild",
             TAG_EPOCH_STALE: "epoch_stale"}

# quarantine capacity: every thread can retire several blocks before the
# oldest one is released to the wrapped allocator
QUARANTINE_FACTOR = 4


def quarantine_slots(num_threads: int) -> int:
    return max(8, QUARANTINE_FACTOR * num_threads)


class SanReports(NamedTuple):
    """Cumulative misuse counters (int32, one per core)."""

    double_free: torch.Tensor
    use_after_free: torch.Tensor
    realloc_after_free: torch.Tensor
    wild_ops: torch.Tensor
    quarantined: torch.Tensor   # legit frees parked in the ring
    evicted: torch.Tensor       # ring evictions released to the free path
    epoch_resets: torch.Tensor  # EPOCH_RESET rounds observed
    epoch_stale: torch.Tensor   # ops tagged for touching a reset start


class SanitizerState(NamedTuple):
    """hwsw state + shadow map + quarantine ring + misuse reports. The
    leading (alloc, cache, telem) triple mirrors `system.SystemState`."""

    alloc: object            # PimMallocState (the wrapped allocator)
    cache: object            # BuddyCacheState (the hwsw metadata path)
    telem: object            # system.HeapTelemetry
    shadow: torch.Tensor     # int8[C, heap_bytes // GRANULE]
    q_ptr: torch.Tensor      # int32[C, Q] quarantined pointers (-1 empty)
    q_head: torch.Tensor     # int32[C] index of the oldest entry
    q_len: torch.Tensor      # int32[C] occupancy
    tags: torch.Tensor       # int32[C, T] per-thread tag of the last round
    reports: SanReports


def init_state(cfg, inner_state) -> SanitizerState:
    """Wrap one core's fresh hwsw-layout `SystemState` (unstacked leaves,
    on the device they live on)."""
    dev = inner_state.telem.live_bytes.device
    q = quarantine_slots(cfg.num_threads)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return SanitizerState(
        alloc=inner_state.alloc, cache=inner_state.cache,
        telem=inner_state.telem,
        shadow=torch.zeros((cfg.heap_bytes // GRANULE,), dtype=torch.int8,
                           device=dev),
        q_ptr=torch.full((q,), -1, dtype=torch.int32, device=dev),
        q_head=z, q_len=z.clone(),
        tags=torch.zeros((cfg.num_threads,), dtype=torch.int32, device=dev),
        reports=SanReports(*(z.clone() for _ in SanReports._fields)))


def _quarantine_pass(q_ptr, q_head, q_len, enq, ptrs):
    """FIFO ring update for one round: a loop over the T threads in mutex
    order on ``[C]`` tensors. Each enqueueing thread parks its pointer;
    when the ring is full the oldest entry is evicted into that thread's
    slot of the wrapped request. Updates `q_ptr` in place; returns
    (q_ptr, q_head, q_len, evicted [C, T], -1 where nothing was
    evicted)."""
    Q = q_ptr.shape[-1]
    evicted = []
    for t in range(enq.shape[-1]):
        enq_t, ptr_t = enq[:, t], ptrs[:, t]
        # evict BEFORE enqueueing: at capacity the write position wraps
        # onto q_head, so enqueue-first would overwrite the oldest entry
        evict = enq_t & (q_len >= Q)
        ev_ptr = q_ptr.gather(1, q_head.clamp(0, Q - 1).long()[:, None])[:, 0]
        q_head = torch.where(evict, (q_head + 1) % Q, q_head)
        q_len = q_len - evict.to(torch.int32)
        wpos = ((q_head + q_len) % Q).long()[:, None]
        q_ptr.scatter_(1, wpos, torch.where(enq_t, ptr_t,
                                            q_ptr.gather(1, wpos)[:, 0])
                       [:, None])
        q_len = q_len + enq_t.to(torch.int32)
        evicted.append(torch.where(evict, ev_ptr, INVALID))
    return (q_ptr, q_head.to(torch.int32), q_len.to(torch.int32),
            torch.stack(evicted, -1).to(torch.int32))


def _stale_pass(shadow, any_reset):
    """Retire every LIVE start of a resetting core to STALE, in place, a
    few cores at a time; nothing to do when no core resets."""
    if not bool(any_reset.any()):
        return
    step = max(1, RESET_CHUNK // max(1, shadow.shape[-1]))
    for c0 in range(0, shadow.shape[0], step):
        s = shadow[c0:c0 + step]
        s.masked_fill_(any_reset[c0:c0 + step, None] & (s == SHADOW_LIVE),
                       SHADOW_STALE)


def step(cfg, st: SanitizerState, req: AllocRequest, inner_step):
    """One sanitized protocol round over ``[C, T]`` requests.

    ``inner_step`` is the wrapped backend step (`system._step_pim`): every
    FREE/REALLOC operand is classified against the round-start shadow,
    only clean work is forwarded, and poisoned operands get deterministic
    tagged responses. The shadow's scatters write in the reference's
    order (QUAR, FREE for evictions, MOVED, LIVE): where two hit one
    granule in a round, the later one wins."""
    from .system import SystemState

    op, size, ptr = req.op, req.size, req.ptr
    shadow = st.shadow
    n_gran = shadow.shape[-1]
    f32 = torch.float32

    # ---- an epoch reset applies at round start: every LIVE start is
    # retired to STALE (the wrapped heap keeps the blocks live)
    is_reset = op == OP_EPOCH_RESET
    any_reset = is_reset.any(-1)
    _stale_pass(shadow, any_reset)

    in_range = (ptr >= 0) & (ptr < cfg.heap_bytes)
    aligned = in_range & (ptr % GRANULE == 0)
    g = torch.where(in_range, ptr // GRANULE, 0).clamp(0, n_gran - 1)
    sh = shadow.gather(1, g.long())
    live = aligned & (sh == SHADOW_LIVE)
    quar = aligned & (sh == SHADOW_QUAR)
    moved_sh = aligned & (sh == SHADOW_MOVED)
    stale = aligned & (sh == SHADOW_STALE)

    # free-class: explicit FREE, or realloc(p, size<=0) == free(p); NULL
    # (ptr == -1) stays a benign pass-through no-op, as in every backend
    free_class = ((op == OP_FREE) | ((op == OP_REALLOC) & (size <= 0))) \
        & (ptr >= 0)
    realloc_live = (op == OP_REALLOC) & (size > 0) & (ptr >= 0)
    unknown = ~live & ~quar & ~moved_sh & ~stale

    tag = torch.zeros_like(op)
    tag = torch.where(free_class & quar, TAG_DOUBLE_FREE, tag)
    tag = torch.where(free_class & moved_sh, TAG_USE_AFTER_FREE, tag)
    tag = torch.where(free_class & stale, TAG_EPOCH_STALE, tag)
    tag = torch.where(free_class & unknown, TAG_WILD, tag)
    tag = torch.where(realloc_live & (quar | moved_sh),
                      TAG_REALLOC_AFTER_FREE, tag)
    tag = torch.where(realloc_live & stale, TAG_EPOCH_STALE, tag)
    tag = torch.where(realloc_live & unknown, TAG_WILD, tag).to(torch.int32)
    tagged = tag > 0

    quar_free = free_class & live          # legit retire -> quarantine
    # NOOP/MALLOC/CALLOC/live REALLOC (resets are answered locally)
    passthrough = ~free_class & ~tagged & ~is_reset

    # ---- quarantine ring: park legit frees, maybe release the oldest -----
    q_ptr, q_head, q_len, evicted = _quarantine_pass(
        st.q_ptr, st.q_head, st.q_len, quar_free, ptr)
    evict = evicted >= 0

    # ---- pre-step shadow poisoning (on the post-reset shadow) ------------
    drop_set_(shadow, g, SHADOW_QUAR, quar_free)
    g_ev = torch.where(evict, evicted // GRANULE, 0).clamp(0, n_gran - 1)
    drop_set_(shadow, g_ev, SHADOW_FREE, evict)

    # ---- the wrapped hwsw round on the filtered request ------------------
    inner_req = AllocRequest(
        op=torch.where(passthrough, op,
                       torch.where(evict, OP_FREE, 0).to(torch.int32)),
        size=torch.where(passthrough, size, 0).to(torch.int32),
        ptr=torch.where(passthrough, ptr,
                        torch.where(evict, evicted, INVALID))
        .to(torch.int32))
    inner_st = SystemState(alloc=st.alloc, cache=st.cache, telem=st.telem)
    inner_st, r = inner_step(cfg, inner_st, inner_req)

    # ---- post-step shadow updates from the wrapped responses -------------
    # a relocating realloc retires the old start; new allocations go LIVE
    re_moved = passthrough & (op == OP_REALLOC) & r.moved
    drop_set_(shadow, g, SHADOW_MOVED, re_moved)
    new_live = passthrough & (r.ptr >= 0) & (
        (op == OP_MALLOC) | (op == OP_CALLOC)
        | ((op == OP_REALLOC) & r.moved))
    g_new = torch.where(new_live, r.ptr // GRANULE, 0).clamp(0, n_gran - 1)
    drop_set_(shadow, g_new, SHADOW_LIVE, new_live)

    # ---- response synthesis -----------------------------------------------
    dpu = cfg.dpu
    zf = torch.zeros(op.shape, dtype=f32, device=op.device)
    # quarantined frees cost a freelist push plus the released (evicted)
    # free in this thread's wrapped slot; tagged ops one shadow peek
    lat = torch.where(
        passthrough, r.latency_cyc,
        torch.where(quar_free, dpu.cyc_front_push + r.latency_cyc,
                    torch.where(is_reset, zf + dpu.cyc_epoch_reset,
                                torch.where(tagged, zf + dpu.cyc_front_hit,
                                            zf))))
    neg = torch.full_like(op, INVALID)
    path = torch.where(
        passthrough, r.path,
        torch.where(quar_free | is_reset, 0,
                    torch.where(tagged & free_class, 2,
                                torch.where(tagged & realloc_live, 3, neg))))
    served = passthrough | quar_free
    zi = torch.zeros_like(op)
    resp = AllocResponse(
        ptr=torch.where(passthrough, r.ptr, neg),
        ok=torch.where(passthrough, r.ok, quar_free | is_reset),
        path=path.to(torch.int32),
        moved=passthrough & r.moved,
        latency_cyc=lat,
        backend_cyc=torch.where(served, r.backend_cyc, zf),
        meta_hits=torch.where(served, r.meta_hits, zi),
        meta_misses=torch.where(served, r.meta_misses, zi),
        dram_bytes=torch.where(served, r.dram_bytes, zi))

    def count(m):
        return m.sum(-1, dtype=torch.int32)

    # tagged misuse folds into the wrapped allocator's misuse accounting,
    # so replay reports (stats_dropped_frees) see it like any backend's
    stats = inner_st.alloc.stats
    stats = stats._replace(
        dropped_frees=stats.dropped_frees + count(tagged & free_class),
        fails=stats.fails + count(tagged & realloc_live))
    rep = st.reports
    rep = SanReports(
        double_free=rep.double_free + count(tag == TAG_DOUBLE_FREE),
        use_after_free=rep.use_after_free + count(tag == TAG_USE_AFTER_FREE),
        realloc_after_free=(rep.realloc_after_free
                            + count(tag == TAG_REALLOC_AFTER_FREE)),
        wild_ops=rep.wild_ops + count(tag == TAG_WILD),
        quarantined=rep.quarantined + count(quar_free),
        evicted=rep.evicted + count(evict),
        epoch_resets=rep.epoch_resets + any_reset.to(torch.int32),
        epoch_stale=rep.epoch_stale + count(tag == TAG_EPOCH_STALE))
    new_st = SanitizerState(
        alloc=inner_st.alloc._replace(stats=stats), cache=inner_st.cache,
        telem=inner_st.telem, shadow=shadow, q_ptr=q_ptr, q_head=q_head,
        q_len=q_len, tags=tag, reports=rep)
    return new_st, resp


def report(state: SanitizerState, core: int = 0) -> dict:
    """The cumulative misuse report of one core, in the reference's
    schema (docs/analysis.md)."""
    rep = {k: int(v[core]) for k, v in state.reports._asdict().items()}
    rep["last_round_tags"] = [TAG_NAMES[int(t)]
                              for t in state.tags[core].tolist()]
    rep["quarantine_backlog"] = int(state.q_len[core])
    return rep
