"""Layered frontend/backend allocator: a bump-pointer arena over the pim
stack.

The port of `repro.core.arena`: the paper's Section 2 frontend points as a
thin layer over the existing backend.

  arena     one shared bump-pointer region (half the heap, carved out of
            the buddy at init). Small allocs (<= the largest size class)
            bump a pointer; the shared bump add is an atomic, so
            same-round contenders serialize for ``cyc_bump_atomic`` cycles
            each. Frees hole-mark (the space is NOT reclaimed);
            ``OP_EPOCH_RESET`` retires the whole epoch at once.
  tlregion  the same frontend with the region split per thread: each
            thread bumps and resets its own region, so the fast path has
            no cross-thread atomic.

Everything the arena does not own (big allocs, arena exhaustion, non-arena
pointers) is forwarded to the full ``hwsw`` stack, or to the fused round
(the heap-step kernel on the card) when ``SystemConfig.arena_inner ==
"fused"``; the two inner backends are bitwise-identical.

Layout and conservation: the region occupies ``[0, arena_bytes)`` and is
never visible to the backend's metadata; the arena's unplaced and holed
bytes count as cached frontend bytes
(`repro_torch.core.telemetry.frontend_cached_bytes`). A reset applies at
round start: same-round frees of arena pointers see the cleared map.

Every tensor carries a leading core axis: ``cls_map [C, n_gran]``, ``bump
[C, 1]`` (arena) or ``[C, T]`` (tlregion), ``epoch [C]``; requests are
``[C, T]``. `step` consumes its state (the map is updated in place). The
reset pass runs only in rounds where some thread of some core resets; a
round without one leaves the map and frees nothing, exactly as the
reference's full pass would.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device
from ..kernels import freelist
from . import buddy, cost_model, pim_malloc
from .heap import (OP_CALLOC, OP_EPOCH_RESET, OP_FREE, OP_MALLOC, OP_NOOP,
                   OP_REALLOC, AllocRequest, AllocResponse)
from .pim_malloc import INVALID

# placements are tracked at allocation start granules, like the
# sanitizer's shadow map: every size class is a multiple of 16 B
GRANULE = 16


def arena_bytes(cfg) -> int:
    """Size of the region carved for the bump frontend: half the heap."""
    ab = cfg.heap_bytes // 2
    if ab % cfg.pm.block_bytes:
        raise ValueError(f"arena region {ab} must be block-aligned "
                         f"({cfg.pm.block_bytes})")
    return ab


def n_granules(cfg) -> int:
    return arena_bytes(cfg) // GRANULE


def region_granules(cfg) -> int:
    """Granules per thread region (``tlregion``) or the whole arena."""
    n = n_granules(cfg)
    if cfg.kind != "tlregion":
        return n
    if n % cfg.num_threads:
        raise ValueError(f"{n} granules not splittable across "
                         f"{cfg.num_threads} threads")
    return n // cfg.num_threads


class ArenaSystemState(NamedTuple):
    """Backend state + the arena frontend's placement map. The leading
    (alloc, cache, telem) triple mirrors `system.SystemState`, so
    telemetry, replay reports and `api.HeapClient.stats` read it
    unchanged."""

    alloc: object            # PimMallocState (the spill backend)
    cache: object            # BuddyCacheState (the hwsw metadata path)
    telem: object            # system.HeapTelemetry
    cls_map: torch.Tensor    # int32[C, n_gran] class at start granule, -1
    bump: torch.Tensor       # int32[C, 1] (arena) | [C, T] (tlregion)
    epoch: torch.Tensor      # int32[C] completed resets


def init_state(cfg, device="cuda") -> ArenaSystemState:
    """One core's state: the arena region carved out of a pristine
    ``prepopulate=False`` heap. The freelists start empty (spills refill
    them on demand) and the region is not recorded in the backend's block
    metadata. The carve runs on the host and must land at offset 0."""
    from .system import HeapTelemetry

    device = _device.resolve(device)
    pmc = cfg.pm
    ab = arena_bytes(cfg)
    inner = pim_malloc.init(pmc, prepopulate=False, device="cpu")
    bst, off = buddy.alloc_host(pmc.buddy_cfg, inner.buddy, ab)
    if off != 0:
        raise AssertionError(f"the arena carve landed at {off}, not 0")
    inner = inner._replace(buddy=bst)
    inner = type(inner)(*(_to(x, device) for x in inner))
    n_bump = cfg.num_threads if cfg.kind == "tlregion" else 1
    region_granules(cfg)  # validate the per-thread split early
    z = torch.zeros((), dtype=torch.int32, device=device)
    return ArenaSystemState(
        alloc=inner, cache=cfg.cache_init(device),
        telem=HeapTelemetry(live_bytes=z, hwm_bytes=z.clone()),
        cls_map=torch.full((n_granules(cfg),), -1, dtype=torch.int32,
                           device=device),
        bump=torch.zeros((n_bump,), dtype=torch.int32, device=device),
        epoch=z.clone())


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(x, device) for x in tree))


def arena_live_bytes(cfg, cls_map) -> torch.Tensor:
    """Rounded bytes placed in the arena, per core: int64 ``[...]`` over a
    ``[..., n_gran]`` map, reduced on the map's device a few cores at a
    time (only the per-core sums leave it)."""
    class_sizes = pim_malloc._classes(cfg.pm, cls_map.device).to(torch.int64)
    nc = cfg.pm.nc
    flat = cls_map.reshape(-1, cls_map.shape[-1])
    step = max(1, freelist.RESET_CHUNK // max(1, flat.shape[-1]))
    out = []
    for c0 in range(0, flat.shape[0], step):
        m = flat[c0:c0 + step]
        out.append(torch.where(m >= 0, class_sizes[m.clamp(0, nc - 1).long()],
                               0).sum(-1))
    out = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)
    return out.reshape(cls_map.shape[:-1])


def _reset_pass(cfg, cls_map, is_reset, tl: bool, class_sizes):
    """Phase 0 on the map: clear what this round's resets retire; returns
    the freed bytes [C]. Runs only when some thread of some core resets:
    otherwise the map is kept and nothing is freed, exactly."""
    C, T = is_reset.shape
    if not bool(is_reset.any()):
        return torch.zeros((C,), dtype=torch.int32, device=cls_map.device)
    if tl:
        regions = cls_map.view(C, T, region_granules(cfg))
        _, freed = freelist.arena_region_reset(regions, class_sizes,
                                               is_reset[:, :, None])
    else:
        _, freed = freelist.arena_region_reset(
            cls_map, class_sizes, is_reset.any(-1, keepdim=True))
    return freed


def step(cfg, st: ArenaSystemState, req: AllocRequest, inner_step):
    """One layered protocol round over ``[C, T]`` requests: the arena
    pass, the forwarded backend round, then the merge.

    ``inner_step`` is the spill backend (`system._step_pim` or
    `system._step_fused`). Phases: (0) EPOCH_RESET at round start (shared:
    any resetting thread clears the whole arena; tlregion: each resetting
    thread its own region); (1) ownership against the post-reset map and
    bump allocation for small MALLOC/CALLOC and small relocation targets
    (a failed fit consumes no space); (2) everything unowned or unserved
    goes to the backend; (3) merge: hole-mark retired arena blocks, fold
    the arena's counters into the shared Stats, price arena-served ops
    with the bump path's cycles, advance the telemetry. Every gather is
    clamped explicitly, as JAX clamps it."""
    from .system import SystemState, _advance_telemetry

    pmc = cfg.pm
    dpu = cfg.dpu
    tl = cfg.kind == "tlregion"
    ab = arena_bytes(cfg)
    n_gran = n_granules(cfg)
    region_gran = region_granules(cfg)
    f32 = torch.float32

    op, size, ptr = req.op, req.size, req.ptr
    dev = op.device
    class_sizes = pim_malloc._classes(pmc, dev)
    is_alloc = (op == OP_MALLOC) | (op == OP_CALLOC)
    is_re = op == OP_REALLOC
    is_free = op == OP_FREE
    is_reset = op == OP_EPOCH_RESET
    zf = torch.zeros(op.shape, dtype=f32, device=dev)

    # ---- phase 0: epoch reset at round start -----------------------------
    any_reset = is_reset.any(-1)
    if tl:
        bump = torch.where(is_reset, 0, st.bump).to(torch.int32)
    else:
        bump = torch.where(any_reset[:, None], 0, st.bump).to(torch.int32)
    cls_map = st.cls_map
    reset_freed = _reset_pass(cfg, cls_map, is_reset, tl, class_sizes)
    epoch = st.epoch + any_reset.to(torch.int32)

    # ---- ownership classification (post-reset map) -----------------------
    in_arena = (ptr >= 0) & (ptr < ab) & (ptr % GRANULE == 0)
    g_old = torch.where(in_arena, ptr // GRANULE, 0).clamp(0, n_gran - 1)
    at_old = cls_map.gather(1, g_old.long())
    owned = in_arena & (at_old >= 0)
    old_cls = torch.where(owned, at_old, -1)
    old_bytes = torch.where(
        owned, class_sizes[old_cls.clamp(0, pmc.nc - 1).long()], 0)

    small = (size > 0) & (size <= pmc.max_class)
    cls = pim_malloc._class_of(pmc, size)
    cls_bytes = class_sizes[cls.clamp(0, pmc.nc - 1).long()]
    gneed = cls_bytes // GRANULE

    re_free0 = is_re & (size <= 0) & (ptr >= 0)
    arena_free = (is_free | re_free0) & owned
    re_live = is_re & (size > 0)
    re_arena = re_live & owned
    same = small & (cls == old_cls)
    re_inplace = re_arena & same
    re_move = re_arena & ~same

    # ---- phase 1: bump allocation ----------------------------------------
    plain_small = is_alloc & small
    bump_cand = plain_small | (re_move & small)
    if tl:
        bump, g_new, served = freelist.arena_bump_tl(bump, bump_cand, gneed,
                                                     region_gran)
        bump_wait = zf
    else:
        b, g_new, served = freelist.arena_bump_shared(bump[:, 0], bump_cand,
                                                      gneed, n_gran)
        bump = b[:, None]
        # every attempter serializes on the shared atomic add, served or not
        cand_i = bump_cand.to(torch.int32)
        rank = torch.cumsum(cand_i, -1, dtype=torch.int32) - cand_i
        bump_wait = torch.where(bump_cand, rank.to(f32) * dpu.cyc_bump_atomic,
                                zf)

    arena_alloc = plain_small & served
    re_move_bump = re_move & small & served
    move_to_inner = re_move & ~re_move_bump   # big new size, or arena full

    # ---- phase 2: forwarded backend round --------------------------------
    consumed = arena_alloc | arena_free | re_inplace | re_move_bump | is_reset
    inner_req = AllocRequest(
        op=torch.where(move_to_inner, OP_MALLOC,
                       torch.where(consumed, OP_NOOP, op)).to(torch.int32),
        size=torch.where(consumed & ~move_to_inner, 0, size).to(torch.int32),
        ptr=torch.where(consumed | move_to_inner, INVALID, ptr)
        .to(torch.int32))
    inner_st = SystemState(alloc=st.alloc, cache=st.cache, telem=st.telem)
    inner_st, r = inner_step(cfg, inner_st, inner_req)

    # ---- phase 3: merge ----------------------------------------------------
    move_ok = re_move_bump | (move_to_inner & r.ok)
    freelist.arena_mark(cls_map, g_new, cls, arena_alloc | re_move_bump)
    freelist.arena_hole(cls_map, g_old, arena_free | move_ok)

    new_ptr = g_new * GRANULE
    passthrough = ~consumed & ~move_to_inner

    # pricing: the bump path's cycles for arena-served ops, the backend's
    # DMA pricing for calloc zero-fill and relocation copies; the float32
    # terms are added in the reference's order
    new_rounded = torch.where(
        small, cls_bytes,
        buddy.next_pow2(torch.clamp(size, min=pmc.block_bytes)))
    copy_bytes = torch.minimum(old_bytes, new_rounded)
    zero_cyc = torch.where((op == OP_CALLOC) & arena_alloc,
                           cost_model.mram_access_cyc(dpu, size), zf)
    lat = torch.where(passthrough, r.latency_cyc, zf)
    lat = lat + torch.where(arena_alloc, dpu.cyc_bump + bump_wait + zero_cyc,
                            zf)
    lat = lat + torch.where(
        re_move_bump,
        dpu.cyc_bump + bump_wait + cost_model.mram_access_cyc(dpu, copy_bytes),
        zf)
    lat = lat + torch.where(
        move_to_inner,
        r.latency_cyc + torch.where(
            r.ok, cost_model.mram_access_cyc(dpu, copy_bytes), zf),
        zf)
    lat = lat + torch.where(re_inplace, zf + dpu.cyc_front_hit, zf)
    lat = lat + torch.where(arena_free, zf + dpu.cyc_front_push, zf)
    lat = lat + torch.where(is_reset, zf + dpu.cyc_epoch_reset, zf)

    arena_ok = arena_alloc | re_move_bump | re_inplace | arena_free | is_reset
    fwd = passthrough | move_to_inner
    zi = torch.zeros_like(op)
    resp = AllocResponse(
        ptr=torch.where(arena_alloc | re_move_bump, new_ptr,
                        torch.where(re_inplace, ptr,
                                    torch.where(fwd, r.ptr, INVALID)))
        .to(torch.int32),
        ok=torch.where(fwd, r.ok, arena_ok),
        path=torch.where(arena_ok, 0, torch.where(fwd, r.path, INVALID))
        .to(torch.int32),
        moved=re_move_bump | (move_to_inner & r.ok) | (passthrough & r.moved),
        latency_cyc=lat,
        backend_cyc=torch.where(fwd, r.backend_cyc, zf),
        meta_hits=torch.where(fwd, r.meta_hits, zi),
        meta_misses=torch.where(fwd, r.meta_misses, zi),
        dram_bytes=torch.where(fwd, r.dram_bytes, zi))

    # arena-served work folds into the shared Stats, so replay reports and
    # the facade see one counter set across the layers
    def count(m):
        return m.sum(-1, dtype=torch.int32)

    stats = inner_st.alloc.stats
    stats = stats._replace(
        front_hits=stats.front_hits + count(arena_alloc | re_move_bump),
        frees_small=stats.frees_small + count(arena_free | move_ok))
    arena_alloc_bytes = torch.where(arena_alloc | re_move_bump, cls_bytes,
                                    zi).sum(-1, dtype=torch.int32)
    arena_freed_bytes = reset_freed + torch.where(
        arena_free | move_ok, old_bytes, zi).sum(-1, dtype=torch.int32)
    telem = _advance_telemetry(inner_st.telem, arena_alloc_bytes,
                               arena_freed_bytes)
    new_st = ArenaSystemState(
        alloc=inner_st.alloc._replace(stats=stats), cache=inner_st.cache,
        telem=telem, cls_map=cls_map, bump=bump, epoch=epoch)
    return new_st, resp
