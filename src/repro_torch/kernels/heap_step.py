"""One full heap-protocol round per PIM core: the fused CUDA kernel and its
plain PyTorch version.

This is the port of `repro.kernels.heap_step` (the ``pallas`` design
point). One round runs, for every core:

  * the realloc size-class analysis on the pre-round metadata;
  * vectorized per-thread LIFO freelist pops (the thread-cache frontend);
  * the serial buddy backend in thread (mutex) order: descent and up-walk,
    carving a refilled block into the thread's freelist or recording a
    bypass block's size;
  * vectorized free pushes, then serial buddy coalescing for big frees;
  * every buddy-tree node touched passes through the 16-entry LRU buddy
    cache, with hit and miss counters per thread.

`protocol_round` is the plain PyTorch version, batched over an explicit
core axis ``[C, ...]`` with masks (loops only over threads and tree depth).
`fused_heap_step` is the wrapper the main path calls: for CUDA tensors it
launches ``csrc/heap_step.cu`` (one CTA of 32 threads per core), for CPU
tensors it runs `protocol_round`. Both follow the reference's batched
refill (``batch_refill``, default on): a core whose backend ops all
allocate one block from a free run is served by one run-carve instead of
the serial walks (`backend_branch` decides, as the reference's three-way
switch). Both settings are bit-for-bit equal to the reference's round.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from ..core.buddy import ilog2, next_pow2
from ..core.buddy_cache import NODES_PER_WORD
from . import _library
from . import buddy_traverse as bt
from . import freelist as fl

INVALID = -1
N_STATE = 9     # leading FusedRoundOut fields that are state leaves
N_RECORDS = 22  # trailing int32[C, T] per-thread records


class FusedRoundOut(NamedTuple):
    """Round outputs: new state leaves + per-thread int32 round records,
    every leaf with a leading core axis."""

    longest: torch.Tensor
    counts: torch.Tensor
    stacks: torch.Tensor
    block_cls: torch.Tensor
    block_free: torch.Tensor
    big_log2: torch.Tensor
    tags: torch.Tensor
    last_used: torch.Tensor
    clock: torch.Tensor       # int32[C]
    m_ptr: torch.Tensor       # malloc-phase result pointer (-1 idle/fail)
    m_hit: torch.Tensor       # thread-cache hit (case 1)
    m_refill: torch.Tensor    # thread-cache miss -> backend refill (case 2)
    m_bypass: torch.Tensor    # > max class -> backend bypass (case 3)
    m_okb: torch.Tensor       # backend op succeeded
    m_bpos: torch.Tensor      # backend serialization order, -1 = frontend
    m_lvdown: torch.Tensor
    m_lvup: torch.Tensor
    m_hits: torch.Tensor      # buddy-cache hits charged to this thread
    m_miss: torch.Tensor
    f_push: torch.Tensor      # free pushed to the caller's freelist
    f_big: torch.Tensor       # free went to the buddy backend
    f_over: torch.Tensor      # free dropped (freelist at capacity)
    f_bpos: torch.Tensor
    f_lvup: torch.Tensor
    f_hits: torch.Tensor
    f_miss: torch.Tensor
    valid_old: torch.Tensor   # realloc meta: ptr maps to tracked metadata
    in_place: torch.Tensor    # realloc served in place (live request)
    moved_raw: torch.Tensor   # realloc needs relocation
    old_bytes: torch.Tensor
    new_bytes: torch.Tensor


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def _take(x, idx):
    """x[c, idx[c]] for a [C, N] table and [C] or [C, K] indices."""
    if idx.dim() == 1:
        return x.gather(1, idx.long()[:, None])[:, 0]
    return x.gather(1, idx.long())


def _put(x, idx, val, mask):
    """x[c, idx[c]] = val[c] where mask[c], in place ([C] indices)."""
    i = idx.long()[:, None]
    x.scatter_(1, i, torch.where(mask, val, x.gather(1, i)[:, 0])[:, None])


class _Lru:
    """The 16-entry LRU buddy cache of C cores, updated in place."""

    def __init__(self, tags, last_used, clock):
        self.tags, self.lu, self.clock = tags, last_used, clock

    def access(self, node):
        """One access per core (node < 0 = inactive); returns (hit, miss)
        as int32[C]."""
        valid = node >= 0
        word = torch.clamp(node, min=0) // NODES_PER_WORD
        match = self.tags == word[:, None]
        hit = valid & match.any(1)
        # argmax / argmin return the first extremum, as the reference's do
        idx = torch.where(hit, match.to(torch.int32).argmax(1),
                          self.lu.argmin(1))
        _put(self.tags, idx, word, valid)
        _put(self.lu, idx, self.clock, valid)
        self.clock += valid.to(torch.int32)
        return (valid & hit).to(torch.int32), (valid & ~hit).to(torch.int32)


def _buddy_alloc(longest, lru, size, need, *, heap_bytes, block_bytes, depth):
    """Descent + up-walk of C trees, committed where `need`. Returns
    (off, lvd, lvu, hits, misses); lvd/lvu are unmasked."""
    C, n_nodes = longest.shape
    size_r = torch.clamp(next_pow2(size), min=block_bytes)
    ok = (size_r <= heap_bytes) & (longest[:, 1] >= size_r)
    one = torch.ones_like(size)
    hh, mm = lru.access(torch.where(need, one, -one))
    node, node_size = one.clone(), torch.full_like(size, heap_bytes)
    lvd = torch.zeros_like(size)
    for _ in range(depth):
        descend = node_size > size_r
        left = 2 * node
        go_left = _take(longest, torch.clamp(left, max=n_nodes - 1)) >= size_r
        node = torch.where(descend, torch.where(go_left, left, left + 1), node)
        node_size = torch.where(descend, node_size >> 1, node_size)
        lvd += descend.to(torch.int32)
        h, m = lru.access(torch.where(need & descend, node, -one))
        hh, mm = hh + h, mm + m
    offset = node * node_size - heap_bytes
    _put(longest, node, torch.zeros_like(node), need & ok)
    n, lvu = node, torch.zeros_like(size)
    for _ in range(depth):
        parent = n >> 1
        active = ok & (parent >= 1)
        p = torch.clamp(parent, min=1)
        newval = torch.maximum(_take(longest, 2 * p), _take(longest, 2 * p + 1))
        _put(longest, p, newval, need & active)
        lvu += active.to(torch.int32)
        h, m = lru.access(torch.where(need & active, p, -one))
        hh, mm = hh + h, mm + m
        n = torch.where(active, p, torch.zeros_like(p))
    off = torch.where(ok, offset, -one)
    return off, lvd, lvu, hh, mm


def _buddy_free(longest, lru, ptr, lg, big, *, heap_bytes, depth):
    """Coalescing up-walk of C trees, committed where `big`; `lg` is the
    recorded log2(size) of the bypass block. Returns (lvu, hits, misses)."""
    C, n_nodes = longest.shape
    one = torch.ones_like(ptr)
    fsize = one << torch.clamp(lg, min=0)
    node = torch.clamp((ptr + heap_bytes) // torch.clamp(fsize, min=1), 0,
                       n_nodes - 1)
    valid = big & (ptr >= 0) & (ptr < heap_bytes) & (_take(longest, node) == 0)
    hh, mm = lru.access(torch.where(big, node, -one))
    _put(longest, node, fsize, valid)
    n, nsize, lvu = node, fsize, torch.zeros_like(ptr)
    for _ in range(depth):
        parent = n >> 1
        active = valid & (parent >= 1)
        p = torch.clamp(parent, min=1)
        psize = nsize << 1
        lt, rt = _take(longest, 2 * p), _take(longest, 2 * p + 1)
        newval = torch.where((lt == nsize) & (rt == nsize), psize,
                             torch.maximum(lt, rt))
        _put(longest, p, newval, active)
        lvu += active.to(torch.int32)
        h, m = lru.access(torch.where(big & active, p, -one))
        hh, mm = hh + h, mm + m
        n, nsize = torch.where(active, p, torch.zeros_like(p)), psize
    return lvu, hh, mm


def backend_branch(need, bypass, msizes, longest, *, heap_bytes: int,
                   block_bytes: int):
    """Which backend path each core's round takes, as the reference's
    three-way switch decides it: int32[C] 0 = skip (no backend op), 1 =
    run-carve (every needy thread allocates exactly one block, and the run
    of blocks from the leftmost free one is free), 2 = the serial walk.
    Returns (branch, b0, n_need, rank): the run's first block, the number
    of needy threads and each thread's rank among them (mutex order)."""
    nb = heap_bytes // block_bytes
    depth = nb.bit_length() - 1
    T = need.shape[-1]
    need_i = need.to(torch.int32)
    n_need = need_i.sum(1, dtype=torch.int32)
    rank = torch.cumsum(need_i, 1, dtype=torch.int32) - need_i
    alloc_size = torch.where(
        bypass, next_pow2(torch.clamp(msizes, min=block_bytes)),
        torch.full_like(msizes, block_bytes))
    all_block = torch.where(need, alloc_size == block_bytes, True).all(1)
    b0 = bt.leftmost_block(longest, heap_bytes=heap_bytes,
                           block_bytes=block_bytes, depth=depth)
    run_ok = bt.run_blocks_free(longest, b0, n_need, window=T,
                                heap_bytes=heap_bytes,
                                block_bytes=block_bytes)
    eligible = (all_block & (longest[:, 1] >= block_bytes)
                & (b0 + n_need <= nb) & run_ok)
    branch = torch.where(n_need == 0, 0, torch.where(eligible, 1, 2))
    return branch.to(torch.int32), b0, n_need, rank


def protocol_round(op, size, ptr, longest, counts, stacks, block_cls,
                   block_free, big_log2, tags, last_used, clock, *,
                   heap_bytes: int, block_bytes: int, size_classes: tuple,
                   batch_refill: bool = True) -> FusedRoundOut:
    """Plain PyTorch version of the fused round, over ``[C, ...]`` leaves.

    Takes op/size/ptr int32[C, T], the state leaves (longest [C, 2nb],
    counts [C, T, NC], stacks [C, T, NC, CAP], block_cls / block_free /
    big_log2 [C, nb], tags / last_used [C, E], clock [C]) and returns new
    tensors; the inputs are left unchanged.

    ``batch_refill`` follows the reference's three-way switch per core
    (`backend_branch`): a core whose round is eligible is served by one
    run-carve (`buddy_traverse.carve_run`), a bulk freelist refill
    (`freelist.bulk_refill`) and the serial walks' exact LRU access
    sequence, instead of T serial walks. ``False`` always walks. Both are
    bitwise-identical.
    """
    C, T = op.shape
    dev = op.device
    i32 = torch.int32
    nb = heap_bytes // block_bytes
    depth = nb.bit_length() - 1
    nc = len(size_classes)
    cap = stacks.shape[-1]
    max_sub = block_bytes // min(size_classes)
    max_class = max(size_classes)
    log2_min_class = min(size_classes).bit_length() - 1
    log2_block = block_bytes.bit_length() - 1  # ilog2 of one block
    class_sizes = torch.tensor(size_classes, dtype=i32, device=dev)
    longest, counts, stacks = longest.clone(), counts.clone(), stacks.clone()
    block_cls, big_log2 = block_cls.clone(), big_log2.clone()
    # one park column absorbs the reference's dropped (index nb) updates
    bfree = torch.cat([block_free, block_free.new_zeros((C, 1))], 1)
    lru = _Lru(tags.clone(), last_used.clone(), clock.clone())
    cs = torch.arange(C, device=dev)
    ts = torch.arange(T, device=dev)
    cc, tt = cs[:, None], ts[None, :]
    z = torch.zeros((C, T), dtype=i32, device=dev)
    zc, minus1 = z[:, 0], z[:, 0] - 1

    def class_of(x):
        rounded = next_pow2(torch.clamp(x, min=min(size_classes)))
        return torch.clamp(ilog2(rounded) - log2_min_class, 0, nc - 1)

    def csize_of(c):
        return class_sizes[c.long()]

    is_alloc = (op == 1) | (op == 4)          # OP_MALLOC | OP_CALLOC
    is_re = op == 3                           # OP_REALLOC
    is_free = op == 2                         # OP_FREE

    # ---- realloc size-class analysis on the pre-round metadata ------------
    pvalid = (ptr >= 0) & (ptr < heap_bytes)
    pb = torch.where(pvalid, ptr // block_bytes, z)
    pcls = _take(block_cls, pb)
    plg = _take(big_log2, pb)
    small_old = pvalid & (pcls >= 0)
    big_old = pvalid & (pcls < 0) & (plg >= 0) & (ptr % block_bytes == 0)
    old_bytes = torch.where(
        small_old, csize_of(torch.clamp(pcls, min=0)),
        torch.where(big_old, (z + 1) << torch.clamp(plg, min=0), z))
    new_small = size <= max_class
    new_bytes = torch.where(new_small, csize_of(class_of(size)),
                            next_pow2(torch.clamp(size, min=block_bytes)))
    in_place_meta = ((small_old & new_small) | (big_old & ~new_small)) & (
        new_bytes == old_bytes)
    valid_old = small_old | big_old
    re_live = is_re & (size > 0)
    in_place = re_live & in_place_meta
    moved = re_live & ~in_place_meta
    re_free0 = is_re & (size <= 0) & (ptr >= 0)

    # ---- malloc phase A: vectorized thread-cache pops ---------------------
    m_active = (is_alloc & (size > 0)) | moved
    msizes = torch.where(m_active, size, z)
    too_big = m_active & (msizes > heap_bytes)
    small = m_active & (msizes <= max_class) & (msizes > 0)
    c = class_of(msizes)
    cl = c.long()
    cnt = counts[cc, tt, cl]
    hit = small & (cnt > 0)
    ptr_a = stacks[cc, tt, cl, torch.clamp(cnt - 1, min=0).long()]
    counts[cc, tt, cl] = cnt - hit.to(i32)
    blk_a = torch.where(hit, ptr_a // block_bytes, z + nb)
    bfree.scatter_add_(1, blk_a.long(), -hit.to(i32))
    refill = small & ~hit
    bypass = m_active & (msizes > max_class) & ~too_big
    need = refill | bypass

    # ---- malloc phase B: the backend (mutex order = thread order) ---------
    if batch_refill:
        branch, b0, n_need, rank = backend_branch(
            need, bypass, msizes, longest, heap_bytes=heap_bytes,
            block_bytes=block_bytes)
    else:
        branch = torch.full_like(zc, 2)
    fast = branch == 1
    m_ptr_b, m_bpos, m_okb = z - 1, z - 1, z.clone()
    m_lvd, m_lvu, m_hits, m_miss = z.clone(), z.clone(), z.clone(), z.clone()
    border = zc.clone()
    sub_idx = torch.arange(max_sub, dtype=i32, device=dev)
    serial_need = need & (branch == 2)[:, None]
    for t in range(T):
        need_t = serial_need[:, t]
        if not bool(need_t.any()):
            continue  # no core uses the backend on this thread: a no-op
        refill_t, bypass_t = refill[:, t], bypass[:, t]
        c_t = c[:, t]
        alloc_size = torch.where(
            bypass_t, next_pow2(torch.clamp(msizes[:, t], min=block_bytes)),
            torch.full_like(c_t, block_bytes))
        off, lvd, lvu, hh, mm = _buddy_alloc(
            longest, lru, alloc_size, need_t, heap_bytes=heap_bytes,
            block_bytes=block_bytes, depth=depth)
        ok = need_t & (off >= 0)

        # refill: carve the block into sub-blocks, push all, pop the top
        csize = csize_of(c_t)
        sub = block_bytes // csize
        row = torch.where(sub_idx[None, :] < sub[:, None],
                          off[:, None] + sub_idx[None, :] * csize[:, None],
                          torch.full_like(sub[:, None], INVALID))
        do_refill = refill_t & ok
        ctl = c_t.long()
        stacks[cs, t, ctl, :max_sub] = torch.where(
            do_refill[:, None], row, stacks[cs, t, ctl, :max_sub])
        counts[cs, t, ctl] = torch.where(do_refill, sub - 1,
                                         counts[cs, t, ctl])
        b = torch.where(off >= 0, off // block_bytes, zc)
        _put(block_cls, b, c_t, do_refill)
        _put(bfree, b, sub - 1, do_refill)
        ptr_refill = off + (sub - 1) * csize

        # bypass: record size so a ptr-only free can recover it
        do_bypass = bypass_t & ok
        _put(big_log2, b, ilog2(alloc_size), do_bypass)

        m_ptr_b[:, t] = torch.where(do_refill, ptr_refill,
                                    torch.where(do_bypass, off, minus1))
        m_bpos[:, t] = torch.where(need_t, border, minus1)
        m_okb[:, t] = ok.to(i32)
        m_lvd[:, t] = torch.where(need_t, lvd, zc)
        m_lvu[:, t] = torch.where(need_t, lvu, zc)
        m_hits[:, t], m_miss[:, t] = hh, mm
        border += need_t.to(i32)
    if bool(fast.any()):
        # the run-carve cores: needy thread k (in mutex order) carves block
        # b0 + k; the serial walks' LRU accesses are replayed exactly: per
        # needy thread the root, the descent to its leaf, the up-walk
        blocks = b0[:, None] + rank
        leaf = nb + blocks
        fneed = need & fast[:, None]
        for t in range(T):
            act = fneed[:, t]
            if not bool(act.any()):
                continue
            path = ([torch.ones_like(zc)]
                    + [leaf[:, t] >> s for s in range(depth - 1, -1, -1)]
                    + [leaf[:, t] >> s for s in range(1, depth + 1)])
            hh, mm = zc.clone(), zc.clone()
            for node in path:
                h, m = lru.access(torch.where(act, node, minus1))
                hh, mm = hh + h, mm + m
            m_hits[:, t] = torch.where(act, hh, m_hits[:, t])
            m_miss[:, t] = torch.where(act, mm, m_miss[:, t])
        carved = bt.carve_run(longest, b0, n_need, window=T,
                              heap_bytes=heap_bytes, block_bytes=block_bytes)
        longest = torch.where(fast[:, None], carved, longest)
        off = blocks * block_bytes
        csize = csize_of(c)
        sub = block_bytes // csize
        rows = torch.where(sub_idx < sub[..., None],
                           off[..., None] + sub_idx * csize[..., None],
                           INVALID)
        do_refill = refill & fast[:, None]
        stacks, counts = fl.bulk_refill(stacks, counts, do_refill, c, rows,
                                        sub - 1)
        do_bypass = bypass & fast[:, None]
        for t in range(T):
            b = torch.where(fneed[:, t], blocks[:, t], zc)
            _put(block_cls, b, c[:, t], do_refill[:, t])
            _put(bfree, b, sub[:, t] - 1, do_refill[:, t])
            _put(big_log2, b, torch.full_like(zc, log2_block),
                 do_bypass[:, t])
        fc = fast[:, None]
        m_ptr_b = torch.where(
            fc, torch.where(refill, off + (sub - 1) * csize,
                            torch.where(bypass, off, z - 1)), m_ptr_b)
        m_bpos = torch.where(fc, torch.where(need, rank, z - 1), m_bpos)
        m_okb = torch.where(fc, need.to(i32), m_okb)
        walked = torch.where(need, z + depth, z)  # to a leaf and back
        m_lvd = torch.where(fc, walked, m_lvd)
        m_lvu = torch.where(fc, walked, m_lvu)
    mptrs = torch.where(hit, ptr_a, m_ptr_b)
    mok = m_active & (mptrs >= 0)

    # ---- free phase: explicit frees + vacated realloc blocks --------------
    f_active = is_free | (moved & valid_old & mok) | re_free0
    fptr = torch.where(f_active, ptr, z - 1)
    factive = f_active & (fptr >= 0) & (fptr < heap_bytes)
    fb = torch.where(factive, fptr // block_bytes, z)
    fcls = _take(block_cls, fb)
    fsmall = factive & (fcls >= 0)
    fbig = (factive & (fcls < 0) & (_take(big_log2, fb) >= 0)
            & (fptr % block_bytes == 0))
    csel = torch.clamp(fcls, min=0).long()
    fpos = counts[cc, tt, csel]
    over = fsmall & (fpos >= cap)
    push = fsmall & ~over
    possafe = torch.clamp(fpos, max=cap - 1).long()
    stacks[cc, tt, csel, possafe] = torch.where(
        push, fptr, stacks[cc, tt, csel, possafe])
    counts[cc, tt, csel] = fpos + push.to(i32)
    bfree.scatter_add_(1, torch.where(push, fb, z + nb).long(), push.to(i32))

    f_bpos, f_lvu, f_hits, f_miss = z - 1, z.clone(), z.clone(), z.clone()
    border = zc.clone()
    for t in range(T):
        big_t = fbig[:, t]
        if not bool(big_t.any()):
            continue  # no core frees to the backend on this thread: a no-op
        fb_t = fb[:, t]
        lvu, hh, mm = _buddy_free(
            longest, lru, fptr[:, t], _take(big_log2, fb_t), big_t,
            heap_bytes=heap_bytes, depth=depth)
        _put(big_log2, fb_t, minus1, big_t)
        f_bpos[:, t] = torch.where(big_t, border, minus1)
        f_lvu[:, t] = torch.where(big_t, lvu, zc)
        f_hits[:, t], f_miss[:, t] = hh, mm
        border += big_t.to(i32)

    b32 = lambda m: m.to(i32)  # noqa: E731
    return FusedRoundOut(
        longest=longest, counts=counts, stacks=stacks, block_cls=block_cls,
        block_free=bfree[:, :nb].contiguous(), big_log2=big_log2,
        tags=lru.tags, last_used=lru.lu, clock=lru.clock,
        m_ptr=mptrs, m_hit=b32(hit), m_refill=b32(refill),
        m_bypass=b32(bypass), m_okb=m_okb, m_bpos=m_bpos, m_lvdown=m_lvd,
        m_lvup=m_lvu, m_hits=m_hits, m_miss=m_miss,
        f_push=b32(push), f_big=b32(fbig), f_over=b32(over), f_bpos=f_bpos,
        f_lvup=f_lvu, f_hits=f_hits, f_miss=f_miss,
        valid_old=b32(valid_old), in_place=b32(in_place),
        moved_raw=b32(moved), old_bytes=old_bytes, new_bytes=new_bytes)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------
def _check_leaves(op, state, *, T, nb, E):
    """Raise on what the kernel does not take: device, dtype, shape,
    contiguity (pointers are passed raw)."""
    C = op.shape[0]
    want = {"op": (C, T), "size": (C, T), "ptr": (C, T),
            "longest": (C, 2 * nb), "block_cls": (C, nb),
            "block_free": (C, nb), "big_log2": (C, nb),
            "tags": (C, E), "last_used": (C, E), "clock": (C,)}
    for name, x in state.items():
        if x.device != op.device or x.dtype != torch.int32:
            raise ValueError(f"{name}: want int32 on {op.device}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(x.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {want[name]}")
    if state["counts"].shape[:2] != (C, T) or \
            state["stacks"].shape[:3] != state["counts"].shape:
        raise ValueError("counts/stacks must be [C, T, NC] / [C, T, NC, CAP]")


def batch_refill_default() -> bool:
    """The batched refill's default, from ``PIM_MALLOC_BATCH_REFILL`` (on
    unless it is 0, false or off), as the reference resolves it."""
    return os.environ.get("PIM_MALLOC_BATCH_REFILL", "1").lower() not in (
        "0", "false", "off")


@functools.lru_cache(maxsize=None)
def _launch_geometry(heap_bytes: int, block_bytes: int, size_classes: tuple):
    """What a launch needs that depends on the geometry alone: (nb, the
    smallest stack capacity, the class sizes as a ctypes array). The class
    sizes go to the kernel by value (a host array): no per-round
    host-to-device copy, which would synchronise the stream."""
    csizes = (ctypes.c_int * len(size_classes))(*size_classes)
    return heap_bytes // block_bytes, block_bytes // min(size_classes), csizes


def fused_heap_step(op, size, ptr, longest, counts, stacks, block_cls,
                    block_free, big_log2, tags, last_used, clock, *,
                    heap_bytes: int, block_bytes: int, size_classes: tuple,
                    batch_refill: bool | None = None) -> FusedRoundOut:
    """One fused protocol round for C cores (clock is int32[C]).

    **Updates the nine state tensors in place**, on either device: the
    returned state leaves are the same tensors that were passed in, so a
    caller that needs the previous state keeps a clone. (The reference is
    functional; a round touches O(T·depth) tree nodes, and copying ~0.7 MiB
    of state per core per round would move far more bytes than the round
    needs.) For CUDA tensors this calls the operator
    ``torch.ops.repro_torch.heap_step`` (its schema marks the nine state
    tensors as written), whose CUDA implementation launches the
    hand-written kernel (``csrc/heap_step.cu``, one CTA per core); for CPU
    tensors it runs the plain `protocol_round` and copies its state back
    into the inputs. Any other device raises. ``batch_refill`` (None: `batch_refill_default`)
    chooses between the run-carve and the serial walk inside either
    version; both give the same outputs. `fused_heap_step.launches` counts
    kernel launches.
    """
    if batch_refill is None:
        batch_refill = batch_refill_default()
    state = (longest, counts, stacks, block_cls, block_free, big_log2, tags,
             last_used, clock)
    if op.device.type == "cpu":
        out = protocol_round(op, size, ptr, *state, heap_bytes=heap_bytes,
                             block_bytes=block_bytes,
                             size_classes=size_classes,
                             batch_refill=batch_refill)
        for dst, src in zip(state, out[:N_STATE]):
            dst.copy_(src)
        return FusedRoundOut(*state, *out[N_STATE:])
    if op.device.type != "cuda":
        raise ValueError(f"fused_heap_step runs on cuda or cpu, not "
                         f"{op.device}")
    C, T = op.shape
    nb, max_sub, csizes = _launch_geometry(heap_bytes, block_bytes,
                                           tuple(size_classes))
    E = tags.shape[-1]
    if T > 32 or E > 32:
        raise ValueError(f"the kernel maps threads and cache entries onto "
                         f"one warp: T={T}, E={E} must be <= 32")
    _check_leaves(op, dict(zip(FusedRoundOut._fields, state), op=op,
                           size=size, ptr=ptr), T=T, nb=nb, E=E)
    if stacks.shape[-1] < max_sub:
        raise ValueError("stack capacity below one carved block")
    rec = _OP(op, size, ptr, *state, heap_bytes, block_bytes,
              list(size_classes), bool(batch_refill))
    return FusedRoundOut(*state, *rec.unbind(0))


def _launch(op, size, ptr, longest, counts, stacks, block_cls, block_free,
            big_log2, tags, last_used, clock, heap_bytes, block_bytes,
            size_classes, batch_refill):
    """The operator's CUDA implementation: launch the kernel, which updates
    the nine state tensors in place; returns the records int32[22, C,
    T]."""
    from . import _build
    lib = _build.load("heap_step")
    C, T = op.shape
    _, _, csizes = _launch_geometry(heap_bytes, block_bytes,
                                    tuple(size_classes))
    rec = torch.empty((N_RECORDS, C, T), dtype=torch.int32, device=op.device)
    vp = ctypes.c_void_p
    err = lib.heap_step_launch(
        vp(op.data_ptr()), vp(size.data_ptr()), vp(ptr.data_ptr()),
        vp(longest.data_ptr()), vp(counts.data_ptr()), vp(stacks.data_ptr()),
        vp(block_cls.data_ptr()), vp(block_free.data_ptr()),
        vp(big_log2.data_ptr()), vp(tags.data_ptr()),
        vp(last_used.data_ptr()), vp(clock.data_ptr()), csizes,
        vp(rec.data_ptr()), C, T, len(csizes), stacks.shape[-1],
        tags.shape[-1], heap_bytes, block_bytes, int(batch_refill),
        vp(torch.cuda.current_stream(op.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"heap_step kernel launch failed: CUDA error {err}")
    fused_heap_step.launches += 1
    return rec


def _plain(op, size, ptr, *rest):
    """The operator's function in plain PyTorch: the nine new state values,
    then the records stacked as the kernel returns them."""
    state, (heap_bytes, block_bytes, size_classes, batch_refill) = \
        rest[:N_STATE], rest[N_STATE:]
    out = protocol_round(op, size, ptr, *state, heap_bytes=heap_bytes,
                         block_bytes=block_bytes,
                         size_classes=tuple(size_classes),
                         batch_refill=batch_refill)
    return [*out[:N_STATE], torch.stack(out[N_STATE:])]


fused_heap_step.launches = 0
_OP = _library.define(
    "heap_step", "(Tensor op, Tensor size, Tensor ptr, Tensor(a!) longest, "
    "Tensor(b!) counts, Tensor(c!) stacks, Tensor(d!) block_cls, "
    "Tensor(e!) block_free, Tensor(f!) big_log2, Tensor(g!) tags, "
    "Tensor(h!) last_used, Tensor(i!) clock, int heap_bytes, "
    "int block_bytes, int[] size_classes, bool batch_refill) -> Tensor",
    _launch, lambda op, *_: op.new_empty((N_RECORDS,) + tuple(op.shape)),
    _plain)
