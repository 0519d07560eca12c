"""Plain-Python reference allocators: oracles for property tests.

The port's own copy of `repro.core.oracle` (pure Python, no tensor
library): `PyBuddy`, `PyPimMalloc` and `PyArena` make the same placement
decisions as the allocators (leftmost-descent buddy, LIFO size-class
freelists, the arena's bump regions), so tests can assert exact
pointer-for-pointer equality on random streams, not just invariants.
"""
from __future__ import annotations


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


class PyBuddy:
    """Array-buddy ('longest') reference, identical placement to core.buddy."""

    def __init__(self, heap_bytes: int, min_block: int):
        assert heap_bytes & (heap_bytes - 1) == 0
        assert min_block & (min_block - 1) == 0
        self.heap = heap_bytes
        self.min_block = min_block
        self.n_leaf = heap_bytes // min_block
        self.longest = [0] * (2 * self.n_leaf)
        for i in range(1, 2 * self.n_leaf):
            self.longest[i] = heap_bytes >> (i.bit_length() - 1)

    def _round(self, size: int) -> int:
        return max(_next_pow2(size), self.min_block)

    def alloc(self, size: int) -> int:
        size = self._round(size)
        if size > self.heap or self.longest[1] < size:
            return -1
        node, node_size = 1, self.heap
        while node_size > size:
            left = 2 * node
            node = left if self.longest[left] >= size else left + 1
            node_size >>= 1
        offset = node * node_size - self.heap
        self.longest[node] = 0
        while node > 1:
            node >>= 1
            self.longest[node] = max(self.longest[2 * node], self.longest[2 * node + 1])
        return offset

    def free(self, offset: int, size: int) -> bool:
        size = self._round(size)
        node = (offset + self.heap) // size
        if offset < 0 or offset >= self.heap or self.longest[node] != 0:
            return False
        self.longest[node] = size
        node_size = size
        while node > 1:
            node >>= 1
            node_size <<= 1
            l, r = self.longest[2 * node], self.longest[2 * node + 1]
            if l == node_size >> 1 and r == node_size >> 1:
                self.longest[node] = node_size
            else:
                self.longest[node] = max(l, r)
        return True

    def free_bytes(self) -> int:
        """heap - allocated bytes; see core.buddy.free_bytes for the stale-
        descendant subtlety of the longest[] encoding."""

        def allocated(node: int, size: int) -> int:
            if self.longest[node] == size:
                return 0
            if size == self.min_block:
                return size if self.longest[node] == 0 else 0
            l, r = 2 * node, 2 * node + 1
            if (self.longest[node] == 0 and self.longest[l] == size >> 1
                    and self.longest[r] == size >> 1):
                return size
            return allocated(l, size >> 1) + allocated(r, size >> 1)

        return self.heap - allocated(1, self.heap)


class PyPimMalloc:
    """Reference for core.pim_malloc — identical placement decisions."""

    def __init__(self, heap_bytes=1 << 20, num_threads=4,
                 size_classes=(16, 32, 64, 128, 256, 512, 1024, 2048),
                 block_bytes=4096, cap=1024, prepopulate=True):
        self.cfg = dict(heap=heap_bytes, T=num_threads, classes=list(size_classes),
                        block=block_bytes, cap=cap)
        self.buddy = PyBuddy(heap_bytes, block_bytes)
        self.nc = len(size_classes)
        self.counts = [[0] * self.nc for _ in range(num_threads)]
        self.stacks = [[[] for _ in range(self.nc)] for _ in range(num_threads)]
        self.block_cls = {}
        self.block_free = {}
        self.big_log2 = {}
        self.stats = dict(front_hits=0, front_misses=0, bypass=0, fails=0,
                          frees_small=0, frees_big=0, dropped=0, gc_blocks=0)
        if prepopulate:
            for t in range(num_threads):
                for c in range(self.nc):
                    off = self.buddy.alloc(block_bytes)
                    if off < 0:
                        continue
                    csize = size_classes[c]
                    sub = block_bytes // csize
                    self.stacks[t][c] = [off + i * csize for i in range(sub)]
                    self.counts[t][c] = sub
                    b = off // block_bytes
                    self.block_cls[b] = c
                    self.block_free[b] = sub

    def _class_of(self, size):
        classes = self.cfg["classes"]
        for c, s in enumerate(classes):
            if size <= s:
                return c
        return self.nc - 1

    def malloc(self, sizes, active=None):
        T, block = self.cfg["T"], self.cfg["block"]
        classes = self.cfg["classes"]
        if active is None:
            active = [True] * T
        ptrs = [-1] * T
        paths = [-1] * T
        # phase A: hits
        backend = []
        for t in range(T):
            if not active[t] or sizes[t] <= 0:
                continue
            size = sizes[t]
            if size <= classes[-1]:
                c = self._class_of(size)
                if self.counts[t][c] > 0:
                    ptr = self.stacks[t][c][self.counts[t][c] - 1]
                    self.stacks[t][c].pop()
                    self.counts[t][c] -= 1
                    self.block_free[ptr // block] -= 1
                    ptrs[t] = ptr
                    paths[t] = 0
                    self.stats["front_hits"] += 1
                else:
                    backend.append((t, "refill", c, size))
            else:
                backend.append((t, "bypass", None, size))
        # phase B: serialized in thread order
        for t, kind, c, size in backend:
            if kind == "refill":
                off = self.buddy.alloc(block)
                self.stats["front_misses"] += 1
                if off < 0:
                    self.stats["fails"] += 1
                    paths[t] = 3
                    continue
                csize = classes[c]
                sub = block // csize
                self.stacks[t][c] = [off + i * csize for i in range(sub - 1)]
                self.counts[t][c] = sub - 1
                b = off // block
                self.block_cls[b] = c
                self.block_free[b] = sub - 1
                ptrs[t] = off + (sub - 1) * csize
                paths[t] = 1
            else:
                asize = max(_next_pow2(size), block)
                off = self.buddy.alloc(asize)
                self.stats["bypass"] += 1
                if off < 0:
                    self.stats["fails"] += 1
                    paths[t] = 3
                    continue
                self.big_log2[off // block] = asize.bit_length() - 1
                ptrs[t] = off
                paths[t] = 2
        return ptrs, paths

    def free(self, ptrs, active=None):
        """One batched free round; returns per-thread paths mirroring
        `core.pim_malloc.free`: 0 push / 1 big / 2 dropped / -1 idle (NULL
        frees are benign no-ops)."""
        T, block, cap = self.cfg["T"], self.cfg["block"], self.cfg["cap"]
        if active is None:
            active = [True] * T
        paths = [-1] * T
        for t in range(T):
            ptr = ptrs[t]
            if not active[t] or ptr == -1:   # NULL free: benign no-op
                continue
            if ptr < 0 or ptr >= self.cfg["heap"]:
                self.stats["dropped"] += 1   # garbage pointer
                paths[t] = 2
                continue
            b = ptr // block
            c = self.block_cls.get(b, -1)
            if c >= 0:
                if self.counts[t][c] >= cap:
                    self.stats["dropped"] += 1
                    paths[t] = 2
                    continue
                self.stacks[t][c].append(ptr)
                self.counts[t][c] += 1
                self.block_free[b] = self.block_free.get(b, 0) + 1
                self.stats["frees_small"] += 1
                paths[t] = 0
            elif self.big_log2.get(b, -1) >= 0 and ptr % block == 0:
                self.buddy.free(ptr, 1 << self.big_log2[b])
                del self.big_log2[b]
                self.stats["frees_big"] += 1
                paths[t] = 1
            else:
                self.stats["dropped"] += 1   # untracked / double free
                paths[t] = 2
        return paths

    # ------------------------------------------------------------------
    # full protocol rounds (the differential-fuzzing oracle surface)
    # ------------------------------------------------------------------
    def _realloc_meta(self, ptr: int, size: int):
        """(valid_old, in_place, old_bytes, new_bytes) for one pointer —
        mirrors `core.pim_malloc.realloc_meta`."""
        heap, block = self.cfg["heap"], self.cfg["block"]
        classes = self.cfg["classes"]
        valid = 0 <= ptr < heap
        b = ptr // block if valid else 0
        cls = self.block_cls.get(b, -1) if valid else -1
        small_old = valid and cls >= 0
        big_old = (valid and cls < 0 and self.big_log2.get(b, -1) >= 0
                   and ptr % block == 0)
        old = (classes[cls] if small_old
               else (1 << self.big_log2[b]) if big_old else 0)
        new_small = size <= classes[-1]
        new = (classes[self._class_of(size)] if new_small
               else max(_next_pow2(size), block))
        in_place = (((small_old and new_small) or (big_old and not new_small))
                    and new == old)
        return small_old or big_old, in_place, old, new

    def request(self, op, size, ptr):
        """Serve one mixed-op protocol round (the semantic half of
        `system._protocol_round`): per-thread MALLOC / FREE / REALLOC /
        CALLOC / NOOP with the same two-phase order — batched malloc for
        new blocks (incl. relocating reallocs), then batched free (explicit
        frees, realloc(p, 0), vacated realloc blocks).

        Returns {"ptr", "ok", "path", "moved"} per-thread lists — the
        semantic AllocResponse fields every backend must agree on
        (tests/test_torch_client_surface.py pins the port's hwsw == this
        oracle).
        """
        T = self.cfg["T"]
        OP_MALLOC, OP_FREE, OP_REALLOC, OP_CALLOC = 1, 2, 3, 4
        is_alloc = [o in (OP_MALLOC, OP_CALLOC) for o in op]
        is_re = [o == OP_REALLOC for o in op]
        is_free = [o == OP_FREE for o in op]

        meta = [self._realloc_meta(ptr[t], size[t]) for t in range(T)]
        valid_old = [m[0] for m in meta]
        re_live = [is_re[t] and size[t] > 0 for t in range(T)]
        in_place = [re_live[t] and meta[t][1] for t in range(T)]
        moved = [re_live[t] and not meta[t][1] for t in range(T)]
        re_free0 = [is_re[t] and size[t] <= 0 and ptr[t] >= 0
                    for t in range(T)]

        m_active = [(is_alloc[t] and size[t] > 0) or moved[t]
                    for t in range(T)]
        mptrs, mpaths = self.malloc(
            [size[t] if m_active[t] else 0 for t in range(T)], m_active)
        mok = [m_active[t] and mptrs[t] >= 0 for t in range(T)]

        f_active = [is_free[t] or (moved[t] and valid_old[t] and mok[t])
                    or re_free0[t] for t in range(T)]
        fpaths = self.free(
            [ptr[t] if f_active[t] else -1 for t in range(T)], f_active)

        out_ptr, ok, path, moved_out = [], [], [], []
        for t in range(T):
            if is_alloc[t] and mok[t]:
                p = mptrs[t]
            elif in_place[t]:
                p = ptr[t]
            elif moved[t] and mok[t]:
                p = mptrs[t]
            else:
                p = -1
            out_ptr.append(p)
            ok.append((is_alloc[t] and mok[t]) or in_place[t]
                      or (moved[t] and mok[t])
                      or ((is_free[t] or re_free0[t])
                          and fpaths[t] in (0, 1)))
            if m_active[t]:
                path.append(mpaths[t])
            elif is_free[t] or re_free0[t]:
                path.append(fpaths[t])
            elif in_place[t]:
                path.append(0)
            else:
                path.append(-1)
            moved_out.append(moved[t] and mok[t])
        return {"ptr": out_ptr, "ok": ok, "path": path, "moved": moved_out}

    def gc(self, max_gc=8):
        block = self.cfg["block"]
        classes = self.cfg["classes"]
        full = sorted(
            b for b, c in self.block_cls.items()
            if c >= 0 and self.block_free.get(b, 0) == block // classes[c]
        )
        for b in full[:max_gc]:
            c = self.block_cls[b]
            for t in range(self.cfg["T"]):
                row = self.stacks[t][c]
                kept = [p for p in row if p // block != b]
                self.stacks[t][c] = kept
                self.counts[t][c] = len(kept)
            self.buddy.free(b * block, block)
            del self.block_cls[b]
            del self.block_free[b]
            self.stats["gc_blocks"] += 1


class PyArena:
    """Reference for core.arena — the layered bump frontend over the backend.

    Mirrors `arena.step` phase for phase (reset at round start, ownership
    classification against the post-reset map, bump allocation in thread
    order, forwarded backend round, merge), wrapping a `PyPimMalloc` the way
    the arena kinds wrap hwsw. ``tlregion=True`` gives each thread a private
    region (the ``tlregion`` design point); otherwise one shared bump.
    tests/test_torch_arena.py pins the port's arena/tlregion == this
    oracle pointer-for-pointer on the semantic response fields.
    """

    GRANULE = 16
    OP_RESET = 5

    def __init__(self, heap_bytes=1 << 20, num_threads=4,
                 size_classes=(16, 32, 64, 128, 256, 512, 1024, 2048),
                 block_bytes=4096, cap=1024, tlregion=False):
        self.inner = PyPimMalloc(
            heap_bytes=heap_bytes, num_threads=num_threads,
            size_classes=size_classes, block_bytes=block_bytes, cap=cap,
            prepopulate=False)
        self.ab = heap_bytes // 2
        assert self.ab % block_bytes == 0
        off = self.inner.buddy.alloc(self.ab)
        assert off == 0, "pristine leftmost-descent carve must land at 0"
        self.T = num_threads
        self.tl = tlregion
        self.n_gran = self.ab // self.GRANULE
        if tlregion:
            assert self.n_gran % num_threads == 0
            self.region_gran = self.n_gran // num_threads
        else:
            self.region_gran = self.n_gran
        self.cls_map = {}              # start granule -> size-class index
        self.bump = [0] * (num_threads if tlregion else 1)
        self.epoch = 0

    def request(self, op, size, ptr):
        """One layered protocol round; returns {"ptr","ok","path","moved"}."""
        T = self.T
        classes = self.inner.cfg["classes"]
        max_class = classes[-1]
        OP_MALLOC, OP_FREE, OP_REALLOC, OP_CALLOC = 1, 2, 3, 4
        is_reset = [op[t] == self.OP_RESET for t in range(T)]

        # phase 0: epoch reset at round start (tl: own region; shared: all)
        if self.tl:
            for t in range(T):
                if is_reset[t]:
                    lo = t * self.region_gran
                    hi = lo + self.region_gran
                    for g in [g for g in self.cls_map if lo <= g < hi]:
                        del self.cls_map[g]
                    self.bump[t] = 0
        elif any(is_reset):
            self.cls_map.clear()
            self.bump[0] = 0
        self.epoch += int(any(is_reset))

        # ownership classification against the post-reset, pre-bump map
        plan = []
        for t in range(T):
            o, z, p = op[t], size[t], ptr[t]
            in_arena = 0 <= p < self.ab and p % self.GRANULE == 0
            g_old = p // self.GRANULE if in_arena else -1
            owned = in_arena and g_old in self.cls_map
            old_cls = self.cls_map[g_old] if owned else -1
            small = 0 < z <= max_class
            cls = self.inner._class_of(z) if small else -1
            is_alloc = o in (OP_MALLOC, OP_CALLOC)
            is_re = o == OP_REALLOC
            re_free0 = is_re and z <= 0 and p >= 0
            arena_free = (o == OP_FREE or re_free0) and owned
            re_arena = is_re and z > 0 and owned
            re_inplace = re_arena and small and cls == old_cls
            re_move = re_arena and not (small and cls == old_cls)
            plan.append(dict(
                g_old=g_old, cls=cls, small=small, arena_free=arena_free,
                re_inplace=re_inplace, re_move=re_move,
                plain_small=is_alloc and small, reset=is_reset[t]))

        # phase 1: bump allocation (shared arena serializes in thread order;
        # a failed fit does NOT consume space)
        for t, pl in enumerate(plan):
            cand = pl["plain_small"] or (pl["re_move"] and pl["small"])
            pl["g_new"], pl["served"] = -1, False
            if not cand:
                continue
            gneed = classes[pl["cls"]] // self.GRANULE
            slot = t if self.tl else 0
            limit = self.region_gran
            if self.bump[slot] + gneed <= limit:
                base = t * self.region_gran if self.tl else 0
                pl["g_new"] = base + self.bump[slot]
                pl["served"] = True
                self.bump[slot] += gneed
            pl["re_move_bump"] = pl["re_move"] and pl["small"] and pl["served"]
        for pl in plan:
            pl.setdefault("re_move_bump", False)
            pl["arena_alloc"] = pl["plain_small"] and pl["served"]
            pl["move_to_inner"] = pl["re_move"] and not pl["re_move_bump"]
            pl["consumed"] = (pl["arena_alloc"] or pl["arena_free"]
                              or pl["re_inplace"] or pl["re_move_bump"]
                              or pl["reset"])

        # phase 2: forwarded backend round
        in_op = [OP_MALLOC if pl["move_to_inner"]
                 else 0 if pl["consumed"] else op[t]
                 for t, pl in enumerate(plan)]
        in_size = [size[t] if pl["move_to_inner"]
                   else 0 if pl["consumed"] else size[t]
                   for t, pl in enumerate(plan)]
        in_ptr = [-1 if pl["consumed"] or pl["move_to_inner"] else ptr[t]
                  for t, pl in enumerate(plan)]
        r = self.inner.request(in_op, in_size, in_ptr)

        # phase 3: merge
        out = {"ptr": [], "ok": [], "path": [], "moved": []}
        for t, pl in enumerate(plan):
            move_ok = pl["re_move_bump"] or (pl["move_to_inner"]
                                             and r["ok"][t])
            if pl["arena_alloc"] or pl["re_move_bump"]:
                self.cls_map[pl["g_new"]] = pl["cls"]
            if pl["arena_free"] or move_ok:
                self.cls_map.pop(pl["g_old"], None)
            fwd = not pl["consumed"]       # passthrough or move_to_inner
            arena_ok = pl["consumed"]      # == the arena-served cases
            if pl["arena_alloc"] or pl["re_move_bump"]:
                p_out = pl["g_new"] * self.GRANULE
            elif pl["re_inplace"]:
                p_out = ptr[t]
            elif fwd:
                p_out = r["ptr"][t]
            else:
                p_out = -1
            out["ptr"].append(p_out)
            out["ok"].append(r["ok"][t] if fwd else arena_ok)
            out["path"].append(0 if arena_ok
                               else (r["path"][t] if fwd else -1))
            out["moved"].append(pl["re_move_bump"]
                                or (pl["move_to_inner"] and r["ok"][t])
                                or (not pl["consumed"]
                                    and not pl["move_to_inner"]
                                    and r["moved"][t]))
        return out
