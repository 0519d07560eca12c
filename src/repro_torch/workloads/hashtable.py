"""Open-addressing hash-table / KV-store workload with grow-rehash
`realloc` pressure: the third representative PIM workload.

The port of `repro.workloads.hashtable`. One independent table per
hardware thread (the paper's tasklet model: T concurrent data structures on
one core's heap). Each table is a linear-probing open-addressing array of
(key -> value-cell pointer) entries whose backing store is a heap block:

  * table arrays start with `pimCalloc(capacity, ENTRY_BYTES)`,
  * every insert `pimMalloc`s a small value cell (mixed size classes),
  * crossing the load factor triggers `pimRealloc(table, 2x)`: a
    grow-rehash that walks the size classes up into buddy bypass range,
  * deletes `pimFree` the value cell and tombstone the slot.

The entries live in host-side mirrors keyed by the allocator pointers;
`lookup()` probes like the insert path, and `verify()` checks that every
surviving key resolves to its own live value cell. Each round reads its
response on the host once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import heap

ENTRY_BYTES = 8           # one slot: key (4B) + value ptr (4B)
VALUE_SIZES = (16, 24, 48, 96)  # value-cell payloads (mixed size classes)


@dataclasses.dataclass(frozen=True)
class HashTableConfig:
    num_threads: int = 16
    heap_bytes: int = 1 << 20
    init_capacity: int = 8        # entries; 8 * 8 B = one 64 B class
    max_load: float = 0.7         # grow-rehash threshold
    n_inserts: int = 64           # per thread
    delete_every: int = 5         # delete one live key every k-th insert
    seed: int = 0


class _Table:
    """Host-side mirror of one thread's open-addressing table."""

    def __init__(self, capacity: int):
        self.ptr = -1                  # heap pointer of the backing array
        self.capacity = capacity
        self.keys = np.zeros(capacity, np.int64)      # 0 = empty
        self.vptr = np.full(capacity, -1, np.int64)
        self.live = 0

    def _probe(self, key: int) -> int:
        i = (key * 2654435761) % self.capacity
        for _ in range(self.capacity):
            if self.keys[i] == 0 or self.keys[i] == key:
                return i
            i = (i + 1) % self.capacity
        return -1

    def insert(self, key: int, vptr: int) -> bool:
        i = self._probe(key)
        if i < 0:
            return False
        self.keys[i] = key
        self.vptr[i] = vptr
        self.live = int((self.keys != 0).sum())
        return True

    def lookup(self, key: int) -> int:
        i = self._probe(key)
        return int(self.vptr[i]) if i >= 0 and self.keys[i] == key else -1

    def delete(self, key: int) -> int:
        i = self._probe(key)
        if i < 0 or self.keys[i] != key:
            return -1
        vp = int(self.vptr[i])
        # a full rehash of the cluster keeps linear probing correct
        kept = [(int(k), int(v)) for k, v in zip(self.keys, self.vptr)
                if k != 0 and k != key]
        self.keys[:] = 0
        self.vptr[:] = -1
        for k, v in kept:
            self.keys[self._probe(k)] = k
            self.vptr[self._probe(k)] = v
        self.live = len(kept)
        return vp

    def rehash_into(self, new_capacity: int, new_ptr: int) -> None:
        kept = [(int(k), int(v)) for k, v in zip(self.keys, self.vptr)
                if k != 0]
        self.capacity = new_capacity
        self.ptr = new_ptr
        self.keys = np.zeros(new_capacity, np.int64)
        self.vptr = np.full(new_capacity, -1, np.int64)
        for k, v in kept:
            self.insert(k, v)


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


class HashTableWorkload:
    """Drive T per-thread tables through one `HeapClient`-style handle
    (``cfg`` and ``request``); its device is the handle's."""

    def __init__(self, cfg: HashTableConfig, alloc):
        if alloc.cfg.num_threads != cfg.num_threads:
            raise ValueError(f"handle has {alloc.cfg.num_threads} threads, "
                             f"the workload {cfg.num_threads}")
        self.cfg = cfg
        self.alloc = alloc
        self.tables = [_Table(cfg.init_capacity)
                       for _ in range(cfg.num_threads)]
        self.rng = np.random.default_rng(cfg.seed)
        self.grow_rounds = 0

    def _request(self, req) -> np.ndarray:
        """Serve one round; returns its pointers on the host."""
        return self.alloc.request(req).ptr.cpu().numpy()

    def init_tables(self):
        T = self.cfg.num_threads
        ptr = self._request(heap.calloc_request(
            _i32(np.full(T, self.cfg.init_capacity)),
            _i32(np.full(T, ENTRY_BYTES))))
        for t, tab in enumerate(self.tables):
            if ptr[t] < 0:
                raise RuntimeError(f"table calloc failed on thread {t}")
            tab.ptr = int(ptr[t])

    def _maybe_grow(self):
        """One realloc round growing every table past the load factor."""
        need = [tab.live / tab.capacity > self.cfg.max_load
                for tab in self.tables]
        if not any(need):
            return
        new_caps = [tab.capacity * 2 if n else 0
                    for tab, n in zip(self.tables, need)]
        ptr = self._request(heap.realloc_request(
            _i32([tab.ptr if n else -1 for tab, n in zip(self.tables, need)]),
            _i32([c * ENTRY_BYTES for c in new_caps]),
            active=torch.tensor(need)))
        self.grow_rounds += 1
        for t, (tab, n) in enumerate(zip(self.tables, need)):
            if n and ptr[t] >= 0:
                tab.rehash_into(new_caps[t], int(ptr[t]))

    def run(self) -> dict:
        """The recorded op stream; returns workload stats."""
        cfg = self.cfg
        T = cfg.num_threads
        self.init_tables()
        next_key = np.ones(T, np.int64)
        for step in range(cfg.n_inserts):
            # one value cell per thread, mixed classes
            vsizes = self.rng.choice(VALUE_SIZES, size=T)
            ptr = self._request(heap.malloc_request(_i32(vsizes)))
            for t, tab in enumerate(self.tables):
                if ptr[t] >= 0:
                    tab.insert(int(next_key[t]), int(ptr[t]))
                    next_key[t] += 1
            self._maybe_grow()
            if cfg.delete_every and (step + 1) % cfg.delete_every == 0:
                drops = np.full(T, -1, np.int64)
                for t, tab in enumerate(self.tables):
                    livek = tab.keys[tab.keys != 0]
                    if livek.size:
                        drops[t] = tab.delete(int(self.rng.choice(livek)))
                self._request(heap.free_request(_i32(drops)))
        return {
            "tables": T,
            "live_keys": int(sum(t.live for t in self.tables)),
            "capacities": [t.capacity for t in self.tables],
            "grow_rounds": self.grow_rounds,
        }

    def verify(self) -> None:
        """Every surviving key resolves to a distinct live value cell, and
        the table arrays are distinct live blocks; raises AssertionError
        otherwise."""
        seen = set()
        for tab in self.tables:
            for k, v in zip(tab.keys, tab.vptr):
                if k == 0:
                    continue
                if v < 0 or tab.lookup(int(k)) != int(v):
                    raise AssertionError(f"key {int(k)} does not resolve "
                                         f"to its value cell {int(v)}")
                if int(v) in seen:
                    raise AssertionError(f"value cell {int(v)} is shared")
                seen.add(int(v))
        ptrs = [t.ptr for t in self.tables]
        if not all(p >= 0 for p in ptrs) or len(set(ptrs)) != len(ptrs):
            raise AssertionError(f"table arrays not distinct live blocks: "
                                 f"{ptrs}")
