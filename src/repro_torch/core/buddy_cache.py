"""Metadata-cache simulators for the buddy allocator's tree traversals.

The port of `repro.core.buddy_cache`. Two designs from the paper, both
consuming the node-index traces the allocator emits (`BuddyEvent.trace` /
`MallocEvent.trace`):

* SW buffer: PIM-malloc-SW's software-managed metadata buffer, a
  direct-mapped line cache. A miss flushes the mapped line and refills it
  around the requested word: one DMA of `line_bytes`.
* Buddy cache: PIM-malloc-HW/SW's 16-entry fully-associative CAM of 4-byte
  metadata words with true LRU replacement. A miss fetches only the
  requested word: one DMA of `WORD_BYTES`.

Metadata addressing follows the paper's 2-bit-per-node packing: 16 tree
nodes per 4-byte word, so ``word = node // 16``.

Every function takes an explicit leading core axis: one access per core
(``node [C]``), states with ``[C, ...]`` leaves, traces ``[C, B, L]``. An
access with ``node < 0`` leaves the state alone, clock included. Tie
rules are the reference's: a hit takes the first matching entry
(``argmax``), a miss evicts the first entry of least ``last_used``
(``argmin``), so empty entries (-1) go first, lowest index first.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import device as _device

NODES_PER_WORD = 16  # 2 bits/node, 4-byte words
WORD_BYTES = 4


@dataclasses.dataclass(frozen=True)
class SWBufferConfig:
    """Software-managed metadata buffer: a direct-mapped line cache (512 B
    of WRAM in 64 B lines by default: 8 lines)."""

    buf_bytes: int = 512
    line_bytes: int = 64

    @property
    def n_lines(self) -> int:
        return self.buf_bytes // self.line_bytes

    @property
    def line_words(self) -> int:
        return self.line_bytes // WORD_BYTES


class SWBufferState(NamedTuple):
    tags: torch.Tensor  # int32[..., n_lines] resident line address, -1 empty


def sw_buffer_init(cfg: SWBufferConfig, device="cuda") -> SWBufferState:
    """An empty buffer on `device` (the card unless the caller asks for the
    CPU; raises without a GPU)."""
    return SWBufferState(tags=torch.full(
        (cfg.n_lines,), -1, dtype=torch.int32,
        device=_device.resolve(device)))


def _set(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``x [C, N]`` with ``x[c, idx[c]] = val[c]`` where
    ``mask[c]``."""
    i = idx.long()[:, None]
    old = x.gather(1, i)[:, 0]
    return x.scatter(1, i, torch.where(mask, val, old)[:, None])


def sw_buffer_access(cfg: SWBufferConfig, st: SWBufferState, node):
    """One metadata access per core. Returns (state, hit bool [C],
    dram_bytes int32 [C])."""
    valid = node >= 0
    word = torch.clamp(node, min=0) // NODES_PER_WORD
    line = word // cfg.line_words
    idx = line % cfg.n_lines
    hit = valid & (st.tags.gather(1, idx.long()[:, None])[:, 0] == line)
    miss = valid & ~hit
    tags = _set(st.tags, idx, line, miss)
    dram = torch.where(miss, cfg.line_bytes, 0).to(torch.int32)
    return SWBufferState(tags=tags), hit, dram


@dataclasses.dataclass(frozen=True)
class BuddyCacheConfig:
    n_entries: int = 16  # 16 x 4 B = 64 B (paper's design point)


class BuddyCacheState(NamedTuple):
    tags: torch.Tensor       # int32[..., E] word addresses, -1 invalid
    last_used: torch.Tensor  # int32[..., E] LRU timestamps (-1 = first victim)
    clock: torch.Tensor      # int32[...] access counter


def buddy_cache_init(cfg: BuddyCacheConfig, device="cuda") -> BuddyCacheState:
    """An empty cache on `device` (the card unless the caller asks for the
    CPU; raises without a GPU)."""
    device = _device.resolve(device)
    e = cfg.n_entries
    return BuddyCacheState(
        tags=torch.full((e,), -1, dtype=torch.int32, device=device),
        last_used=torch.full((e,), -1, dtype=torch.int32, device=device),
        clock=torch.zeros((), dtype=torch.int32, device=device))


def buddy_cache_access(cfg: BuddyCacheConfig, st: BuddyCacheState, node):
    """lookup_bc + (read_bc | evict + write_bc), one access per core.
    Returns (state, hit bool [C], dram_bytes int32 [C])."""
    del cfg
    valid = node >= 0
    word = torch.clamp(node, min=0) // NODES_PER_WORD
    match = st.tags == word[:, None]
    hit = valid & match.any(-1)
    # argmax / argmin return the first extremum, as the reference's do
    idx = torch.where(hit, match.to(torch.int8).argmax(-1),
                      st.last_used.argmin(-1))
    tags = _set(st.tags, idx, word, valid)
    last = _set(st.last_used, idx, st.clock, valid)
    clock = st.clock + valid.to(torch.int32)
    dram = torch.where(valid & ~hit, WORD_BYTES, 0).to(torch.int32)
    return BuddyCacheState(tags=tags, last_used=last, clock=clock), hit, dram


class TraceStats(NamedTuple):
    hits: torch.Tensor        # int32[C, B]: per-op metadata hits
    misses: torch.Tensor      # int32[C, B]
    dram_bytes: torch.Tensor  # int32[C, B]


def simulate_traces(access_fn, cache_state, traces):
    """Run a cache sim over ``[C, B, L]`` node traces (ops in serialization
    order, each core on its own cache).

    access_fn: (state, node [C]) -> (state, hit [C], dram_bytes [C]).
    Returns (final_state, TraceStats with [C, B] per-op aggregates).

    An access with ``node < 0`` changes nothing and counts nothing, so each
    core's valid accesses are moved to the front in order (a stable sort)
    and the sim steps only as often as the core with the most of them;
    a core that has run out accesses -1. The result is exactly the
    reference's scan over every slot."""
    C, B, L = traces.shape
    flat = traces.reshape(C, B * L)
    valid = flat >= 0
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    nodes = torch.where(valid.gather(1, order), flat.gather(1, order), -1)
    steps = int(valid.sum(1, dtype=torch.int32).max()) if flat.numel() else 0
    hits, dram = [], []
    for k in range(steps):
        cache_state, hit, d = access_fn(cache_state, nodes[:, k])
        hits.append(hit)
        dram.append(d)
    z = torch.zeros((C, B), dtype=torch.int32, device=traces.device)
    if not steps:
        return cache_state, TraceStats(z, z.clone(), z.clone())
    op_of = torch.div(order[:, :steps], L, rounding_mode="floor")
    ok = nodes[:, :steps] >= 0
    hit = torch.stack(hits, 1)

    def per_op(v):
        return z.clone().scatter_add_(1, op_of, v.to(torch.int32))

    return cache_state, TraceStats(hits=per_op(ok & hit),
                                   misses=per_op(ok & ~hit),
                                   dram_bytes=per_op(torch.stack(dram, 1)))
