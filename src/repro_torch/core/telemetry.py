"""Heap-health snapshots: fragmentation / utilization reporting.

`SystemState.telem` carries the round-by-round counters (live rounded bytes
and their high-water mark). This module derives the snapshot side from the
metadata state itself:

  * total buddy free bytes and the per-level histogram of maximal free
    blocks (external fragmentation),
  * bytes parked in the thread-cache frontend (carved but not handed out),
  * the conservation law both sides satisfy together:

        live_bytes + free_bytes + cached_frontend_bytes == heap_bytes

Host-side NumPy over a state copied off the device: reporting code, not
part of a round. Functions take ``[..., n]`` arrays, so one call covers
all cores of a stacked state.
"""
from __future__ import annotations

import numpy as np

from .buddy import BuddyConfig


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _node_levels(bcfg: BuddyConfig):
    """(level[i], full_size[i]) for the 1-indexed longest[] array."""
    n = bcfg.n_nodes
    idx = np.arange(n)
    level = np.zeros(n, np.int64)
    level[1:] = np.floor(np.log2(idx[1:])).astype(np.int64)
    full = np.where(idx > 0, bcfg.heap_bytes >> level, 0).astype(np.int64)
    return level, full


def free_block_histogram(bcfg: BuddyConfig, longest) -> np.ndarray:
    """Count of *maximal* free blocks per buddy level, ``[..., depth + 1]``.

    Index ``l`` counts free blocks of exactly ``heap_bytes >> l`` bytes not
    contained in a larger free block. The ``longest[]`` encoding leaves the
    descendants of an allocated node stale at their full sizes, so a node
    only counts as free when no ancestor is allocated as a block."""
    longest = np.asarray(_np(longest), np.int64)
    n = bcfg.n_nodes
    level, full = _node_levels(bcfg)
    ar = np.arange(n)
    is_leaf = level == bcfg.depth
    lc = np.minimum(2 * ar, n - 1)
    rc = np.minimum(2 * ar + 1, n - 1)
    stale = (longest[..., lc] == full // 2) & (longest[..., rc] == full // 2)
    is_blk = (ar > 0) & (longest == 0) & (is_leaf | stale)

    # covered[i]: some ancestor of i was allocated as a block
    covered = np.zeros(longest.shape, bool)
    for lvl in range(1, bcfg.depth + 1):
        idx = np.arange(1 << lvl, min(1 << (lvl + 1), n))
        covered[..., idx] = covered[..., idx >> 1] | is_blk[..., idx >> 1]

    truly_free = (ar > 0) & (longest == full) & ~covered
    parent_free = np.zeros(longest.shape, bool)
    parent_free[..., 2:] = truly_free[..., ar[2:] >> 1]
    maximal = truly_free & ~parent_free
    return np.stack([(maximal & (level == lvl)).sum(-1)
                     for lvl in range(bcfg.depth + 1)], -1).astype(np.int64)


def free_bytes_from_histogram(bcfg: BuddyConfig, hist) -> np.ndarray:
    sizes = bcfg.heap_bytes >> np.arange(np.shape(hist)[-1])
    return (np.asarray(hist, np.int64) * sizes).sum(-1)


def frontend_cached_bytes(cfg, state) -> np.ndarray:
    """Bytes parked in the per-thread LIFO freelists, per core."""
    counts = np.asarray(_np(state.alloc.counts), np.int64)
    class_sizes = np.asarray(cfg.pm.size_classes, np.int64)
    return (counts * class_sizes).sum((-2, -1))


def conservation_residuals(cfg, state) -> np.ndarray:
    """``heap - (live + free + cached)`` for every core (0 when sound)."""
    bcfg = cfg.pm.buddy_cfg
    free_b = free_bytes_from_histogram(
        bcfg, free_block_histogram(bcfg, state.alloc.buddy.longest))
    live = np.asarray(_np(state.telem.live_bytes), np.int64)
    return cfg.heap_bytes - (live + free_b + frontend_cached_bytes(cfg, state))


def snapshot(cfg, state, core: int = 0) -> dict:
    """One heap-health report for one core of a (SystemConfig, SystemState).

    Plain Python numbers/lists. Keys: ``live_bytes``, ``hwm_bytes``,
    ``free_bytes``, ``cached_frontend_bytes``, ``heap_bytes``,
    ``utilization``, ``hwm_utilization``, ``largest_free_block``,
    ``external_frag``, ``free_blocks_per_level``, ``conservation_residual``.
    """
    bcfg = cfg.pm.buddy_cfg
    longest = _np(state.alloc.buddy.longest)[core]
    hist = free_block_histogram(bcfg, longest)
    free_b = int(free_bytes_from_histogram(bcfg, hist))
    cached = int(frontend_cached_bytes(cfg, state)[core])
    live = int(_np(state.telem.live_bytes)[core])
    hwm = int(_np(state.telem.hwm_bytes)[core])
    largest = int(longest[1]) if longest.shape[0] > 1 else 0
    heap = int(cfg.heap_bytes)
    return {
        "live_bytes": live,
        "hwm_bytes": hwm,
        "free_bytes": free_b,
        "cached_frontend_bytes": cached,
        "heap_bytes": heap,
        "utilization": live / heap,
        "hwm_utilization": hwm / heap,
        "largest_free_block": largest,
        "external_frag": (1.0 - largest / free_b) if free_b > 0 else 0.0,
        "free_blocks_per_level": hist.tolist(),
        "conservation_residual": heap - (live + free_b + cached),
    }
