"""Heap-health snapshots: fragmentation / utilization reporting.

`SystemState.telem` carries the round-by-round counters (live rounded bytes
and their high-water mark). This module derives the snapshot side from the
metadata state itself:

  * total buddy free bytes and the per-level histogram of maximal free
    blocks (external fragmentation),
  * bytes parked in the frontend (carved but not handed out: the thread
    caches, 0 for ``strawman``, which has none, and the arena kinds'
    unplaced region bytes),
  * the conservation law both sides satisfy together:

        live_bytes + free_bytes + cached_frontend_bytes == heap_bytes

`fleet_pressure` and `hwm_divergence` read a fleet's ``[R, C]``
telemetry. Reporting code, not part of a round. The tree walk runs in PyTorch on the
state's own device, a few cores at a time (a straw-man tree of a 32 MiB
heap has 2^21 nodes per core), and the results come back as NumPy; one
call covers all cores of a stacked state.
"""
from __future__ import annotations

import numpy as np
import torch

from .buddy import BuddyConfig

# nodes walked at once (cores x tree nodes): bounds the walk's memory
CHUNK_NODES = 1 << 25


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _buddy_cfg(cfg) -> BuddyConfig:
    """The tree geometry of a `SystemConfig`'s kind."""
    return cfg.straw.buddy_cfg if cfg.kind == "strawman" else \
        cfg.pm.buddy_cfg


def _histogram(bcfg: BuddyConfig, longest: torch.Tensor) -> torch.Tensor:
    """Maximal free blocks per level of ``longest [K, n]``: int64 [K,
    depth + 1]."""
    n, depth = bcfg.n_nodes, bcfg.depth
    dev = longest.device
    levels = torch.arange(depth + 1, device=dev)
    level = torch.cat([levels[:1], levels.repeat_interleave(1 << levels)])
    full = (bcfg.heap_bytes >> level).to(torch.int32)
    ar = torch.arange(n, device=dev)
    lc = torch.clamp(2 * ar, max=n - 1)
    rc = torch.clamp(2 * ar + 1, max=n - 1)
    half = full // 2
    stale = (longest[:, lc] == half) & (longest[:, rc] == half)
    is_blk = (ar > 0) & (longest == 0) & ((level == depth) | stale)
    del stale
    # covered[i]: some ancestor of i was allocated as a block, so the
    # descendants it left stale at their full sizes are not free
    covered = torch.zeros_like(is_blk)
    for lvl in range(1, depth + 1):
        lo, hi = 1 << lvl, min(1 << (lvl + 1), n)
        up = covered[:, lo >> 1:hi >> 1] | is_blk[:, lo >> 1:hi >> 1]
        covered[:, lo:hi] = up.repeat_interleave(2, dim=1)[:, :hi - lo]
    truly_free = (ar > 0) & (longest == full) & ~covered
    del covered, is_blk
    maximal = truly_free.clone()
    maximal[:, 2:] &= ~truly_free[:, 1:n // 2].repeat_interleave(2, dim=1)
    return torch.stack([maximal[:, 1 << lvl:min(1 << (lvl + 1), n)].sum(-1)
                        for lvl in range(depth + 1)], -1)


def free_block_histogram(bcfg: BuddyConfig, longest) -> np.ndarray:
    """Count of *maximal* free blocks per buddy level, ``[..., depth + 1]``.

    Index ``l`` counts free blocks of exactly ``heap_bytes >> l`` bytes not
    contained in a larger free block. The ``longest[]`` encoding leaves the
    descendants of an allocated node stale at their full sizes, so a node
    only counts as free when no ancestor is allocated as a block."""
    t = torch.as_tensor(longest).to(torch.int32)
    lead = t.shape[:-1]
    t = t.reshape(-1, t.shape[-1])
    step = max(1, CHUNK_NODES // bcfg.n_nodes)
    out = torch.cat([_histogram(bcfg, t[i:i + step])
                     for i in range(0, t.shape[0], step)])
    return out.cpu().numpy().reshape(lead + (bcfg.depth + 1,))


def free_bytes_from_histogram(bcfg: BuddyConfig, hist) -> np.ndarray:
    sizes = bcfg.heap_bytes >> np.arange(np.shape(hist)[-1])
    return (np.asarray(hist, np.int64) * sizes).sum(-1)


def frontend_cached_bytes(cfg, state) -> np.ndarray:
    """Bytes parked in the frontend, per core: free sub-blocks in the
    per-thread LIFO freelists (0 for ``strawman``), plus, for the
    ``arena`` / ``tlregion`` kinds, every arena byte not placed (unbumped
    space and retired holes: neither live nor buddy-free, so the frontend
    owns them until the next epoch reset). The arena's placements are
    summed on the map's device; only per-core totals come back."""
    if cfg.kind == "strawman":
        return np.zeros(np.shape(_np(state.telem.live_bytes)), np.int64)
    counts = np.asarray(_np(state.alloc.counts), np.int64)
    class_sizes = np.asarray(cfg.pm.size_classes, np.int64)
    cached = (counts * class_sizes).sum((-2, -1))
    if cfg.kind in ("arena", "tlregion"):
        from . import arena
        cached = cached + arena.arena_bytes(cfg) - _np(
            arena.arena_live_bytes(cfg, state.cls_map)).astype(np.int64)
    return cached


def fleet_pressure(state) -> dict:
    """Per-rank heap-pressure signal from a fleet state's telemetry.

    ``state.telem`` carries per-core live / high-water counters with
    leading ``[R, C]`` axes. Returns host arrays: ``live`` / ``hwm`` as
    ``[R, C]`` int64 plus the per-rank maxima (the hottest core of a rank
    stalls its whole round barrier)."""
    live = np.asarray(_np(state.telem.live_bytes), np.int64)
    hwm = np.asarray(_np(state.telem.hwm_bytes), np.int64)
    if live.ndim != 2:
        raise ValueError(f"fleet_pressure wants [R, C] telemetry, "
                         f"got shape {live.shape}")
    return {
        "live": live,
        "hwm": hwm,
        "rank_live": live.max(axis=1),
        "rank_hwm": hwm.max(axis=1),
    }


def hwm_divergence(rank_hwm, ratio: float = 2.0, min_bytes: int = 1) -> dict:
    """Whether per-rank high-water marks have diverged.

    ``trigger`` is True when the hottest rank's HWM exceeds ``ratio`` times
    ``max(coldest, min_bytes)`` and is at least ``min_bytes`` (a floor, so
    an idle fleet whose coldest rank sits at 0 triggers nothing). Host
    code over any array-like."""
    h = np.asarray(_np(rank_hwm), np.int64).reshape(-1)
    if h.shape[0] == 0:
        raise ValueError("empty rank_hwm")
    hot = int(np.argmax(h))
    cold = int(np.argmin(h))
    floor = max(int(h[cold]), int(min_bytes))
    return {
        "hottest_rank": hot,
        "coldest_rank": cold,
        "hottest_hwm": int(h[hot]),
        "coldest_hwm": int(h[cold]),
        "ratio": float(h[hot]) / float(floor),
        "trigger": bool(h[hot] >= int(min_bytes)
                        and float(h[hot]) > ratio * floor),
    }


def conservation_residuals(cfg, state) -> np.ndarray:
    """``heap - (live + free + cached)`` for every core (0 when sound)."""
    bcfg = _buddy_cfg(cfg)
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
    bcfg = _buddy_cfg(cfg)
    longest = state.alloc.buddy.longest[core]
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
