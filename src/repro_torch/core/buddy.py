"""Array buddy allocator (the backend).

Same ``longest[]`` encoding as `repro.core.buddy`: ``longest[i]`` is the size
in bytes of the largest free block under tree node ``i`` (1-indexed, root =
1, slot 0 unused). alloc / free are O(depth) walks with fixed trip counts
and emit a fixed-length `BuddyEvent` trace of the nodes they touched, as in
the reference. Where the reference `vmap`s over PIM cores, every function
here takes an explicit leading core axis: trees ``[C, n_nodes]``, one
request per core ``[C]`` (alloc / free) or a batch ``[C, B]``
(alloc_batch / free_batch), served in order within each core.

The int32 semantics are the reference's: `next_pow2` wraps to INT32_MIN
above 2^30 (so such a size rounds to ``min_block``), and a size <= 0 rounds
to ``min_block`` too (alloc has no ``size > 0`` check). Gathers at an index
outside the tree read the clamped node and writes there are dropped, as
JAX's indexing does. The fused round's batched walks live in
`repro_torch.kernels.heap_step`; `alloc_host` is the serial host-side walk
that `pim_malloc.init` carves its prepopulated blocks with.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device

INVALID = -1


def next_pow2(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x, by int32 bit-smear.

    Inputs above 2^30 wrap to INT32_MIN, exactly as the reference does
    (the REALLOC-of-INT32_MAX request reaches this)."""
    x = torch.clamp(x.to(torch.int32), min=1) - 1
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return x + 1


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """log2 of a power-of-two int32, as ``popcount(x - 1)``.

    torch has no popcount, so the 32 bits are summed; INT32_MIN gives 31,
    as in the reference."""
    v = x.to(torch.int32) - 1
    shifts = torch.arange(32, dtype=torch.int32, device=v.device)
    return ((v.unsqueeze(-1) >> shifts) & 1).sum(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class BuddyConfig:
    """Static heap geometry. depth = log2(heap/min_block) levels below root."""

    heap_bytes: int
    min_block: int

    def __post_init__(self):
        if self.heap_bytes & (self.heap_bytes - 1):
            raise ValueError("heap must be pow2")
        if self.min_block & (self.min_block - 1):
            raise ValueError("min_block must be pow2")
        if self.heap_bytes < self.min_block:
            raise ValueError("heap smaller than min_block")

    @property
    def depth(self) -> int:
        return (self.heap_bytes // self.min_block).bit_length() - 1

    @property
    def n_leaf(self) -> int:
        return self.heap_bytes // self.min_block

    @property
    def n_nodes(self) -> int:  # 1-indexed array size (slot 0 unused)
        return 2 * self.n_leaf

    @property
    def trace_len(self) -> int:
        # descent records root + one node per level; up-walk one per level
        return 2 * (self.depth + 1)

    @property
    def metadata_bytes(self) -> int:
        """Paper metadata footprint: 2 bits per tree node."""
        return (2 * self.n_nodes + 7) // 8


class BuddyState(NamedTuple):
    longest: torch.Tensor  # int32[..., n_nodes]


class BuddyEvent(NamedTuple):
    """Per-op record (the reference's), with the leading axes of the op."""

    ok: torch.Tensor           # bool: the op succeeded
    levels_down: torch.Tensor  # int32: descent length (nodes visited - 1)
    levels_up: torch.Tensor    # int32: ancestor updates
    trace: torch.Tensor        # int32[..., trace_len] node indices, -1 padded


def init(cfg: BuddyConfig, device="cuda") -> BuddyState:
    """The all-free tree on `device` (the card unless the caller asks for
    the CPU; raises without a GPU)."""
    dev = _device.resolve(device)
    idx = np.arange(cfg.n_nodes)
    level = np.zeros(cfg.n_nodes, np.int64)
    level[1:] = np.floor(np.log2(idx[1:])).astype(np.int64)
    longest = np.where(idx > 0, cfg.heap_bytes >> level, 0).astype(np.int32)
    return BuddyState(longest=torch.from_numpy(longest).to(dev))


def alloc_host(cfg: BuddyConfig, st: BuddyState, size: int):
    """Serial leftmost-fit allocation of `size` bytes on a host tree.

    Returns (state, offset); offset is -1 on failure. Host-side set-up code
    (the prepopulate carve): `st.longest` must be a 1-D CPU tensor."""
    size = max(int(next_pow2(torch.tensor([size]))[0]), cfg.min_block)
    longest = st.longest.clone()
    lg = longest.numpy()
    if size > cfg.heap_bytes or lg[1] < size:
        return BuddyState(longest=longest), INVALID
    node, node_size = 1, cfg.heap_bytes
    while node_size > size:
        node = 2 * node if lg[2 * node] >= size else 2 * node + 1
        node_size >>= 1
    offset = node * node_size - cfg.heap_bytes
    lg[node] = 0
    while node > 1:
        node >>= 1
        lg[node] = max(lg[2 * node], lg[2 * node + 1])
    return BuddyState(longest=longest), offset


# ---------------------------------------------------------------------------
# the reference's alloc / free / batches / free_bytes, over a core axis
# ---------------------------------------------------------------------------
def _round_size(cfg: BuddyConfig, size: torch.Tensor) -> torch.Tensor:
    return torch.clamp(next_pow2(size), min=cfg.min_block)


def _take(longest: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """longest[c, node[c]] with JAX's index rule for reads: a negative
    index counts from the end, then the index is clamped into the tree."""
    n = longest.shape[1]
    i = torch.where(node < 0, node + n, node).clamp(0, n - 1)
    return longest.gather(1, i.long()[:, None])[:, 0]


def _put(longest: torch.Tensor, node: torch.Tensor, val: torch.Tensor,
         mask: torch.Tensor) -> None:
    """longest[c, node[c]] = val[c] where mask[c], in place, on any
    ``[C, N]`` table; the callers only mask in indices that lie inside
    it."""
    i = torch.where(mask, node, torch.zeros_like(node)).long()[:, None]
    longest.scatter_(1, i, torch.where(mask, val, longest.gather(1, i)[:, 0])
                     [:, None])


def _get(longest: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """longest[c, i[c]] for int64 indices known to lie inside the tree."""
    return longest.gather(1, i[:, None])[:, 0]


def _set(longest: torch.Tensor, i: torch.Tensor, val: torch.Tensor,
         mask: torch.Tensor) -> None:
    """longest[c, i[c]] = val[c] where mask[c], in place, for int64
    indices known to lie inside the tree."""
    longest.scatter_(1, i[:, None],
                     torch.where(mask, val, _get(longest, i))[:, None])


def _walk_up_(longest: torch.Tensor, node: torch.Tensor, active0,
              depth: int, trace: list, coalesce_from=None):
    """The up-walk from `node` (in the tree) on ``longest [C, n_nodes]``,
    in place, while `active0`: each parent takes the larger of its
    children's longest, or, with `coalesce_from` (the freed block's size),
    their sum where both children are wholly free. Appends each step's
    node (or -1) to `trace`; returns the levels walked [C]."""
    minus1 = torch.full_like(node, INVALID)
    n, lvu = node, torch.zeros_like(node)
    nsize = coalesce_from
    for _ in range(depth):
        parent = n >> 1
        active = active0 & (parent >= 1)
        p = torch.clamp(parent, min=1)
        pl = p.long()
        lft, rgt = _get(longest, 2 * pl), _get(longest, 2 * pl + 1)
        newval = torch.maximum(lft, rgt)
        if nsize is not None:
            psize = nsize << 1
            newval = torch.where((lft == nsize) & (rgt == nsize), psize,
                                 newval)
            nsize = psize
        _set(longest, pl, newval, active)
        trace.append(torch.where(active, p, minus1))
        lvu += active
        n = torch.where(active, p, 0)
    return lvu


def _alloc_(cfg: BuddyConfig, longest: torch.Tensor, size: torch.Tensor,
            live=None):
    """One leftmost-fit allocation per core on ``longest [C, n_nodes]``,
    updated in place; `live` (bool [C], default all) additionally gates
    the request. Returns (offset [C], BuddyEvent).

    Every node the walk reads lies inside the tree, except a leaf's left
    child, read while the walk no longer descends, which is clamped (and
    unused), as JAX clamps it."""
    n_nodes = longest.shape[1]
    size = _round_size(cfg, size)
    ok = (size <= cfg.heap_bytes) & (longest[:, 1] >= size)
    if live is not None:
        ok = ok & live
    one = torch.ones_like(size)
    node, node_size = one.clone(), torch.full_like(size, cfg.heap_bytes)
    trace = [one]  # root visit
    lvd = torch.zeros_like(size)
    for _ in range(cfg.depth):
        descend = node_size > size
        left = 2 * node
        go_left = _get(longest, torch.clamp(left, max=n_nodes - 1).long()) \
            >= size
        node = torch.where(descend, left + ~go_left, node)
        trace.append(torch.where(descend, node, -one))
        node_size = torch.where(descend, node_size >> 1, node_size)
        lvd += descend
    offset = node * node_size - cfg.heap_bytes
    _set(longest, node.long(), torch.zeros_like(node), ok)
    lvu = _walk_up_(longest, node, ok, cfg.depth, trace)
    trace.append(-one)  # the trace's last slot is never written
    ev = BuddyEvent(ok=ok, levels_down=lvd, levels_up=lvu,
                    trace=torch.stack(trace, dim=-1))
    return torch.where(ok, offset, -one), ev


def _free_(cfg: BuddyConfig, longest: torch.Tensor, offset: torch.Tensor,
           size: torch.Tensor, live=None) -> BuddyEvent:
    """Free one block per core on ``longest [C, n_nodes]``, in place;
    `live` (bool [C], default all) additionally gates the request, as the
    reference commits a backend free only for a thread that used the
    backend. The freed node is read with JAX's index rule (a garbage
    offset may name any index); the up-walk stays inside the tree."""
    size = _round_size(cfg, size)
    node = torch.div(offset + cfg.heap_bytes, size, rounding_mode="floor")
    valid = (offset >= 0) & (offset < cfg.heap_bytes) & \
        (_take(longest, node) == 0)
    if live is not None:
        valid = valid & live
    _put(longest, node, size, valid)
    trace = [node]
    # an invalid free walks no level: start it inside the tree
    lvu = _walk_up_(longest, torch.where(valid, node, 1), valid, cfg.depth,
                    trace, coalesce_from=size)
    trace += [torch.full_like(node, INVALID)] * (cfg.trace_len - len(trace))
    return BuddyEvent(ok=valid, levels_down=torch.zeros_like(size),
                      levels_up=lvu, trace=torch.stack(trace, dim=-1))


def alloc(cfg: BuddyConfig, st: BuddyState, size: torch.Tensor):
    """Allocate ``size [C]`` bytes on each core's tree ``[C, n_nodes]``.

    Returns (state, offset [C], BuddyEvent); offset is -1 on failure. The
    input state is left as it was."""
    longest = st.longest.clone()
    off, ev = _alloc_(cfg, longest, size.to(torch.int32))
    return BuddyState(longest=longest), off, ev


def free(cfg: BuddyConfig, st: BuddyState, offset: torch.Tensor,
         size: torch.Tensor):
    """Free the block at ``offset [C]`` allocated with request ``size [C]``.

    An offset outside [0, heap) or a node that is not allocated changes
    nothing (the event's ``ok`` is False). Returns (state, BuddyEvent)."""
    longest = st.longest.clone()
    ev = _free_(cfg, longest, offset.to(torch.int32), size.to(torch.int32))
    return BuddyState(longest=longest), ev


def _stack_events(evs) -> BuddyEvent:
    return BuddyEvent(*(torch.stack(f, dim=1) for f in zip(*evs)))


def alloc_batch(cfg: BuddyConfig, st: BuddyState, sizes: torch.Tensor):
    """Serve ``sizes [C, B]`` in order on each core (the shared-mutex
    backend). Returns (state, offsets [C, B], BuddyEvent with [C, B]
    fields)."""
    longest = st.longest.clone()
    sizes = sizes.to(torch.int32)
    offs, evs = [], []
    for b in range(sizes.shape[1]):
        off, ev = _alloc_(cfg, longest, sizes[:, b])
        offs.append(off)
        evs.append(ev)
    return BuddyState(longest=longest), torch.stack(offs, 1), \
        _stack_events(evs)


def free_batch(cfg: BuddyConfig, st: BuddyState, offsets: torch.Tensor,
               sizes: torch.Tensor):
    """Free ``offsets [C, B]`` (requests ``sizes [C, B]``) in order on each
    core. Returns (state, BuddyEvent with [C, B] fields)."""
    longest = st.longest.clone()
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    evs = [_free_(cfg, longest, offsets[:, b], sizes[:, b])
           for b in range(sizes.shape[1])]
    return BuddyState(longest=longest), _stack_events(evs)


def free_bytes(cfg: BuddyConfig, st: BuddyState) -> torch.Tensor:
    """Free bytes of each core's heap (int32 [C]) = heap - allocated bytes.

    A node X was allocated as a block iff longest[X] == 0 and X is a leaf
    or both its children still read stale-full (see the reference)."""
    longest = st.longest
    n = cfg.n_nodes
    dev = longest.device
    idx = torch.arange(n, device=dev)
    # node i sits at depth k for 2^k <= i < 2^(k+1); node 0 (unused) at 0
    levels = torch.arange(cfg.depth + 1, device=dev)
    depth = torch.cat([levels[:1], levels.repeat_interleave(1 << levels)])
    full = (cfg.heap_bytes >> depth).to(torch.int32)
    is_leaf = depth == cfg.depth
    lc = torch.clamp(2 * idx, max=n - 1)
    rc = torch.clamp(2 * idx + 1, max=n - 1)
    child_full = full >> 1
    stale = (longest[:, lc] == child_full) & (longest[:, rc] == child_full)
    is_blk = (idx > 0) & (longest == 0) & (is_leaf | stale)
    allocated = torch.where(is_blk, full, 0).sum(-1, dtype=torch.int64)
    return (cfg.heap_bytes - allocated).to(torch.int32)
