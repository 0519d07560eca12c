"""Batched buddy-tree allocation: the CUDA kernel and its plain PyTorch
version.

The port of `repro.kernels.buddy_traverse.buddy_alloc_batch_kernel` (the
TPU kernel). For every core c, the requests ``sizes[c, 0..B-1]`` are
served in order (the shared-mutex semantics of the paper's backend)
against that core's ``longest[]`` tree: leftmost-fit descent, leaf
commit, re-max up-walk. A request is served iff

    size > 0  and  r <= heap_bytes  and  tree[1] >= r,
    r = max(next_pow2(size), min_block)

with the reference's int32 `next_pow2` (a size above 2^30 wraps to
INT32_MIN, so it rounds to ``min_block``). The offset of a failed request
is -1. The kernel's ``size > 0`` rule is where it differs from the oracle
`ref.buddy_alloc_batch_ref` (`core.buddy.alloc_batch`), which serves a
size <= 0 as ``min_block``, as the reference's oracle does.

`buddy_alloc_batch_plain` is the plain version. `buddy_alloc_batch_kernel`
is the wrapper `ops.buddy_alloc_batch` calls: for CUDA tensors it launches
``csrc/buddy_traverse.cu`` (one warp per core, the tree in shared memory),
for CPU tensors it runs the plain version. Unlike the TPU wrapper it does
not pad the batch to 128 lanes (padded zero-size requests change nothing).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import buddy
from . import _library

# the kernel holds a core's whole tree in shared memory (at most 227 KiB
# a block on Hopper), so at most 2^15 nodes (128 KiB)
MAX_NODES = 1 << 15


def _cfg(tree, heap_bytes, min_block) -> buddy.BuddyConfig:
    cfg = buddy.BuddyConfig(heap_bytes=heap_bytes, min_block=min_block)
    if tree.dim() != 2 or tree.shape[1] != cfg.n_nodes:
        raise ValueError(f"tree must be [C, {cfg.n_nodes}] for heap "
                         f"{heap_bytes} / min_block {min_block}; got "
                         f"{tuple(tree.shape)}")
    return cfg


def buddy_alloc_batch_plain(tree, sizes, *, heap_bytes: int,
                            min_block: int):
    """The kernel's function in plain PyTorch.

    tree int32 [C, n_nodes]; sizes int32 [C, B]. Returns (offsets int32
    [C, B], new tree); the input tree is left as it was."""
    cfg = _cfg(tree, heap_bytes, min_block)
    longest = tree.clone()
    sizes = sizes.to(torch.int32)
    offs = torch.full(sizes.shape, -1, dtype=torch.int32, device=tree.device)
    for b in range(sizes.shape[1]):
        size = sizes[:, b]
        offs[:, b], _ = buddy._alloc_(cfg, longest, size, live=size > 0)
    return offs, longest


def _check(tree, sizes, cfg):
    """Raise on what the kernel does not take (pointers are passed raw)."""
    if tree.dtype != torch.int32 or sizes.dtype != torch.int32:
        raise ValueError(f"tree and sizes must be int32; got {tree.dtype}, "
                         f"{sizes.dtype}")
    if sizes.dim() != 2 or sizes.shape[0] != tree.shape[0]:
        raise ValueError(f"sizes must be [C={tree.shape[0]}, B]; got "
                         f"{tuple(sizes.shape)}")
    if sizes.device != tree.device:
        raise ValueError(f"sizes is on {sizes.device}, tree on {tree.device}")
    for name, x in (("tree", tree), ("sizes", sizes)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(sizes.shape) == 0:
        raise ValueError("empty batch or no cores")
    if cfg.n_nodes > MAX_NODES:
        raise ValueError(f"a tree of {cfg.n_nodes} nodes "
                         f"({4 * cfg.n_nodes} B) does not fit the kernel's "
                         f"shared memory (at most {MAX_NODES} nodes)")
    if cfg.heap_bytes > 1 << 30:
        raise ValueError("heap_bytes above 2^30")


def buddy_alloc_batch_kernel(tree, sizes, *, heap_bytes: int,
                             min_block: int):
    """Allocate a [C, B] batch of requests against [C, n_nodes] buddy trees.

    Cores proceed in parallel; within a core requests are served in order.
    Returns (offsets int32 [C, B], new tree int32 [C, n_nodes]).

    For CUDA tensors this calls the operator
    ``torch.ops.repro_torch.buddy_alloc_batch``, whose CUDA implementation
    launches the hand-written kernel (``csrc/buddy_traverse.cu``) on the
    current stream; a build or launch error raises, as does a tree above
    `MAX_NODES` nodes. For CPU tensors it runs `buddy_alloc_batch_plain`.
    Any other device raises.
    `buddy_alloc_batch_kernel.launches` counts kernel launches."""
    if tree.device.type == "cpu":
        return buddy_alloc_batch_plain(tree, sizes, heap_bytes=heap_bytes,
                                       min_block=min_block)
    if tree.device.type != "cuda":
        raise ValueError(f"buddy_alloc_batch runs on cuda or cpu, not "
                         f"{tree.device}")
    cfg = _cfg(tree, heap_bytes, min_block)
    _check(tree, sizes, cfg)
    return _OP(tree, sizes, heap_bytes, min_block)


def _launch(tree, sizes, heap_bytes, min_block):
    """The operator's CUDA implementation: launch the kernel."""
    from . import _build
    lib = _build.load("buddy_traverse")
    n_nodes = tree.shape[1]
    C, B = sizes.shape
    offs = torch.empty_like(sizes)
    new_tree = torch.empty_like(tree)
    vp = ctypes.c_void_p
    err = lib.buddy_traverse_launch(
        vp(tree.data_ptr()), vp(sizes.data_ptr()), vp(offs.data_ptr()),
        vp(new_tree.data_ptr()), C, B, n_nodes, heap_bytes, min_block,
        vp(torch.cuda.current_stream(tree.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"buddy_alloc_batch kernel launch failed: "
                           f"error {err}")
    buddy_alloc_batch_kernel.launches += 1
    return offs, new_tree


buddy_alloc_batch_kernel.launches = 0
_OP = _library.define(
    "buddy_alloc_batch", "(Tensor tree, Tensor sizes, int heap_bytes, "
    "int min_block) -> (Tensor, Tensor)", _launch,
    lambda tree, sizes, *_: (torch.empty_like(sizes), torch.empty_like(tree)),
    lambda tree, sizes, heap_bytes, min_block: list(buddy_alloc_batch_plain(
        tree, sizes, heap_bytes=heap_bytes, min_block=min_block)))


# ---------------------------------------------------------------------------
# run-carve helpers of the fused round's batched refill
# (`heap_step.protocol_round`, ``batch_refill=True``): the counterparts of
# the reference's `leftmost_block`, `run_blocks_free` and `carve_run`, on
# an explicit leading core axis (trees [C, n_nodes], per-core b0 and n [C]).
# Every gather is clamped and every write outside the tree lands in a park
# column, as the reference's clipped gathers and drop-mode scatters do.
# ---------------------------------------------------------------------------
def leftmost_block(tree, *, heap_bytes: int, block_bytes: int, depth: int):
    """[C] block index the serial leftmost-fit descent would carve next.

    The descent of `core.buddy.alloc` at block granularity (the same
    ``tree[left] >= block_bytes`` rule), so a run carved from here lands on
    the leaves the serial walks would. Garbage where a tree has no free
    block: callers gate on ``tree[:, 1] >= block_bytes``."""
    nb = heap_bytes // block_bytes
    node = torch.ones(tree.shape[0], dtype=torch.int32, device=tree.device)
    for _ in range(depth):
        left = 2 * node
        go_left = tree.gather(1, left.long()[:, None])[:, 0] >= block_bytes
        node = torch.where(go_left, left, left + 1)
    return node - nb


def run_blocks_free(tree, b0, n, *, window: int, heap_bytes: int,
                    block_bytes: int):
    """[C] bool: blocks ``b0 .. b0+n-1`` of each core are all free
    (``0 <= n <= window``, ``b0 >= 0``).

    A leaf may carry a stale ``longest`` after an ancestor was carved as a
    bigger chunk, so a block is free iff the min over its leaf's whole root
    path is >= ``block_bytes``; ancestors are clamped to the last node."""
    nb = heap_bytes // block_bytes
    depth = nb.bit_length() - 1
    dev = tree.device
    k = torch.arange(window, dtype=torch.int32, device=dev)
    leaves = nb + b0[:, None] + k[None, :]
    shifts = torch.arange(depth + 1, dtype=torch.int32, device=dev)
    anc = torch.clamp(leaves[:, :, None] >> shifts, max=2 * nb - 1)
    vals = tree.gather(1, anc.reshape(tree.shape[0], -1).long())
    free = vals.reshape(anc.shape).amin(-1) >= block_bytes
    return torch.where(k[None, :] < n[:, None], free, True).all(1)


def carve_run(tree, b0, n, *, window: int, heap_bytes: int,
              block_bytes: int):
    """Carve blocks ``b0 .. b0+n-1`` of each core (all known free) in one
    pass; returns the new trees, the input left as it was.

    Bitwise-equal to ``n`` serial leftmost walks at block granularity:
    the leaves are zeroed, then level by level every parent in
    ``[p_lo, p_hi]`` (at most ``window + 1`` of them) is set to the max of
    its children, the value the last serial up-walk through it writes."""
    C, n_nodes = tree.shape
    nb = heap_bytes // block_bytes
    depth = nb.bit_length() - 1
    dev = tree.device
    park = torch.full((C, window + 1), n_nodes, dtype=torch.int32,
                      device=dev)
    t = torch.cat([tree, tree.new_zeros((C, 1))], 1)
    k = torch.arange(window, dtype=torch.int32, device=dev)
    leaf = nb + b0[:, None] + k[None, :]
    keep = (k[None, :] < n[:, None]) & (leaf < n_nodes)
    t.scatter_(1, torch.where(keep, leaf, park[:, :window]).long(), 0)
    w = torch.arange(window + 1, dtype=torch.int32, device=dev)
    for d in range(1, depth + 1):
        p_lo = (nb + b0) >> d
        p_hi = (nb + b0 + n - 1) >> d
        win = p_lo[:, None] + w[None, :]
        child = torch.clamp(2 * win, max=n_nodes - 2).long()
        newval = torch.maximum(t.gather(1, child), t.gather(1, child + 1))
        idx = torch.where((win <= p_hi[:, None]) & (win < n_nodes), win, park)
        t.scatter_(1, idx.long(), newval)
    return t[:, :n_nodes].contiguous()
