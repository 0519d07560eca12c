"""Thread-cache freelist pop / push: the CUDA kernel and its plain PyTorch
version.

The port of `repro.kernels.freelist.freelist_op_kernel` (the TPU kernel,
the paper's lock-free frontend). Thread cache t holds NC LIFO size-class
stacks ``stacks[t] [NC, CAP]`` with depths ``counts[t] [NC]``; each cache
applies one op: ``op[t]`` = 0 pops class ``cls[t]`` (``ptr_out[t]`` = the
top, or -1 when empty), 1 pushes ``ptr_in[t]`` (dropped when full), any
other value is idle.

Index rule. The kernel is the reference's as its tests run it (interpret
mode): the class is clamped into [0, NC-1] and a stack position counts
from the end when negative and is then clamped into [0, CAP-1], for reads
and for writes alike. The oracle `ref.freelist_op_ref` clamps its reads
the same way but drops a write whose index lies outside, so for a class
>= NC it leaves ``counts`` (and on a push ``stacks``) unchanged where the
kernel updates class NC-1; ``ptr_out`` agrees. Counts wrap as int32.

`freelist_op_plain` is the plain version. `freelist_op_kernel` is the
wrapper `ops.freelist_op` calls: for CUDA tensors it launches
``csrc/freelist.cu`` (one CTA per thread cache), for CPU tensors it runs
the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _library


def _wrap_clamp(i, n: int):
    """A negative index counts from the end; then clamp into [0, n-1]."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def freelist_op_plain(stacks, counts, op, cls, ptr_in):
    """The kernel's function in plain PyTorch.

    stacks int32 [T, NC, CAP]; counts int32 [T, NC]; op / cls / ptr_in
    int32 [T]. Returns (ptr_out [T], new counts, new stacks); the inputs
    are left as they were."""
    T, NC, CAP = stacks.shape
    t = torch.arange(T, device=stacks.device)
    c = cls.clamp(0, NC - 1).long()
    cnt = counts[t, c]
    is_pop = (op == 0) & (cnt > 0)
    is_push = (op == 1) & (cnt < CAP)
    pos_pop = _wrap_clamp(torch.clamp(cnt - 1, min=0), CAP).long()
    ptr_out = torch.where(is_pop, stacks[t, c, pos_pop], -1).to(torch.int32)
    pos_push = _wrap_clamp(torch.clamp(cnt, max=CAP - 1), CAP).long()
    new_stacks = stacks.clone()
    new_stacks[t, c, pos_push] = torch.where(is_push, ptr_in,
                                             stacks[t, c, pos_push])
    delta = torch.where(is_pop, -1, torch.where(is_push, 1, 0))
    new_counts = counts.clone()
    new_counts[t, c] = (cnt + delta).to(torch.int32)
    return ptr_out, new_counts, new_stacks


def _check(stacks, counts, op, cls, ptr_in):
    """Raise on what the kernel does not take (pointers are passed raw)."""
    if stacks.dim() != 3:
        raise ValueError(f"stacks must be [T, NC, CAP]; got "
                         f"{tuple(stacks.shape)}")
    T, NC, CAP = stacks.shape
    if tuple(counts.shape) != (T, NC):
        raise ValueError(f"counts must be [T={T}, NC={NC}]; got "
                         f"{tuple(counts.shape)}")
    for name, x in (("stacks", stacks), ("counts", counts), ("op", op),
                    ("cls", cls), ("ptr_in", ptr_in)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32; got {x.dtype}")
        if x.device != stacks.device:
            raise ValueError(f"{name} is on {x.device}, stacks on "
                             f"{stacks.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() == 1 and tuple(x.shape) != (T,):
            raise ValueError(f"{name} must be [T={T}]; got "
                             f"{tuple(x.shape)}")
    if min(T, NC, CAP) == 0:
        raise ValueError("empty stacks")
    if T > 2 ** 31 - 1 or NC * CAP > 2 ** 31 - 1:
        raise ValueError("stacks too large for int32 indexing")


def freelist_op_kernel(stacks, counts, op, cls, ptr_in):
    """Apply one freelist op per thread cache.

    stacks int32 [T, NC, CAP]; counts int32 [T, NC]; op / cls / ptr_in
    int32 [T]. Returns (ptr_out int32 [T], new counts, new stacks).

    For CUDA tensors this calls the operator
    ``torch.ops.repro_torch.freelist_op``, whose CUDA implementation
    launches the hand-written kernel (``csrc/freelist.cu``) on the current
    stream; a build or launch error raises. For CPU tensors it runs
    `freelist_op_plain`. Any other device raises.
    `freelist_op_kernel.launches` counts kernel launches."""
    if stacks.device.type == "cpu":
        return freelist_op_plain(stacks, counts, op, cls, ptr_in)
    if stacks.device.type != "cuda":
        raise ValueError(f"freelist_op runs on cuda or cpu, not "
                         f"{stacks.device}")
    _check(stacks, counts, op, cls, ptr_in)
    return _OP(stacks, counts, op, cls, ptr_in)


def _launch(stacks, counts, op, cls, ptr_in):
    """The operator's CUDA implementation: launch the kernel."""
    from . import _build
    lib = _build.load("freelist")
    T, NC, CAP = stacks.shape
    ptr_out = torch.empty_like(op)
    new_counts = torch.empty_like(counts)
    new_stacks = torch.empty_like(stacks)
    vp = ctypes.c_void_p
    err = lib.freelist_launch(
        vp(stacks.data_ptr()), vp(counts.data_ptr()), vp(op.data_ptr()),
        vp(cls.data_ptr()), vp(ptr_in.data_ptr()), vp(ptr_out.data_ptr()),
        vp(new_counts.data_ptr()), vp(new_stacks.data_ptr()), T, NC, CAP,
        vp(torch.cuda.current_stream(stacks.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"freelist_op kernel launch failed: error {err}")
    freelist_op_kernel.launches += 1
    return ptr_out, new_counts, new_stacks


freelist_op_kernel.launches = 0
_OP = _library.define(
    "freelist_op", "(Tensor stacks, Tensor counts, Tensor op, Tensor cls, "
    "Tensor ptr_in) -> (Tensor, Tensor, Tensor)", _launch,
    lambda stacks, counts, op, *_: (torch.empty_like(op),
                                    torch.empty_like(counts),
                                    torch.empty_like(stacks)),
    lambda *a: list(freelist_op_plain(*a)))


def bulk_refill(stacks, counts, sel, cls, rows, new_counts):
    """Same-round freelist refill of many threads at once (the fused
    round's batched refill); the counterpart of the reference's
    `bulk_refill`, over any leading axes.

    For every thread with ``sel``: ``stacks[..., cls, :width]`` becomes
    ``rows`` (``width = rows.shape[-1]``) and ``counts[..., cls]`` becomes
    ``new_counts``; other threads, classes and the stack slots past
    ``width`` are left as they were. Returns new (stacks, counts)."""
    NC, CAP = stacks.shape[-2:]
    width = rows.shape[-1]
    pick = sel[..., None] & (
        torch.arange(NC, dtype=torch.int32, device=stacks.device)
        == cls[..., None])
    lane = torch.arange(CAP, device=stacks.device) < width
    rows_cap = torch.nn.functional.pad(rows, (0, CAP - width))
    stacks = torch.where(pick[..., None] & lane, rows_cap[..., None, :],
                         stacks)
    counts = torch.where(pick, new_counts[..., None], counts)
    return stacks, counts


# ---------------------------------------------------------------------------
# the arena frontend's helpers (the bump-pointer fast path ahead of the
# buddy mutex phase, see `repro_torch.core.arena`): plain PyTorch ops over
# an explicit leading core axis, the counterparts of the reference's
# pure-jnp `arena_*` helpers (not Pallas kernels there either)
# ---------------------------------------------------------------------------
# map elements a reset pass reads at once: bounds its temporaries
RESET_CHUNK = 1 << 24


def drop_set_(table, idx, val, on):
    """``table[c, idx[c, t]] = val[c, t]`` where ``on[c, t]``, in place, on
    a ``[C, n]`` table; a lane that is not ``on`` writes nothing (the
    reference's drop-mode scatter through a park slot at index n).

    Indices of ``on`` lanes are clamped into the table, as the reference's
    are. A masked lane is sent to the index of its core's first ``on``
    lane with that lane's value, or, in a core without one, writes back
    what the core's slot 0 holds: every duplicate index then carries one
    value, so the scatter is deterministic on either device. Returns
    `table`."""
    n = table.shape[-1]
    val = torch.as_tensor(val, dtype=table.dtype,
                          device=table.device).expand(idx.shape)
    i = idx.clamp(0, n - 1)
    first = on.to(torch.int8).argmax(-1, keepdim=True)
    any_on = on.any(-1, keepdim=True)
    i0 = torch.where(any_on, i.gather(-1, first), 0)
    v0 = torch.where(any_on, val.gather(-1, first), table[:, :1])
    table.scatter_(-1, torch.where(on, i, i0).long(),
                   torch.where(on, val, v0))
    return table


def arena_bump_shared(bump, cand, gneed, limit: int):
    """Shared-arena bump allocation; contenders serialize in thread order.

    bump int32 [C] granules consumed; cand bool [C, T] attempts this
    round; gneed int32 [C, T] granules wanted. A failed fit consumes no
    space, so a later, smaller request can still be served: a loop of T
    steps on ``[C]`` tensors (no cumsum gives that exactly). Returns
    (new bump [C], start granule int32 [C, T] (-1 on fail), served bool
    [C, T])."""
    g0, served = [], []
    for t in range(cand.shape[-1]):
        need = gneed[:, t]
        fits = cand[:, t] & (bump + need <= limit)
        g0.append(torch.where(fits, bump, -1))
        served.append(fits)
        bump = bump + torch.where(fits, need, 0)
    return (bump.to(torch.int32), torch.stack(g0, -1).to(torch.int32),
            torch.stack(served, -1))


def arena_bump_tl(bump, cand, gneed, region_gran: int):
    """Per-thread-region bump allocation (the tlregion fast path): no
    cross-thread serialization. bump int32 [C, T], each an offset inside
    thread t's private region of ``region_gran`` granules. Returns (new
    bump, absolute start granule int32 [C, T] (-1 on fail), served)."""
    T = bump.shape[-1]
    fits = cand & (bump + gneed <= region_gran)
    base = torch.arange(T, dtype=torch.int32, device=bump.device) \
        * region_gran
    g0 = torch.where(fits, base + bump, -1).to(torch.int32)
    return (bump + torch.where(fits, gneed, 0)).to(torch.int32), g0, fits


def arena_mark(cls_map, g, cls, on):
    """Record arena placements: ``cls_map[c, g] = cls`` where ``on``
    (drop-mode, see `drop_set_`). Updates ``cls_map [C, n]`` in place and
    returns it."""
    return drop_set_(cls_map, g, cls, on)


def arena_hole(cls_map, g, on):
    """Retire arena blocks: ``cls_map[c, g] = -1`` where ``on`` (bump
    space is not reclaimed until the next epoch reset: holes stay holes).
    In place; returns `cls_map`."""
    return drop_set_(cls_map, g, -1, on)


def arena_region_reset(cls_map, class_sizes, region_mask):
    """Bulk epoch reset: clear every placement where ``region_mask`` holds.

    ``cls_map`` is ``[C, ...]`` (``[C, n]``, or a thread-region view
    ``[C, T, region_gran]``) and ``region_mask`` broadcasts against it
    (``[C, 1]`` for a whole map, ``[C, T, 1]`` per thread region).
    Updates the map in place and returns (cls_map, freed int32 [C]): the
    rounded bytes being retired, the telemetry delta. Class indices are
    clamped into the class table, as the reference clamps them; the pass
    runs a few cores at a time to bound its temporaries."""
    C = cls_map.shape[0]
    nc = class_sizes.shape[0]
    mask = torch.broadcast_to(region_mask, cls_map.shape)
    per_core = max(1, cls_map[0].numel())
    step = max(1, RESET_CHUNK // per_core)
    freed = []
    for c0 in range(0, C, step):
        m, k = cls_map[c0:c0 + step], mask[c0:c0 + step]
        live = k & (m >= 0)
        b = torch.where(live, class_sizes[m.clamp(0, nc - 1).long()], 0)
        freed.append(b.flatten(1).sum(1, dtype=torch.int32))
        m.masked_fill_(k, -1)
    return cls_map, torch.cat(freed).to(torch.int32)
