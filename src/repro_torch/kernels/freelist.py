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

    For CUDA tensors this launches the hand-written kernel
    (``csrc/freelist.cu``) on the current stream; a build or launch error
    raises. For CPU tensors it runs `freelist_op_plain`. Any other device
    raises. `freelist_op_kernel.launches` counts kernel launches."""
    if stacks.device.type == "cpu":
        return freelist_op_plain(stacks, counts, op, cls, ptr_in)
    if stacks.device.type != "cuda":
        raise ValueError(f"freelist_op runs on cuda or cpu, not "
                         f"{stacks.device}")
    _check(stacks, counts, op, cls, ptr_in)
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
