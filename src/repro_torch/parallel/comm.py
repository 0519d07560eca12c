"""The few collectives the mesh tiers run, over `torch.distributed`.

Each takes tensors on any device and returns them on the device they came
from. Under ``gloo`` a CUDA tensor is staged through the host (copied to
the CPU, reduced or gathered there, copied back): gloo's CUDA support
varies between PyTorch versions, and R processes sharing one card cannot
run NCCL (it refuses two ranks on one GPU). Under ``nccl`` a CPU tensor is
moved to the process's current card. Every call is a collective: all the
processes of `group` (the world by default) make it, in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _wire_device(group) -> torch.device:
    """Where `group`'s backend wants its tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def all_gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every process's `x` (all the same shape and dtype), in the group's
    rank order, on `x`'s device."""
    wire = _wire_device(group)
    xs = _to(x.contiguous(), wire)
    out = [torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, xs, group=group)
    return [_to(o, x.device) for o in out]


def gather(x: torch.Tensor, dst: int = 0, group=None):
    """Every process's `x` on global rank `dst`, in the group's rank order
    and on `x`'s device; None on the other processes."""
    wire = _wire_device(group)
    xs = _to(x.contiguous(), wire)
    mine = dist.get_rank() == dst
    out = ([torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
           if mine else None)
    dist.gather(xs, out, dst=dst, group=group)
    return [_to(o, x.device) for o in out] if mine else None


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """`x` reduced over the group by `op` (a new tensor on `x`'s device;
    `x` is left as it was)."""
    wire = _wire_device(group)
    xs = x.to(wire, copy=True)
    dist.all_reduce(xs, op=op, group=group)
    return _to(xs, x.device)


def barrier(group=None) -> None:
    """Wait until every process of the group reached this call (a one-
    element all-reduce, which every backend runs on its own device)."""
    all_reduce(torch.zeros(1), group=group)
