"""The rank mesh of the heap fleet.

The port of `repro.parallel.meshctx`'s `make_rank_mesh`. The rest of the
reference's module activates an ambient JAX mesh; PyTorch has none (a
`DeviceMesh` is passed explicitly), so nothing else of it is ported.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def rank_mesh_size(num_ranks: int, world: int) -> int:
    """The reference's divisor rule: the largest k <= min(R, world) that
    divides R, so every process of the mesh holds as many ranks."""
    ranks, n = max(num_ranks, 1), max(world, 1)
    return max(k for k in range(1, min(ranks, n) + 1) if ranks % k == 0)


def make_rank_mesh(num_ranks: int, axis_name: str = "ranks"):
    """A 1-D `DeviceMesh` named `axis_name` over the first
    `rank_mesh_size(num_ranks, world)` processes of the process group;
    the processes past it hold no ranks. Without a process group, or in a
    world of one process, it is ``False``: the one-device fold of the rank
    axis (`repro_torch.core.heap.sharded_step`). The mesh is on the card
    where one is present."""
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return False
    from torch.distributed.device_mesh import DeviceMesh
    d = rank_mesh_size(num_ranks, dist.get_world_size())
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, list(range(d)), mesh_dim_names=(axis_name,))
