"""Production mesh shapes.

The port of `repro.launch.mesh`. A mesh here is its shape: an ordered
mapping of axis names to sizes, which is all the sharding rules
(`repro_torch.parallel.sharding`) and the dry-run read. Single pod: 16 x
16 = 256 devices (data x model). Multi-pod: 2 pods x 256 = 512 with a
leading 'pod' axis (data parallel across pods). Building a
``torch.distributed.DeviceMesh`` over real devices waits for the
multi-GPU tier (ROADMAP A7).
"""
from __future__ import annotations

import torch


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model: int = 1) -> dict:
    """The mesh over the locally visible GPUs (1 x 1 on one card)."""
    n = max(torch.cuda.device_count(), 1)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return {"data": n // model, "model": model}


def mesh_name(mesh: dict) -> str:
    """``16x16`` / ``2x16x16``: the sizes joined, as the reference names
    its result files."""
    return "x".join(str(n) for n in mesh.values())
