"""Production mesh shapes, and a live world and mesh of processes.

The port of `repro.launch.mesh`. A mesh shape is an ordered mapping of
axis names to sizes, which is all the sharding rules
(`repro_torch.parallel.sharding`) and the dry-run read. Single pod: 16 x
16 = 256 devices (data x model). Multi-pod: 2 pods x 256 = 512 with a
leading 'pod' axis (data parallel across pods).

The reference runs its mesh from one controller over the devices it
sees. PyTorch's counterpart is SPMD over processes: `init_world` joins
the process group (from the variables ``torchrun`` sets, or those `spawn`
sets), ``make_host_mesh(live=True)`` is the ``("data", "model")``
`DeviceMesh` over it, and `spawn` runs a function on N local processes.
With ``nccl`` every process needs a card of its own; with ``gloo`` the
processes may share one card (or run on the CPU), their collectives
staged through the host (`repro_torch.parallel.comm`).

`fake_world` stands one process for rank 0 of a world of any size (the
dry-run's 256 and 512 ranks): the group's collectives do nothing, and
under `FakeTensorMode` the program rank 0 runs is recorded from shapes
alone (`repro_torch.launch.dryrun.spmd_program`).
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import queue as _queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model: int = 1, live: bool = False):
    """The mesh over the locally visible GPUs (1 x 1 on one card) as a
    shape; with ``live`` the `DeviceMesh` ``("data", "model")`` over the
    joined process group (`init_world`), ``data = world / model``."""
    if live:
        if not dist.is_initialized():
            raise RuntimeError("make_host_mesh(live=True) needs a process "
                               "group: call init_world first")
        n = dist.get_world_size()
    else:
        n = max(torch.cuda.device_count(), 1)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    if not live:
        return {"data": n // model, "model": model}
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_name(mesh: dict) -> str:
    """``16x16`` / ``2x16x16``: the sizes joined, as the reference names
    its result files."""
    return "x".join(str(n) for n in mesh.values())


@contextlib.contextmanager
def fake_world(shape, names, device_type: str = "cuda"):
    """A world of ``prod(shape)`` ranks held by this one process as rank
    0, on a backend whose collectives do nothing
    (`repro_torch.parallel.comm.FakeWorldGroup`); yields the `DeviceMesh`
    of `shape` with axis `names` (``("data", "model")``, or ``("pod",
    "data", "model")``) over it on `device_type`, and destroys the group
    on exit. Run the program under `FakeTensorMode`: its collectives are
    then computed from shapes. Raises if a process group is already
    initialised (a live world is not replaced)."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already holds a "
                           "process group; a fake world needs one of its "
                           "own")
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                         f"{tuple(names)} differ in length")
    from torch.distributed.device_mesh import init_device_mesh
    from ..parallel.comm import register_fake_world
    dist.init_process_group(register_fake_world(), store=dist.HashStore(),
                            rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh(device_type, tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def mesh_axes(mesh) -> dict:
    """The process-group name of each axis of a live or fake `DeviceMesh`
    -> the axis name, the world's group -> ``"world"``: what a recorded
    collective names its group by."""
    out = {dist.group.WORLD.group_name: "world"}
    for i, name in enumerate(mesh.mesh_dim_names):
        out[mesh.get_group(i).group_name] = name
    return out


def init_world(backend: str = "nccl", *, rank: int = None,
               world_size: int = None, init_method: str = None) -> int:
    """Join the process group and return this process's rank.

    The rank, world size and address come from the arguments or from the
    variables ``torchrun`` (and `spawn`) set: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. ``nccl`` needs a card for every local process and
    raises otherwise; it never picks ``gloo`` on its own. Where a card is
    present, this process's card (``LOCAL_RANK`` modulo the cards) is made
    current before the group exists. A process already in a group keeps
    it. ``gloo`` in a process that holds a card joins through
    `repro_torch.parallel.comm.HostStagedGroup`: gloo's collectives with
    CUDA tensors staged through the host, DTensor's collectives too."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and cards < local_world:
        raise RuntimeError(
            f"backend='nccl' needs a card for each of the {local_world} "
            f"local processes and this host has {cards}; pass "
            f"backend='gloo' to share the cards (or run on the CPU)")
    if cards:
        torch.cuda.set_device(local_rank % cards)
        torch.cuda.init()
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env['MASTER_PORT']}")
    if backend == "gloo" and cards:
        from ..parallel.comm import register_host_staged
        backend = register_host_staged()
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, nprocs, port, backend, fn, args, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        init_world(backend)
        # by value: a tensor sent through the queue as it is would travel
        # as a shared-memory handle that dies with this process
        out = pickle.dumps(fn(*args))
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str = "gloo",
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on `nprocs` new processes (start method
    ``spawn``) joined into one process group of `backend` on a free local
    port; return the results, by rank. `fn` must be importable by name (a
    module-level function) and its results picklable; they are copied by
    value (tensors come back on the device they left from). A
    process that raises, dies or outlasts `timeout` seconds raises here
    with its traceback; the others are stopped."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, nprocs, port, backend,
                                                fn, args, queue))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs and not errors:
            try:
                rank, ok, out = queue.get(timeout=1.0)
                (results if ok else errors)[rank] = (pickle.loads(out) if ok
                                                     else out)
                continue
            except _queue.Empty:
                pass
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in results and p.exitcode]
            if dead:
                errors[dead[0][0]] = f"exited with code {dead[0][1]}"
            elif time.monotonic() > deadline:
                errors[-1] = f"no result from every process in {timeout} s"
        if errors:
            rank, tb = min(errors.items())
            raise RuntimeError(f"spawn: process {rank} of {nprocs} failed:"
                               f"\n{tb}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"spawn: processes exited with {bad}")
    return [results[r] for r in range(nprocs)]
