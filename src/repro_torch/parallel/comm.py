"""The few collectives the mesh tiers run, over `torch.distributed`, and
the two process groups the port brings: `HostStagedGroup` (gloo through
the host) and `FakeWorldGroup` (a world whose collectives do nothing).

Each takes tensors on any device and returns them on the device they came
from. Under ``gloo`` a CUDA tensor is staged through the host (copied to
the CPU, reduced or gathered there, copied back): gloo's CUDA support
varies between PyTorch versions, and R processes sharing one card cannot
run NCCL (it refuses two ranks on one GPU). Under ``nccl`` a CPU tensor is
moved to the process's current card. Every call is a collective: all the
processes of `group` (the world by default) make it, in the same order.
"""
from __future__ import annotations

import functools
import time

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


# ------------------------------------------------- gloo staged through the host
def _timed(kind, result):
    """Add the call's host seconds to `HostStagedGroup.spent_s` and the
    bytes of its results to ``moved_bytes[kind]``; ``result(*args)`` is
    the tensors the call writes."""
    def wrap(method):
        @functools.wraps(method)
        def run(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return method(self, *a, **kw)
            finally:
                cls = HostStagedGroup
                cls.spent_s += time.perf_counter() - t0
                if kind is not None:
                    cls.moved_bytes[kind] = cls.moved_bytes.get(
                        kind, 0) + sum(t.numel() * t.element_size()
                                       for t in result(*a, **kw))
        return run
    return wrap


def _flat(*xs):
    """The tensors of nested lists."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        else:
            out += _flat(*x)
    return out


class HostStagedGroup(dist.ProcessGroup):
    """A gloo process group whose collectives take tensors on any device:
    each call copies its CUDA tensors to the host, runs gloo's collective
    there and copies the results back. It is the process group of a gloo
    world whose processes hold cards (`launch.mesh.init_world`), so that
    DTensor's collectives, which pass CUDA tensors to the group as they
    are, run as this module's functions do; gloo's own CUDA all-gather
    crashed the process (PyTorch 2.11, H100). Every call completes before
    it returns. A summing reduce-scatter is gloo's all-to-all of the
    chunks and a local sum in fp32. ``spent_s`` sums the host
    seconds of this process's calls (copies included), for the share of a
    step spent in collectives; ``moved_bytes`` the bytes of their results
    by kind, named as the functional collectives are
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single``, ``broadcast``, ``gather``)."""

    NAME = "gloo_host"
    spent_s = 0.0
    moved_bytes: dict = {}

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        # the host's collectives are gloo's own; the group's name lives in
        # its backends
        self._register_backend(torch.device("cpu"),
                               dist.ProcessGroup.BackendType.GLOO, self._gloo)

    # ---- plumbing
    def getBackendName(self) -> str:
        return self.NAME

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    @staticmethod
    def _done(result=None):
        """A completed `Work` holding `result`."""
        from torch._C._distributed_c10d import _create_work_from_future
        from torch.futures import Future
        fut = Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    @staticmethod
    def _host(x: torch.Tensor) -> torch.Tensor:
        return x.detach().to("cpu", copy=True).contiguous()

    def _gather_host(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's `x` (equal shapes), on the host, stacked by
        rank ([P, *x.shape]): gloo writes into the rows in place."""
        out = torch.empty((self._size, *x.shape), dtype=x.dtype)
        self._gloo.allgather([list(out.unbind(0))], [self._host(x)]).wait()
        return out

    def _allreduce_host(self, x: torch.Tensor, op) -> torch.Tensor:
        h = self._host(x)
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        self._gloo.allreduce([h], opts).wait()
        return h

    # ---- collectives
    @_timed("all_reduce", lambda tensors, opts=None: _flat(tensors))
    def allreduce(self, tensors, opts=None):
        op = opts.reduceOp if opts is not None else dist.ReduceOp.SUM
        for t in tensors:
            t.copy_(self._allreduce_host(t, op))
        return self._done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    @_timed("all_gather_into_tensor",
            lambda outs, ins, opts=None: _flat(outs))
    def allgather(self, output_tensors, input_tensors, opts=None):
        for outs, x in zip(output_tensors, input_tensors):
            for o, g in zip(outs, self._gather_host(x)):
                o.copy_(g)
        return self._done(output_tensors)

    @_timed("all_gather_into_tensor", lambda out, x, opts=None: [out])
    def all_gather_single(self, output, input, opts=None):
        output.copy_(self._gather_host(input).view(output.shape))
        return self._done(output)

    _allgather_base = all_gather_single

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, x in zip(outputs, inputs):
            self.all_gather_single(o, x)
        return self._done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    @_timed("reduce_scatter_tensor", lambda out, x, opts=None: [out])
    def reduce_scatter_single(self, output, input, opts=None):
        op = opts.reduceOp if opts is not None else dist.ReduceOp.SUM
        if op != dist.ReduceOp.SUM:
            whole = self._allreduce_host(input, op)
            output.copy_(whole.chunk(self._size)[self._rank].view(
                output.shape))
            return self._done(output)
        # an all-to-all of the chunks, then each process sums the ones it
        # received (in fp32): half the bytes of an all-reduce and a cut
        h = self._host(input)
        parts = torch.empty_like(h)
        self._gloo.alltoall_base(parts, h, [], [],
                                 dist.AllToAllOptions()).wait()
        total = parts.view(self._size, -1).float().sum(0)
        output.copy_(total.to(output.dtype).view(output.shape))
        return self._done(output)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, x in zip(outputs, inputs):
            self.reduce_scatter_single(o, x, opts)
        return self._done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    @_timed("all_to_all_single", lambda out, *a, **kw: [out])
    def all_to_all_single(self, output, input, output_split_sizes=None,
                          input_split_sizes=None, opts=None):
        out = torch.empty(output.shape, dtype=output.dtype)
        self._gloo.alltoall_base(out, self._host(input),
                                 list(output_split_sizes or []),
                                 list(input_split_sizes or []),
                                 dist.AllToAllOptions()).wait()
        output.copy_(out)
        return self._done(output)

    alltoall_base = all_to_all_single

    @_timed("broadcast", lambda tensors, opts=None: _flat(tensors))
    def broadcast(self, tensors, opts=None):
        hs = [self._host(t) for t in tensors]
        self._gloo.broadcast(hs, opts or dist.BroadcastOptions()).wait()
        for t, h in zip(tensors, hs):
            t.copy_(h)
        return self._done(tensors)

    @_timed("gather", lambda outs, ins, opts=None: _flat(outs))
    def gather(self, output_tensors, input_tensors, opts=None):
        got = self._gather_host(input_tensors[0])
        root = opts.rootRank if opts is not None else 0
        if self._rank == root:
            for o, g in zip(output_tensors[0], got):
                o.copy_(g)
        return self._done(output_tensors)

    @_timed(None, None)
    def barrier(self, opts=None):
        self._allreduce_host(torch.zeros(1), dist.ReduceOp.SUM)
        return self._done()


def register_host_staged() -> str:
    """Register `HostStagedGroup` as a backend (once) and return its
    name, for ``init_process_group(backend=...)``."""
    name = HostStagedGroup.NAME
    if name.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(name, HostStagedGroup,
                                      devices=["cpu", "cuda"])
    return name


# ------------------------------------------------- a world that sends nothing
class FakeWorldGroup(dist.ProcessGroup):
    """A process group whose collectives do nothing: the backend of a fake
    world (`repro_torch.launch.mesh.fake_world`), one process standing for
    rank 0 of many. It lets the world, a `DeviceMesh` over it and the
    mesh's sub-groups be made without a peer. Its collectives are the
    c10d operators (``c10d::allreduce_``, ``_c10d_functional::*``), which
    under `FakeTensorMode` are computed from shapes and reach no backend;
    on real tensors they raise, for it has none. Its name is held here,
    since it has no backend to hold it."""

    NAME = "fake_world"

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._name = self._desc = None

    def getBackendName(self) -> str:
        return self.NAME

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    def _set_group_name(self, name) -> None:
        self._name = name

    @property
    def group_name(self):
        return self._name

    def _set_group_desc(self, desc) -> None:
        self._desc = desc

    @property
    def group_desc(self):
        return self._desc


def register_fake_world() -> str:
    """Register `FakeWorldGroup` as a backend (once) and return its name,
    for ``init_process_group(backend=...)``."""
    name = FakeWorldGroup.NAME
    if name.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(name, FakeWorldGroup,
                                      devices=["cpu", "cuda"])
    return name
