"""The allocator's request/response protocol, batched over cores.

Every design point serves the same typed protocol:

    state, response = heap.step(cfg, state, request)

`AllocRequest` carries one op per hardware thread (MALLOC / FREE /
REALLOC / CALLOC / NOOP) as int32 ``[C, T]`` tensors: C PIM cores, T
threads each. The core axis is explicit (the reference vmaps a per-core
step); core i's requests never touch core j's state. `AllocResponse`
returns pointers, result paths and the DPU cost model's per-thread
accounting.

Backends register through `register` (`repro_torch.core.system`): the
paper's scan-based design points ``strawman``, ``sw`` and ``hwsw`` and the
wrappers ``sanitizer``, ``arena`` and ``tlregion`` as plain PyTorch ops,
and ``fused``, the counterpart of the reference's ``pallas`` kind: one
fused CUDA kernel per round on the card, its plain PyTorch version on CPU
tensors.

Three tiers serve the protocol: `step` on ``[C, T]`` requests,
`MultiCoreHeap` (C cores behind one entry point) and `ShardedHeap` (R
ranks of C cores, ``[R, C, T]`` requests). On one device the rank axis is
a batch axis folded onto the core axis, which is exact because cores are
independent. On a 1-D rank `DeviceMesh` of processes (`RankShard`) each
process holds and steps its own slice of the ranks and the responses are
gathered over the mesh: the paper's PIM-Metadata / PIM-Executed placement
at fleet scale, where no metadata crosses a core or a rank.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .. import device as _device
from ..parallel import comm

OP_NOOP = 0
OP_MALLOC = 1
OP_FREE = 2
OP_REALLOC = 3
OP_CALLOC = 4
OP_EPOCH_RESET = 5

OP_NAMES = {OP_NOOP: "noop", OP_MALLOC: "malloc", OP_FREE: "free",
            OP_REALLOC: "realloc", OP_CALLOC: "calloc",
            OP_EPOCH_RESET: "epoch_reset"}

NULL_PTR = -1  # free(-1) is benign, alloc failure returns it
INT32_MAX = 2 ** 31 - 1


class AllocRequest(NamedTuple):
    """One batched request round: op/size/ptr int32[..., T]."""

    op: torch.Tensor
    size: torch.Tensor
    ptr: torch.Tensor


class AllocResponse(NamedTuple):
    """Per-thread results of one round (see the reference's AllocResponse):
    ptr int32, ok bool, path int32 (0 hit / 1 refill / 2 bypass / 3 fail for
    allocs; 0 small / 1 big / 2 dropped for frees; -1 idle), moved bool,
    latency_cyc / backend_cyc float32, meta_hits / meta_misses / dram_bytes
    int32."""

    ptr: torch.Tensor
    ok: torch.Tensor
    path: torch.Tensor
    moved: torch.Tensor
    latency_cyc: torch.Tensor
    backend_cyc: torch.Tensor
    meta_hits: torch.Tensor
    meta_misses: torch.Tensor
    dram_bytes: torch.Tensor


# ---------------------------------------------------------------------------
# request builders: any leading shape, thread axis last; an `active` mask
# broadcasts against the data (trailing axes align) and keeps its device
# ---------------------------------------------------------------------------
def _i32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _mask(active, like: torch.Tensor) -> torch.Tensor:
    if active is None:
        return torch.ones(like.shape, dtype=torch.bool, device=like.device)
    m = torch.as_tensor(active, dtype=torch.bool, device=like.device)
    return torch.broadcast_to(m, like.shape)


def _where(cond, a, b) -> torch.Tensor:
    """torch.where with int32 result for scalar or tensor branches."""
    like = cond.new_zeros(cond.shape, dtype=torch.int32)
    return torch.where(cond, like + a, like + b)


def noop_request(num_threads: int, device="cuda") -> AllocRequest:
    z = torch.zeros((num_threads,), dtype=torch.int32,
                    device=_device.resolve(device))
    return AllocRequest(op=z, size=z.clone(), ptr=z - 1)


def malloc_request(sizes, active=None) -> AllocRequest:
    sizes = _i32(sizes)
    on = _mask(active, sizes) & (sizes > 0)
    return AllocRequest(op=_where(on, OP_MALLOC, OP_NOOP),
                        size=_where(on, sizes, 0),
                        ptr=torch.full_like(sizes, -1))


def free_request(ptrs, active=None) -> AllocRequest:
    """free(ptr) with C semantics: NULL (== -1) frees are benign no-ops;
    every other pointer, garbage included, is passed through so the backend
    counts it as a dropped free (path 2)."""
    ptrs = _i32(ptrs)
    on = _mask(active, ptrs) & (ptrs != NULL_PTR)
    return AllocRequest(op=_where(on, OP_FREE, OP_NOOP),
                        size=torch.zeros_like(ptrs),
                        ptr=_where(on, ptrs, -1))


def realloc_request(ptrs, sizes, active=None) -> AllocRequest:
    """realloc(ptr, size) with C semantics:

      * ptr < 0, size > 0   -> plain malloc(size)
      * ptr >= 0, size == 0 -> free(ptr)
      * ptr < 0, size == 0  -> NOOP
      * size < 0            -> a failing INT32_MAX request; a live old block
        stays intact, as C realloc leaves it on failure.
    """
    ptrs = _i32(ptrs)
    sizes = _i32(sizes, ptrs.device)
    ptrs, sizes = torch.broadcast_tensors(ptrs, sizes)
    on = _mask(active, ptrs)
    eff = _where(sizes < 0, INT32_MAX, sizes)
    has_ptr = ptrs >= 0
    op = _where(~on, OP_NOOP,
                _where(has_ptr & (eff > 0), OP_REALLOC,
                       _where(has_ptr, OP_FREE,
                              _where(eff > 0, OP_MALLOC, OP_NOOP))))
    return AllocRequest(op=op, size=_where(on & (eff > 0), eff, 0),
                        ptr=_where(on & has_ptr, ptrs, -1))


def epoch_reset_request(num_threads: int, active=None,
                        device="cuda") -> AllocRequest:
    """EPOCH_RESET: bulk-retire an arena frontend's epoch (kinds ``arena``
    and ``tlregion``). Backends without an arena frontend serve it as an
    idle round (ok=False, path -1), so mixed-kind tapes replay everywhere;
    the ``sanitizer`` retires every live shadow start."""
    z = torch.zeros((num_threads,), dtype=torch.int32,
                    device=_device.resolve(device))
    on = _mask(active, z)
    return AllocRequest(op=_where(on, OP_EPOCH_RESET, OP_NOOP), size=z,
                        ptr=z - 1)


def calloc_request(nmemb, sizes, active=None) -> AllocRequest:
    """calloc(nmemb, size): total bytes with the C overflow guard — an
    overflowing product becomes a failing INT32_MAX request."""
    from .pim_malloc import total_calloc_bytes
    nmemb = _i32(nmemb)
    total = total_calloc_bytes(nmemb, _i32(sizes, nmemb.device))
    on = _mask(active, total) & (total > 0)
    return AllocRequest(op=_where(on, OP_CALLOC, OP_NOOP),
                        size=_where(on, total, 0),
                        ptr=torch.full_like(total, -1))


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------
REGISTRY: dict[str, Callable] = {}


def register(kind: str):
    """Register a backend step: fn(cfg, state, AllocRequest) ->
    (state, AllocResponse), both batched over cores."""

    def deco(fn):
        REGISTRY[kind] = fn
        return fn

    return deco


def kinds() -> tuple:
    """The registered kinds in registration order: ``('strawman', 'sw',
    'hwsw', 'sanitizer', 'arena', 'tlregion', 'fused')``."""
    _ensure_backends()
    return tuple(REGISTRY)


def _ensure_backends():
    if not REGISTRY:
        from . import system  # noqa: F401  (registers the port's kinds)


def init(cfg, prepopulate: bool = True, num_cores: int = 1, device="cuda"):
    """Fresh heap state for `cfg` (a `system.SystemConfig`), every leaf with
    a leading ``[num_cores]`` axis, on `device` (the card by default)."""
    from . import system
    return system.system_init(cfg, prepopulate=prepopulate,
                              num_cores=num_cores, device=device)


def step(cfg, state, request: AllocRequest):
    """Serve one ``[C, T]`` request round on the backend named by
    `cfg.kind`; returns (state, AllocResponse).

    The step consumes `state`, on the card and on the CPU alike: every
    kind updates its allocator tensors in place (the ``fused`` kind its
    nine allocator and cache tensors, see
    `repro_torch.kernels.heap_step.fused_heap_step`) and returns them in
    the new state. A caller that needs the old state afterwards (a
    snapshot, a rollback) keeps a clone of it."""
    _ensure_backends()
    return REGISTRY[cfg.kind](cfg, state, request)


def run_rounds(cfg, state, requests: AllocRequest):
    """Step over an ``[R, C, T]`` request tape; returns (state,
    AllocResponse with ``[R, C, T]`` leaves)."""
    resps = []
    for r in range(requests.op.shape[0]):
        state, resp = step(cfg, state, AllocRequest(*(x[r] for x in requests)))
        resps.append(resp)
    return state, AllocResponse(*(torch.stack(f) for f in zip(*resps)))


def run_alloc_free_rounds(cfg, state, sizes_rounds):
    """Fig 6's (de)allocation loop over ``[R, C, T]`` sizes: each round
    mallocs sizes[r], then frees the pointers it just received. Returns
    (state, alloc responses, free responses), ``[R, C, T]`` leaves."""
    ras, rfs = [], []
    for sizes in sizes_rounds:
        state, ra = step(cfg, state, malloc_request(sizes))
        state, rf = step(cfg, state, free_request(ra.ptr))
        ras.append(ra)
        rfs.append(rf)
    return (state, AllocResponse(*(torch.stack(f) for f in zip(*ras))),
            AllocResponse(*(torch.stack(f) for f in zip(*rfs))))


def multicore_init(cfg, num_cores: int, prepopulate: bool = True,
                   device="cuda"):
    """Stacked per-core states: every leaf gains a leading [C] axis."""
    return init(cfg, prepopulate=prepopulate, num_cores=num_cores,
                device=device)


def multicore_step(cfg, states, requests: AllocRequest):
    """`step` over the core axis: requests are ``[C, T]``-leaved (the
    reference vmaps a per-core step; here the axis is explicit)."""
    return step(cfg, states, requests)


class MultiCoreHeap:
    """C independent per-core heaps behind one ``[C, T]`` entry point.

    The builders' `active` argument is a per-core ``[C]`` mask (or a
    scalar): it masks whole cores, never thread slots, as in the
    reference's vmapped builders."""

    def __init__(self, cfg, num_cores: int, prepopulate: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.num_cores = num_cores
        self.device = _device.resolve(device)
        self.state = init(cfg, prepopulate=prepopulate, num_cores=num_cores,
                          device=self.device)

    @property
    def num_threads(self) -> int:
        return self.cfg.num_threads

    def step(self, request: AllocRequest) -> AllocResponse:
        """Serve a ``[C, T]`` request batch; advances the stacked state in
    place (see `step`)."""
        request = AllocRequest(*(_i32(x, self.device) for x in request))
        self.state, resp = step(self.cfg, self.state, request)
        return resp

    def _core_mask(self, active):
        if active is None:
            return None
        m = torch.as_tensor(active, dtype=torch.bool, device=self.device)
        return torch.broadcast_to(m, (self.num_cores,)).reshape(-1, 1)

    def _v(self, build, *args, active=None):
        args = [_i32(a, self.device) for a in args]
        return self.step(build(*args, active=self._core_mask(active)))

    def malloc(self, sizes, active=None) -> AllocResponse:
        return self._v(malloc_request, sizes, active=active)

    def free(self, ptrs, active=None) -> AllocResponse:
        return self._v(free_request, ptrs, active=active)

    def realloc(self, ptrs, sizes, active=None) -> AllocResponse:
        return self._v(realloc_request, ptrs, sizes, active=active)

    def calloc(self, nmemb, sizes, active=None) -> AllocResponse:
        return self._v(calloc_request, nmemb, sizes, active=active)


# ---------------------------------------------------------------------------
# the fleet tier: R ranks of C cores
# ---------------------------------------------------------------------------
def fold(tree, n: int):
    """Leaves ``[R, C, ...]`` as views ``[R * C, ...]``."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((n,) + tree.shape[2:])
    return type(tree)(*(fold(x, n) for x in tree))


def _unfold(tree, R: int, C: int):
    if isinstance(tree, torch.Tensor):
        return tree.reshape((R, C) + tree.shape[1:])
    return type(tree)(*(_unfold(x, R, C) for x in tree))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


def sharded_init(cfg, num_ranks: int, num_cores: int,
                 prepopulate: bool = True, device="cuda"):
    """Fleet state: every leaf gains leading ``[R, C]`` axes (R copies of
    the `multicore_init` state), on `device` (the card by default)."""
    st = multicore_init(cfg, num_cores, prepopulate=prepopulate,
                        device=device)

    def rep(x):
        if isinstance(x, torch.Tensor):
            return x.unsqueeze(0).expand((num_ranks,) + x.shape).contiguous()
        return type(x)(*(rep(y) for y in x))

    return rep(st)


def sharded_step(cfg, states, requests: AllocRequest):
    """`step` over ``[R, C, T]`` requests and ``[R, C, ...]`` states: the
    rank axis folded onto the core axis (``[R * C, ...]`` views), stepped,
    and unfolded. Exact, since every core is independent; like `step` it
    consumes `states`."""
    R, C = requests.op.shape[:2]
    states, resp = step(cfg, fold(states, R * C),
                        AllocRequest(*fold(requests, R * C)))
    return _unfold(states, R, C), _unfold(resp, R, C)


def sharded_inner(cfg, num_ranks: int, mesh=None, axis_name: str = "ranks"):
    """The fleet round's step fn(state, [R, C, T]-request) and its mesh.

    ``mesh=None`` builds `repro_torch.parallel.meshctx.make_rank_mesh`
    over the process group (``False`` without one, or in a world of one
    process); ``mesh=False`` is the one-device fold, ``(sharded_step bound
    to cfg, None)``; a 1-D `DeviceMesh` of processes is used as given
    (its one axis is the rank axis, whatever `axis_name` says): fn then
    takes this process's ``[R/d, C, ...]`` state slice and the global
    request and returns the slice and the global response
    (`RankShard.step`). Anything else raises, and so does a mesh whose
    size does not divide `num_ranks`."""
    inner = functools.partial(sharded_step, cfg)
    if mesh is None:
        from ..parallel.meshctx import make_rank_mesh
        mesh = make_rank_mesh(num_ranks, axis_name)
    if mesh is False:
        return inner, None
    return functools.partial(RankShard(mesh, num_ranks).step, inner), mesh


_RESP_DTYPES = (torch.int32, torch.bool, torch.int32, torch.bool,
                torch.float32, torch.float32, torch.int32, torch.int32,
                torch.int32)


def _pack(resp: AllocResponse) -> torch.Tensor:
    """The response's nine fields as one int32 tensor ``[9, ...]`` (bools
    as 0 / 1, float32 by their bits), so a round gathers in one call."""
    return torch.stack([x.view(torch.int32) if x.dtype == torch.float32
                        else x.to(torch.int32) for x in resp])


def _unpack(x: torch.Tensor) -> AllocResponse:
    return AllocResponse(*(
        v.view(torch.float32) if dt == torch.float32
        else v != 0 if dt == torch.bool else v
        for v, dt in zip(x.unbind(0), _RESP_DTYPES)))


class RankShard:
    """A fleet's R ranks on a 1-D rank `DeviceMesh` of d processes.

    Mesh position i (global rank ``mesh.mesh[i]``) holds ranks
    ``[i * R/d, (i + 1) * R/d)``: its state is that ``[R/d, C, ...]``
    slice. A process of the world outside the mesh holds no ranks (a
    ``[0, C, ...]`` state, never stepped) and still receives every
    gathered result. The gathers run over the whole process group
    (`repro_torch.parallel.comm`), each process sending ``R/d`` rows
    (zeros from a process without ranks) and keeping the mesh members'
    rows in mesh order."""

    def __init__(self, mesh, num_ranks: int):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
            raise TypeError(
                f"mesh must be None, False or a 1-D DeviceMesh of "
                f"processes (the multi-GPU rank axis), got {mesh!r}")
        d = mesh.size()
        if num_ranks % d:
            raise ValueError(
                f"num_ranks={num_ranks} not divisible by mesh axis "
                f"{mesh.mesh_dim_names[0]}={d}")
        self.mesh = mesh
        self.num_ranks = num_ranks
        self.per = num_ranks // d
        self.members = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        coord = mesh.get_coordinate()
        self.lo = 0 if coord is None else coord[0] * self.per
        self.count = 0 if coord is None else self.per

    @property
    def hi(self) -> int:
        return self.lo + self.count

    def local(self, tree):
        """Every leaf's rows ``[lo, hi)``: this process's ranks (a view)."""
        if isinstance(tree, torch.Tensor):
            return tree[self.lo:self.hi]
        return type(tree)(*(self.local(x) for x in tree))

    def init(self, cfg, num_cores: int, prepopulate: bool = True,
             device="cuda"):
        """This process's slice of a fresh fleet (`sharded_init`)."""
        return sharded_init(cfg, self.count, num_cores,
                            prepopulate=prepopulate, device=device)

    def _rows(self, x, axis: int = 0):
        """`x` padded with zeros to ``per`` rows along `axis` where this
        process holds no ranks, as the gathers send it."""
        if self.count:
            return x
        shape = list(x.shape)
        shape[axis] = self.per
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    def gather(self, tree, axis: int = 0):
        """Every leaf of a rank-sharded tree whole (``[R, ...]`` along
        `axis`), on every process."""
        if isinstance(tree, torch.Tensor):
            x = self._rows(tree, axis)
            wire = x.to(torch.uint8) if x.dtype == torch.bool else x
            parts = comm.all_gather(wire)
            out = torch.cat([parts[m] for m in self.members], dim=axis)
            return out.bool() if x.dtype == torch.bool else out
        return type(tree)(*(self.gather(x, axis) for x in tree))

    def gather_to(self, tree, dst: int = 0):
        """A rank-sharded tree whole (every leaf ``[R, ...]``) on global
        rank `dst`; None on the other processes."""
        def leaf(x):
            x = self._rows(x)
            wire = x.to(torch.uint8) if x.dtype == torch.bool else x
            parts = comm.gather(wire, dst=dst)
            if parts is None:
                return None
            out = torch.cat([parts[m] for m in self.members])
            return out.bool() if x.dtype == torch.bool else out

        def walk(t):
            if isinstance(t, torch.Tensor):
                return leaf(t)
            return type(t)(*(walk(x) for x in t))

        out = walk(tree)
        return out if dist.get_rank() == dst else None

    def step(self, inner, states, requests: AllocRequest):
        """One round: this process steps its ranks of the global ``[R, C,
        T]`` request with `inner` (`sharded_step`: one heap-step launch on
        ``fused``) and every process receives the global response, in one
        gather. Consumes `states` as `inner` does."""
        if requests.op.shape[0] != self.num_ranks:
            raise ValueError(f"request of {requests.op.shape[0]} ranks, "
                             f"the fleet has {self.num_ranks}")
        if self.count:
            states, resp = inner(states, AllocRequest(*self.local(requests)))
            packed = _pack(resp)
        else:
            packed = torch.zeros(
                (len(_RESP_DTYPES), self.per) + tuple(requests.op.shape[1:]),
                dtype=torch.int32, device=requests.op.device)
        return states, _unpack(self.gather(packed, axis=1))


class ShardedHeap:
    """R ranks x C cores of independent heaps behind one ``[R, C, T]``
    entry point.

    ``mesh=False`` folds the rank axis onto the core axis on one device,
    so results equal `MultiCoreHeap`'s per (rank, core). ``mesh=None``
    (the default) builds the rank mesh over the process group
    (`make_rank_mesh`: the fold without one); a 1-D `DeviceMesh` of
    processes is used as given: each process holds and steps its own
    ``[R/d, C, ...]`` slice (``self.state``), and `step` takes the global
    request, which every process builds alike, and returns the global
    response (`RankShard`). With ``donate`` (the default) each round
    updates the state in place; without it the round works on a copy and
    the old state tensors are left as they were. The builders' ``active``
    mask is ``[R]`` or ``[R, C]`` (or a scalar): it selects ranks or
    cores, never thread slots."""

    def __init__(self, cfg, num_ranks: int, num_cores: int, mesh=None,
                 axis_name: str = "ranks", prepopulate: bool = True,
                 donate: bool = True, device="cuda"):
        self.cfg = cfg
        self.num_ranks = num_ranks
        self.num_cores = num_cores
        self.device = _device.resolve(device)
        self._step, self.mesh = sharded_inner(cfg, num_ranks, mesh=mesh,
                                              axis_name=axis_name)
        self.shard = (None if self.mesh is None
                      else RankShard(self.mesh, num_ranks))
        local = num_ranks if self.shard is None else self.shard.count
        self.state = sharded_init(cfg, local, num_cores,
                                  prepopulate=prepopulate,
                                  device=self.device)
        self.donate = donate

    @property
    def num_threads(self) -> int:
        return self.cfg.num_threads

    @property
    def shape(self) -> tuple:
        """(R, C, T): one slot per hardware thread in the fleet."""
        return (self.num_ranks, self.num_cores, self.cfg.num_threads)

    def step(self, request: AllocRequest) -> AllocResponse:
        """Serve an ``[R, C, T]`` request batch; advances the state."""
        request = AllocRequest(*(_i32(x, self.device) for x in request))
        state = self.state if self.donate else _clone(self.state)
        self.state, resp = self._step(state, request)
        return resp

    def _grid_mask(self, active):
        """An ``[R]`` or ``[R, C]`` mask as ``[R, C, 1]``: it masks ranks
        or cores, never thread slots."""
        if active is None:
            return None
        m = torch.as_tensor(active, dtype=torch.bool, device=self.device)
        m = m.reshape(m.shape + (1,) * (2 - m.dim()))
        return torch.broadcast_to(
            m, (self.num_ranks, self.num_cores)).reshape(
                self.num_ranks, self.num_cores, 1)

    def _vv(self, build, *args, active=None):
        args = [_i32(a, self.device) for a in args]
        return self.step(build(*args, active=self._grid_mask(active)))

    def malloc(self, sizes, active=None) -> AllocResponse:
        return self._vv(malloc_request, sizes, active=active)

    def free(self, ptrs, active=None) -> AllocResponse:
        return self._vv(free_request, ptrs, active=active)

    def realloc(self, ptrs, sizes, active=None) -> AllocResponse:
        return self._vv(realloc_request, ptrs, sizes, active=active)

    def calloc(self, nmemb, sizes, active=None) -> AllocResponse:
        return self._vv(calloc_request, nmemb, sizes, active=active)
