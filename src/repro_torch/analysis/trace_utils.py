"""Recording one call as an op graph, and the dataflow helpers the
`pimcheck` passes use over it.

The counterpart of `repro.analysis.jaxpr_utils`. The port has no
whole-round graph to trace: its rounds read values on the host (the
per-thread loops of the scan kinds, the wrapper of the heap kernel), so
`torch.fx` tracing stops at the first data-dependent branch. What takes
the jaxpr's place is the recorded op sequence of one call: `record` runs
the call eagerly under a `TorchDispatchMode` and keeps, for every aten op
and every kernel operator (`repro_torch.kernels._library`), its operands
and results as values.

A value is a storage and its version, ``(serial, version)``: views share
their base's storage, so reading a view reads its base's current value,
and an op that writes a tensor in place (its schema says ``Tensor(a!)``)
makes the next version of that storage. The recording holds metadata
only, never a tensor, so storages die when the call drops them, and the
recorder keeps the live bytes of what the call allocated (its peak, for
`repro_torch.launch.op_analysis`).

A kernel operator's node carries, with ``descend`` on and real tensors,
its plain version's ops under it (``Op.sub``) and the plain version's
values of its results (``Op.sub_out``), the way the reference descends
into a ``pallas_call`` body: the wrapper calls `_library.HOOK` just
before the operator, and the recorder runs the plain version there, on
the same inputs, so its ops are recorded as a CPU run records them.
Host reads (``aten::_local_scalar_dense``) are recorded as ops with
``host_read`` set; what the host then does with the number is not
seen.

On a mesh (``record(..., dtensor=True)``) the recording is one process's
program. An op on DTensors (or on the waiting wrappers of collective
results) is handed back to them, and what they run below it is recorded:
the local ops on this process's shards and the collectives
(``_c10d_functional::*`` and their ``wait_tensor``, or ``c10d::*`` in
place), whose process group is kept as its name. The ops DTensor runs at
the global shape only to learn an output's shape (its sharding
propagation) are not recorded. A DTensor argument or result counts as its
local tensor. Only such a recording touches DTensor's internals
(`_dtensor_as_live`), and it gives them back on exit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import _library


class TV(NamedTuple):
    """One tensor operand or result: its value and metadata."""

    val: tuple          # (storage serial, version)
    shape: tuple
    dtype: torch.dtype
    nbytes: int         # numel * itemsize of this (possibly viewing) tensor

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass
class Op:
    """One recorded op (or kernel node)."""

    name: str             # schema name, e.g. "aten::index_put_"
    args: dict            # schema argument name -> TV / [TV | None] / scalar
    inputs: tuple         # every tensor operand (TV), schema order
    outputs: tuple        # every returned tensor (TV)
    writes: tuple = ()    # new values of the arguments written in place
    fresh: tuple = ()     # results on storages the op allocated
    sub: list | None = None      # a kernel node's plain version's ops
    sub_out: tuple | None = None  # their values of `results`, in order
    host_read: bool = False

    @property
    def kind(self) -> str:
        """The name without its namespace: ``index_put_``."""
        return self.name.split("::", 1)[-1]

    @property
    def results(self) -> tuple:
        """The values the op defines: written arguments (schema order),
        then returned tensors that are not views of an operand."""
        seen = set(tv.val for tv in self.writes)
        rest = tuple(tv for tv in self.outputs if tv.val not in seen
                     and tv in self.fresh)
        return self.writes + rest


class Recording:
    """The ops of one call plus what the recorder learned about memory."""

    def __init__(self):
        self.ops: list[Op] = []
        self.arguments: list[TV] = []   # the call's tensor leaves, in order
        self.outputs: list[TV] = []     # its returned tensor leaves
        self.argument_bytes = 0         # unique storages of `arguments`
        self.output_bytes = 0           # returned storages it allocated
        self.peak_bytes = 0             # argument bytes + live allocations
        self.creator: dict = {}         # storage serial -> Op that made it


def _tvs(xs):
    """The TVs of recorded arguments (a TV, a list of them, or a scalar)."""
    for x in xs:
        if isinstance(x, TV):
            yield x
        elif isinstance(x, list):
            yield from _tvs(x)


def leaves(tree) -> list:
    """Tensor leaves of nested tuples, lists, NamedTuples and dicts."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


# DTensor's bookkeeping the recorder runs unrecorded: (module, class,
# attribute); the first must exist, the others where this torch has them
_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


def _not_tracing() -> bool:
    return False


def _wrappers() -> tuple:
    """The tensor subclasses whose ops are handed back (DTensor and the
    waiting wrapper of a functional collective's result): empty while
    `torch.distributed.tensor` is not imported, since then none exists."""
    if "torch.distributed.tensor" not in sys.modules:
        return ()
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    return DTensor, AsyncCollectiveTensor


def local(t: torch.Tensor) -> torch.Tensor:
    """The tensor an argument or result stands for on this process: a
    DTensor's local shard, a collective result's waited tensor, else
    `t`."""
    for _ in range(4):
        inner = getattr(t, "_local_tensor", None)
        if inner is None:
            inner = getattr(t, "elem", None)
        if not isinstance(inner, torch.Tensor):
            return t
        t = inner
    return t


def _group_name(x) -> str:
    """A process group's name (a ``c10d`` op takes the group as a
    script object)."""
    import torch.distributed as dist
    return dist.ProcessGroup.unbox(x).group_name


@contextlib.contextmanager
def _dtensor_as_live(rec):
    """While a DTensor recording runs (`Recorder` with ``dtensor``), let
    DTensor run as a live process runs it. Its bookkeeping runs unrecorded
    and on real tensors (with `FakeTensorMode` set aside): its sharding
    propagation, which runs the op at the global shape on fake tensors of
    its own to learn the output's shape and prices candidate placements,
    and the strided-shard arithmetic (index tensors read back to the
    host), which a fake tensor cannot answer. And it is told that it is
    not being traced: under `FakeTensorMode` it would take the compiler's
    paths, whose redistribution plans differ from the ones a live process
    runs. Everything patched is given back on exit, also on an error."""
    import importlib
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed import _functional_collectives as funcol
    tracing = funcol._are_we_tracing
    patched = []

    def quiet(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            rec._muted += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                rec._muted -= 1
        return run

    try:
        for mod in [m for n, m in sys.modules.items()
                    if n.startswith("torch.distributed")]:
            if getattr(mod, "_are_we_tracing", None) is tracing:
                patched.append((mod, "_are_we_tracing", tracing))
                mod._are_we_tracing = _not_tracing
        for i, (mod, cls, attr) in enumerate(_BOOKKEEPING):
            owner = getattr(importlib.import_module(mod), cls, None)
            raw = None if owner is None else owner.__dict__.get(attr)
            if raw is None:
                if i == 0:
                    raise RuntimeError("trace_utils: DTensor's sharding "
                                       "propagation is not where this "
                                       "recorder looks for it")
                continue
            kind = type(raw) if isinstance(raw, (staticmethod,
                                                 classmethod)) else None
            wrapped = quiet(raw.__func__ if kind else raw)
            patched.append((owner, attr, raw))
            setattr(owner, attr, kind(wrapped) if kind else wrapped)
        yield
    finally:
        while patched:
            setattr(*patched.pop())


class Recorder(TorchDispatchMode):
    """`TorchDispatchMode` that appends an `Op` for every dispatched op."""

    def __init__(self, descend: bool = True, dtensor: bool = False):
        super().__init__()
        self.rec = Recording()
        self.descend = descend
        self.dtensor = dtensor
        self._stack = [self.rec.ops]
        self._serial = {}     # id(storage object) -> serial
        self._version = {}    # serial -> current version
        self._fresh = {}      # serial -> bytes, storages the call allocated
        self._next = 0
        self._live = 0
        self._hook = None
        self._pending = None   # (operator, sub ops, their result values)
        self._handed = ()      # wrapper subclasses handed back
        self._muted = 0        # inside DTensor's bookkeeping
        self._undo = None      # what __exit__ gives back

    # ---- values ------------------------------------------------------------
    def _storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        serial = self._serial.get(key)
        if serial is None:
            serial = self._serial[key] = self._next
            self._next += 1
            self._version[serial] = 0
            weakref.finalize(st, self._dead, key, serial)
        return serial

    def _dead(self, key, serial):
        if self._serial.get(key) == serial:
            del self._serial[key]
        self._live -= self._fresh.pop(serial, 0)

    def tv(self, t: torch.Tensor) -> TV:
        s = self._storage(t)
        return TV((s, self._version[s]), tuple(t.shape), t.dtype,
                  t.numel() * t.element_size())

    def _conv(self, x):
        if isinstance(x, torch.Tensor):
            return self.tv(x)
        if isinstance(x, (list, tuple)):
            return [self._conv(y) for y in x]
        if isinstance(x, torch.ScriptObject) and \
                x._type().qualified_name().endswith("c10d.ProcessGroup"):
            return _group_name(x)
        return x

    # ---- a kernel operator's plain version ---------------------------------
    def __enter__(self):
        with contextlib.ExitStack() as undo:
            if self.descend:
                self._hook, _library.HOOK = _library.HOOK, self._plain
                undo.callback(setattr, _library, "HOOK", self._hook)
            if self.dtensor:
                self._handed = _wrappers()
                undo.enter_context(_dtensor_as_live(self))
            mode = super().__enter__()
            self._undo = undo.pop_all()
        return mode

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._undo.close()

    def _plain(self, name, args):
        """Record the operator's plain version, about to be launched on
        `args`, for the node that follows (real tensors only: a fake one
        has no data for the plain version's host reads)."""
        if any(isinstance(t, torch._subclasses.FakeTensor) for t in args):
            return
        sub = []
        self._stack.append(sub)
        try:
            plain = _library.PLAIN[name](*args)
        finally:
            self._stack.pop()
        self._pending = (name, sub, tuple(self.tv(t) for t in plain))

    # ---- the mode ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._handed and any(issubclass(t, self._handed) for t in types):
            # a DTensor op: what it runs on this process is recorded below
            return NotImplemented
        schema = func._schema
        name = schema.name
        if name.startswith("prim::") or self._muted:
            # metadata queries (a fake tensor's `.device`), DTensor's
            # bookkeeping: no op of the program runs
            return func(*args, **kwargs)
        named, written = {}, []
        for i, a in enumerate(schema.arguments):
            if i < len(args):
                v = args[i]
            elif a.name in kwargs:
                v = kwargs[a.name]
            else:
                continue
            named[a.name] = self._conv(v)
            if a.alias_info is not None and a.alias_info.is_write:
                written += [t for t in tree_flatten(v)[0]
                            if isinstance(t, torch.Tensor)]
        inputs = tuple(_tvs(named.values()))
        sub = sub_out = None
        if self._pending is not None and self._pending[0] == name:
            _, sub, sub_out = self._pending
            self._pending = None
        out = func(*args, **kwargs)
        for s in {self._storage(t) for t in written}:
            self._version[s] += 1
        writes = tuple(self.tv(t) for t in written)
        outputs, fresh = [], []
        op = Op(name=name, args=named, inputs=inputs, outputs=(),
                sub=sub, sub_out=sub_out,
                host_read=name == "aten::_local_scalar_dense")
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            known = id(t.untyped_storage()) in self._serial
            tv = self.tv(t)
            if not known:
                nb = t.untyped_storage().nbytes()
                self._fresh[tv.val[0]] = nb
                self._live += nb
                self.rec.creator[tv.val[0]] = op
                fresh.append(tv)
            outputs.append(tv)
        self.rec.peak_bytes = max(self.rec.peak_bytes,
                                  self.rec.argument_bytes + self._live)
        op.outputs, op.writes, op.fresh = tuple(outputs), writes, tuple(fresh)
        self._stack[-1].append(op)
        return out


def record(fn, *args, descend: bool = True, dtensor: bool = False,
           **kwargs):
    """Run ``fn(*args, **kwargs)`` under a `Recorder`; returns (Recording,
    result). The tensor leaves of `args` and `kwargs` are the call's
    arguments (their storages count as argument bytes; a DTensor's, its
    local shard's); the tensor leaves of the result its outputs. With
    `dtensor` the recording is one process's program on a mesh (module
    docstring)."""
    r = Recorder(descend=descend, dtensor=dtensor)
    rec = r.rec
    seen = set()
    for t in map(local, leaves((args, kwargs))):
        tv = r.tv(t)
        rec.arguments.append(tv)
        if tv.val[0] not in seen:
            seen.add(tv.val[0])
            rec.argument_bytes += t.untyped_storage().nbytes()
    rec.peak_bytes = rec.argument_bytes
    with r:
        result = fn(*args, **kwargs)
    outs = set()
    for t in map(local, leaves(result)):
        tv = r.tv(t)
        rec.outputs.append(tv)
        if tv.val[0] in r._fresh and tv.val[0] not in outs:
            outs.add(tv.val[0])
            rec.output_bytes += r._fresh[tv.val[0]]
    return rec, result


# ---------------------------------------------------------------------------
# dataflow helpers (the counterparts of jaxpr_utils')
# ---------------------------------------------------------------------------
def iter_ops(ops, path=(), descend=True):
    """Yield ``(op, path)`` for every op, recursively: a kernel node, then
    its plain version's ops with the node's name appended to ``path``."""
    for op in ops:
        yield op, path
        if descend and op.sub is not None:
            yield from iter_ops(op.sub, path + (op.name,), descend)


def producers(ops, descend=True) -> dict:
    """Map every value an op defines (`Op.results`) to that op."""
    out = {}
    for op, _ in iter_ops(ops, descend=descend):
        for tv in op.results:
            out[tv.val] = op
    return out


def forward_taint(ops, seeds, kill_fn=None, tainted=None) -> set:
    """Forward may-taint over the recorded order, from the values
    ``seeds``. An op for which ``kill_fn(op, tainted)`` is true bounds its
    results (taint stops there). A kernel node with its plain version's
    ops taints result i iff the plain version's value i is tainted; a node
    without them taints every result if any operand is tainted. Returns
    the set of tainted values."""
    tainted = set(seeds) if tainted is None else tainted
    for op in ops:
        if op.sub is not None:
            forward_taint(op.sub, (), kill_fn, tainted)
            for tv, plain in zip(op.results, op.sub_out):
                if plain.val in tainted:
                    tainted.add(tv.val)
            continue
        if kill_fn is not None and kill_fn(op, tainted):
            continue
        if any(tv.val in tainted for tv in op.inputs):
            tainted.update(tv.val for tv in op.results)
    return tainted


def derives_from(val, pred, prods, _seen=None) -> bool:
    """True iff an op in ``val``'s producer chain satisfies ``pred(op)``
    (backward search; a value no op defined ends the walk). Through a
    kernel node with its plain version the walk goes on from the plain
    version's value of the same result."""
    if _seen is None:
        _seen = set()
    if val in _seen:
        return False
    _seen.add(val)
    op = prods.get(val)
    if op is None:
        return False
    if pred(op):
        return True
    if op.sub is not None:
        for tv, plain in zip(op.results, op.sub_out):
            if tv.val == val:
                return derives_from(plain.val, pred, prods, _seen)
    return any(derives_from(tv.val, pred, prods, _seen) for tv in op.inputs)


def sig(tv: TV) -> tuple:
    """(shape, dtype) signature of a value, for donation matching."""
    return tv.shape, str(tv.dtype).replace("torch.", "")
