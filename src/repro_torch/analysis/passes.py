"""The `pimcheck` checker passes: rule sets over recorded allocator rounds.

The port of `repro.analysis.passes`. Each pass is a function ``(traced,
ctx) -> [Finding]`` over a `TracedStep`: the recorded ops of one backend
round (`trace_utils.record`) plus the round's state and request leaves.
The rules are calibrated against the port's real kinds: every registered
kind records green on every tier, while the seeded broken mini-backends in
`repro_torch.analysis.fixtures` are flagged, each by its own pass; both
directions are pinned by tests/test_torch_analysis.py.

Passes
------
  donation     the state is updated in place: every state leaf comes back
               as its input leaf or a view of its storage, the (shape,
               dtype) multiset is unchanged, and no state leaf of 64 or
               more elements is re-made by a factory op (``zeros``,
               ``full``, ``empty``, ``*_like``): a dropped in-place update
               is a fresh allocation every round. An input leaf never read
               and never returned is a warning.
  int-width    pointer/size arithmetic stays 32-bit. Torch indexes with
               int64, so an int64 value may only feed the index operand of
               an indexing op (``.long()``, ``arange``, ``argsort``,
               ``argmax`` outputs used as indices); int64 on a state or
               response leaf or in any other arithmetic is an error, as is
               float64 anywhere, an int -> float -> int chain, and an
               int32 product of two request-derived values that no
               division checks (the `total_calloc_bytes` idiom).
  index-bounds every gather / index / scatter / index_put / index_select /
               take whose index is request-derived needs a bounding op in
               its provenance (clamp, minimum, maximum, remainder,
               bitwise_and, a comparison or other boolean, ``where`` with
               an untainted fallback, arange / sort / argsort / argmax).
               Torch checks every eager index, and on the card a failed
               check is a device-side assert that ends the process.
  write-race   a non-commutative write (``index_put_`` without
               accumulate, ``scatter`` without a reduction,
               ``index_copy_``) whose indices are request-derived, carry a
               thread axis of length >= 2 (a dimension of the request's
               thread count T) and have no disjointness witness (an index
               from ``arange`` / ``argsort`` / ``sort`` that runs along
               that axis): two threads can write one address in one
               round. The port's serialized mutex order is a Python loop
               over threads whose writes carry one thread's ``[C]`` slice:
               no thread axis, so nothing to flag; ``arange(C)`` indexes
               the core axis and witnesses nothing about threads.

The passes descend into a kernel node's plain version (`Op.sub`): on the
card the ``fused`` kind records one ``repro_torch::heap_step`` node a
round, and the passes check it through the ops of `protocol_round`.
"""
from __future__ import annotations

import dataclasses
import fnmatch

import torch

from .trace_utils import (derives_from, forward_taint, iter_ops, producers,
                          sig)

PASS_NAMES = ("donation", "int-width", "index-bounds", "write-race")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str
    target: str      # backend kind or fixture name
    tier: str        # single | vmap | sharded
    severity: str    # error | warn
    message: str

    def fmt(self) -> str:
        return (f"[{self.pass_name}] {self.target}/{self.tier} "
                f"{self.severity}: {self.message}")


# --------------------------------------------------------------------------
# suppressions: (pass, target glob, message substring, justification). A
# suppressed finding is reported but does not fail pimcheck; every entry
# must say why the hazard is acceptable. Empty, as the reference's is.
# --------------------------------------------------------------------------
SUPPRESSIONS = ()


def suppression_for(f: Finding):
    for pass_name, target_glob, substr, reason in SUPPRESSIONS:
        if (f.pass_name == pass_name
                and fnmatch.fnmatch(f.target, target_glob)
                and substr in f.message):
            return reason
    return None


@dataclasses.dataclass
class TracedStep:
    """One recorded backend round + its calling convention."""

    target: str          # kind / fixture name
    tier: str            # single | vmap | sharded
    recording: object    # trace_utils.Recording
    state_in: list       # TV of each state leaf as the round got it
    req_in: list         # TV of each request leaf
    state_out: list      # TV of each state leaf the round returned
    resp_out: list       # TV of each response leaf

    @property
    def ops(self):
        return self.recording.ops

    @property
    def threads(self) -> int:
        return self.req_in[0].shape[-1]


# --------------------------------------------------------------------------
# taint / guard vocabulary (calibrated on the port's kinds)
# --------------------------------------------------------------------------
# a result of these is bounded however wild the operands
_BOUND_OPS = frozenset({
    "clamp", "clamp_", "clamp_min", "clamp_min_", "clamp_max", "clamp_max_",
    "clip", "clip_", "minimum", "maximum", "remainder", "remainder_",
    "fmod", "fmod_", "bitwise_and", "bitwise_and_", "__and__", "__iand__",
    "bitwise_right_shift", "__rshift__", "__irshift__", "arange", "sort",
    "argsort", "argmax", "argmin", "amax", "amin", "max", "min",
    "searchsorted", "bucketize",
})
_DISJOINT_OPS = frozenset({"arange", "argsort", "sort"})
_DIV_OPS = frozenset({"div", "div_", "floor_divide", "floor_divide_",
                      "__floordiv__"})
_FACTORIES = frozenset({
    "zeros", "ones", "full", "empty", "empty_strided", "zeros_like",
    "ones_like", "full_like", "empty_like", "new_zeros", "new_ones",
    "new_full", "new_empty", "new_empty_strided", "scalar_tensor",
})
_INT64 = (torch.int64, torch.uint64)


def _index_operands(op):
    """(indexed tensor, [index TVs]) of an indexing op, or None."""
    a, k = op.args, op.kind
    if k in ("index", "index_put", "index_put_", "_index_put_impl_",
             "_unsafe_index", "_unsafe_index_put"):
        return a.get("self"), [i for i in a.get("indices", ()) if i]
    if k in ("gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_select", "take",
             "index_copy", "index_copy_", "index_add", "index_add_",
             "index_fill", "index_fill_", "index_reduce", "index_reduce_"):
        return a.get("self"), [a["index"]]
    if k == "embedding":
        return a.get("weight"), [a["indices"]]
    return None


def _non_commutative_write(op) -> bool:
    k = op.kind
    if k in ("index_put", "index_put_", "_index_put_impl_",
             "_unsafe_index_put"):
        return not op.args.get("accumulate", False)
    if k in ("scatter", "scatter_"):
        return op.args.get("reduce") is None
    return k in ("index_copy", "index_copy_")


def _is_bounding(op, tainted) -> bool:
    k = op.kind
    if k in _BOUND_OPS:
        return True
    outs = op.outputs or op.writes
    if outs and all(tv.dtype == torch.bool for tv in outs):
        return True   # comparisons, masks, any / all: {0, 1}
    conv = _conversion(op)
    if conv is not None and conv[0] == torch.bool:
        return True
    if k == "where":
        # `where(valid, expr, fallback)` with an untainted (or scalar)
        # fallback bounds the result: the masked-write / parked-index idiom
        return any(not hasattr(d, "val") or d.val not in tainted
                   for d in (op.args.get("self"), op.args.get("other")))
    return False


def _request_taint(tr: TracedStep):
    """Values data-derived from the request leaves with no bounding op in
    between (kernel nodes through their plain versions)."""
    return forward_taint(tr.ops, [tv.val for tv in tr.req_in],
                         kill_fn=_is_bounding)


# --------------------------------------------------------------------------
# pass: donation
# --------------------------------------------------------------------------
_BIG_LEAF = 64  # elements; below this a copy is noise, not a donation bug


def check_donation(tr: TracedStep, _ctx=None):
    finds = []

    def f(sev, msg):
        finds.append(Finding("donation", tr.target, tr.tier, sev, msg))

    in_sigs = sorted(sig(tv) for tv in tr.state_in)
    out_sigs = sorted(sig(tv) for tv in tr.state_out)
    if in_sigs != out_sigs:
        gone = [s for s in in_sigs if s not in out_sigs]
        new = [s for s in out_sigs if s not in in_sigs]
        f("error", "state buffer multiset changed across the round: "
          f"dropped {gone}, introduced {new} — the state cannot be updated "
          "in place")

    in_storages = {tv.val[0] for tv in tr.state_in}
    creator = tr.recording.creator
    for i, tv in enumerate(tr.state_out):
        if tv.val[0] in in_storages or tv.numel < _BIG_LEAF:
            continue  # updated in place (or a view of an input), or small
        op = creator.get(tv.val[0])
        if op is not None and op.kind in _FACTORIES:
            f("error", f"state output leaf #{i} {sig(tv)} is re-made by "
              f"`{op.name}` — the input buffer is dropped and a fresh "
              "allocation is made every round")

    read = set()
    for op, _ in iter_ops(tr.ops):
        read.update(tv.val[0] for tv in op.inputs)
    out_storages = {tv.val[0] for tv in tr.state_out + tr.resp_out}
    for i, tv in enumerate(tr.state_in):
        if tv.numel >= _BIG_LEAF and tv.val[0] not in read \
                and tv.val[0] not in out_storages:
            f("warn", f"state input leaf #{i} {sig(tv)} is never read and "
              "never returned — dead state buffer")
    return finds


# --------------------------------------------------------------------------
# pass: int-width
# --------------------------------------------------------------------------
def _constants(tr: TracedStep) -> set:
    """Values computed from literals and masks alone (``where(mask, 2,
    3)``, ``arange``, a Python scalar's tensor): whatever their width, they
    cannot carry a pointer or a size."""
    const = set()
    for op, _ in iter_ops(tr.ops):
        if all(tv.val in const or tv.dtype == torch.bool
               for tv in op.inputs):
            const.update(tv.val for tv in op.results)
    return const


def _int64_misuse(tr: TracedStep):
    """(op, path) of every op that defines a non-constant int64 value
    reaching anything but an index operand (directly, or through ops
    whose results are all int64 and feed only index operands in turn);
    (None, ()) for each int64 state or response leaf."""
    uses = {}   # value -> [(op, used as an index)]
    for op, _ in iter_ops(tr.ops):
        idx = _index_operands(op)
        index_vals = {tv.val for tv in idx[1]} if idx else set()
        for tv in op.inputs:
            uses.setdefault(tv.val, []).append((op, tv.val in index_vals))
    leaves = {tv.val for tv in tr.state_out + tr.resp_out}
    const = _constants(tr)
    memo = {}

    def ok(val):
        if val in memo:
            return memo[val]
        memo[val] = True  # a view's value is its base's: already on the way
        good = val not in leaves
        for op, is_index in uses.get(val, ()):
            if not good:
                break
            if is_index or op.kind in _FACTORIES:
                continue  # an index, or *_like(x), which reads x's shape
            good = not op.host_read and all(
                o.dtype in _INT64 and ok(o.val)
                for o in op.outputs + op.writes)
        memo[val] = good
        return good

    bad = [(op, path) for op, path in iter_ops(tr.ops)
           if any(tv.dtype in _INT64 and tv.val not in const
                  and not ok(tv.val) for tv in op.results)]
    bad += [(None, ()) for tv in tr.state_out + tr.resp_out
            if tv.dtype in _INT64]
    return bad


def _conversion(op):
    """(source dtype, destination dtype) of a dtype conversion, or None."""
    if op.kind in ("copy_", "copy") and "src" in op.args:
        return op.args["src"].dtype, op.args["self"].dtype
    if op.kind in ("_to_copy", "to") and op.outputs:
        return op.args["self"].dtype, op.outputs[0].dtype
    return None


def check_int_width(tr: TracedStep, _ctx=None):
    finds = []

    def f(sev, msg):
        finds.append(Finding("int-width", tr.target, tr.tier, sev, msg))

    for op, path in iter_ops(tr.ops):
        if any(tv.dtype == torch.float64 for tv in op.inputs + op.outputs):
            f("error", f"64-bit float at `{op.name}` in "
              f"{'/'.join(path) or 'top level'} — allocator arithmetic "
              "must stay 32-bit")
    for op, path in _int64_misuse(tr):
        where = "a state or response leaf" if op is None else \
            f"`{op.name}` in {'/'.join(path) or 'top level'}"
        f("error", f"int64 value at {where} that feeds more than an index "
          "operand — pointer/size arithmetic must stay 32-bit")

    # int -> float -> int: pointers/sizes above 2^24 lose bits
    def is_int(dt):
        return not dt.is_floating_point and dt != torch.bool

    floaty = set()
    for op, _ in iter_ops(tr.ops):
        conv = _conversion(op)
        hot = any(tv.val in floaty for tv in op.inputs)
        if conv is not None and is_int(conv[0]) and \
                conv[1].is_floating_point:
            floaty.update(tv.val for tv in op.results)
        elif conv is not None and conv[0].is_floating_point and \
                is_int(conv[1]) and hot:
            f("error", "integer value routed through float and back "
              f"(int -> float -> int at `{op.name}`) — pointer/size bits "
              "above 2^24 are lost")
        elif hot:
            floaty.update(tv.val for tv in op.results)

    # unguarded products of two request-derived ints (calloc overflow
    # class): the product must feed a division check
    tainted = _request_taint(tr)
    div_guarded = set()
    for op, _ in iter_ops(tr.ops):
        if op.kind in _DIV_OPS:
            div_guarded.update(tv.val for tv in op.inputs)
    for op, _ in iter_ops(tr.ops):
        if op.kind not in ("mul", "mul_", "__mul__"):
            continue
        ins = op.inputs
        if len(ins) < 2 or not all(tv.val in tainted for tv in ins):
            continue
        outs = op.results or op.outputs
        if not outs or outs[0].dtype.is_floating_point \
                or outs[0].dtype == torch.bool:
            continue
        if any(tv.val in div_guarded for tv in outs):
            continue
        f("error", "int32 product of two request-derived values with no "
          "overflow guard — a division check on the product "
          "(total_calloc_bytes idiom) or a pre-clamp is required")
    return finds


# --------------------------------------------------------------------------
# pass: index-bounds
# --------------------------------------------------------------------------
def check_index_bounds(tr: TracedStep, _ctx=None):
    finds = []
    tainted = _request_taint(tr)
    for op, path in iter_ops(tr.ops):
        idx = _index_operands(op)
        if idx is None:
            continue
        base, indices = idx
        if not any(tv.dtype != torch.bool and tv.val in tainted
                   for tv in indices):
            continue  # constant, bounded or mask indices
        finds.append(Finding(
            "index-bounds", tr.target, tr.tier, "error",
            f"`{op.name}` in {'/'.join(path) or 'top level'} indexes "
            f"{sig(base) if base else '?'} with a request-derived index "
            "that has no bounding op (clamp/minimum/maximum/remainder/"
            "mask) in its provenance — an out-of-range request is a "
            "device-side assert on the card"))
    return finds


# --------------------------------------------------------------------------
# pass: write-race
# --------------------------------------------------------------------------
def _thread_axes(shape, T):
    return [d for d, n in enumerate(shape) if n == T]


def check_write_race(tr: TracedStep, _ctx=None):
    finds = []
    T = tr.threads
    if T < 2:
        return finds
    tainted = _request_taint(tr)
    prods = producers(tr.ops)

    def disjoint(tv, axes, shape):
        # an arange / argsort / sort index that runs along a thread axis
        pad = len(shape) - len(tv.shape)
        runs = any(d - pad >= 0 and tv.shape[d - pad] == T for d in axes)
        return runs and derives_from(
            tv.val, lambda o: o.kind in _DISJOINT_OPS, prods)

    for op, path in iter_ops(tr.ops):
        if not _non_commutative_write(op):
            continue
        base, indices = _index_operands(op)
        indices = [tv for tv in indices if tv.dtype != torch.bool]
        if not indices or not any(tv.val in tainted for tv in indices):
            continue  # indices not request-controlled
        shape = tuple(torch.broadcast_shapes(*(tv.shape for tv in indices)))
        axes = _thread_axes(shape, T)
        n = 1
        for d in shape:
            n *= d
        if not axes or n < 2:
            continue  # one update per core: the mutex loop's own writes
        if any(disjoint(tv, axes, shape) for tv in indices):
            continue  # provably distinct slots per thread
        finds.append(Finding(
            "write-race", tr.target, tr.tier, "error",
            f"non-commutative `{op.name}` in {'/'.join(path) or 'top level'}"
            f" of {n} updates over a thread axis into "
            f"{sig(base) if base else '?'} with request-derived indices and"
            " no disjointness witness (arange/argsort along the thread "
            "axis) — two threads can write the same address in one round, "
            "and the winner is write-order-defined"))
    return finds


ALL_PASSES = {
    "donation": check_donation,
    "int-width": check_int_width,
    "index-bounds": check_index_bounds,
    "write-race": check_write_race,
}


def run_passes(tr: TracedStep, passes=None):
    """Run the selected passes; returns (active, suppressed) finding
    lists, where suppressed entries are (finding, justification)."""
    active, suppressed = [], []
    for name in (passes or PASS_NAMES):
        for f in ALL_PASSES[name](tr):
            reason = suppression_for(f)
            if reason is None:
                active.append(f)
            else:
                suppressed.append((f, reason))
    return active, suppressed
