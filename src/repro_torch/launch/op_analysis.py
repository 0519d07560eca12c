"""Op-level accounting of a recorded call: FLOPs, memory bytes, collective
bytes and live bytes, for the roofline analysis.

The counterpart of `repro.launch.hlo_analysis`, which re-derives
loop-scaled totals from optimized HLO text. The port's program is the op
sequence one call runs (`repro_torch.analysis.trace_utils.record`, on real
tensors or on `FakeTensorMode` ones), so a Python loop is already
unrolled: every op is counted as often as it ran, and the reference's
trip-count multipliers have nothing left to scale.

  * FLOPs: 2 * prod(result) * K for ``mm`` / ``bmm`` / ``addmm`` /
    ``baddbmm`` (what ``matmul``, ``linear`` and ``einsum`` decompose into;
    K the contracted length) and 2 * prod(result) * (in-channels / groups
    * prod(kernel)) for a convolution; the attention kernels' operators by
    their two products: ``repro_torch::paged_attention`` 4 B H D over the
    page table's P * page positions (what its plain version computes;
    seq_lens are data), ``repro_torch::flash_attention`` 4 B H hd over the
    (query, key) pairs its causal mask and window leave.
  * memory bytes: 2x the bytes of every buffer an op produces (one write,
    about one read by its consumer): the results on storages it
    allocated, and for an in-place op the bytes it writes (an
    ``index_put_`` / ``scatter`` its values, else the written view). Views,
    ``expand`` and ``transpose`` allocate nothing in eager PyTorch and so
    count nothing, as the reference leaves broadcasts out.
  * collective bytes: the result bytes of every ``_c10d_functional``
    collective (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single``, ``broadcast``; the reference
    counts result buffers too), of DTensor's
    ``_dtensor::shard_dim_alltoall`` and of every in-place ``c10d`` one,
    by op and by the process group it ran over (a mesh axis where the
    caller names the groups, `repro_torch.launch.mesh.mesh_axes`); a
    ``wait_tensor`` counts nothing. None on one card.
  * live bytes: the recorder's argument, output and peak bytes (arguments
    plus every storage the call allocated and had not yet freed), the
    counterparts of ``compiled.memory_analysis()``.
"""
from __future__ import annotations

import math
from collections import defaultdict

from ..analysis.trace_utils import iter_ops

_MATMUL = {"mm": "self", "bmm": "self", "addmm": "mat1",
           "baddbmm": "batch1", "addbmm": "batch1"}
_CONV = ("convolution", "_convolution", "convolution_backward")
_COLLECTIVE_NS = ("_c10d_functional::", "c10d::",
                  "_c10d_functional_autograd::", "_dtensor::")
# collective op names in those namespaces (functional, in-place c10d, and
# DTensor's own all-to-all between two sharded dimensions, which it runs
# on a "cuda" mesh)
_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                "broadcast", "allreduce", "allgather", "alltoall",
                "_allgather", "_reduce_scatter", "shard_dim_alltoall")
_UPDATE_ARG = {"index_put_": "values", "index_put": "values",
               "_index_put_impl_": "values", "scatter_": "src",
               "scatter": "src", "scatter_add_": "src",
               "scatter_reduce_": "src", "index_copy_": "source",
               "index_add_": "source"}


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs flash attention computes: query row i sees key
    j when j <= i (causal, absolute positions) and i - j < window (when
    window > 0)."""
    if not causal and not window:
        return S * T
    total = 0
    for i in range(S):
        hi = min(i + 1, T) if causal else T
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _conv_flops(op) -> int:
    a = op.args
    if op.kind == "convolution_backward":
        w, out = a["weight"], a["grad_output"]
        per = math.prod(w.shape[1:])
        n = sum(1 for m in a.get("output_mask", (True,) * 3)[:2] if m)
        return 2 * math.prod(out.shape) * per * n
    w = a["weight"]
    return 2 * math.prod(op.outputs[0].shape) * math.prod(w.shape[1:])


def op_flops(op) -> int:
    """FLOPs of one recorded op (0 for anything but products)."""
    k = op.kind
    if k in _MATMUL and op.outputs:
        k_len = op.args[_MATMUL[k]].shape[-1]
        return 2 * math.prod(op.outputs[0].shape) * k_len
    if k in _CONV and op.outputs:
        return _conv_flops(op)
    if op.name == "repro_torch::paged_attention":
        B, H, D = op.args["q"].shape
        _, page, _, _ = op.args["k_pages"].shape
        P = op.args["page_table"].shape[1]
        return 4 * B * H * D * P * page
    if op.name == "repro_torch::flash_attention":
        B, S, H, hd = op.args["q"].shape
        T = op.args["k"].shape[1]
        return 4 * B * H * hd * attention_pairs(
            S, T, op.args["causal"], op.args["window"])
    return 0


def op_bytes(op) -> int:
    """Bytes of the buffers one op produces (see the module docstring)."""
    n = sum(tv.nbytes for tv in op.fresh)
    upd = _UPDATE_ARG.get(op.kind)
    if upd is not None and hasattr(op.args.get(upd), "nbytes"):
        return n + op.args[upd].nbytes
    return n + sum(tv.nbytes for tv in op.writes)


def _collective(op) -> bool:
    return op.name.startswith(_COLLECTIVE_NS) and \
        op.kind.startswith(_COLLECTIVES)


def collective_axis(op, axes=None) -> str:
    """What a recorded collective ran over: the mesh axis `axes` (process
    group name -> axis name) gives its group, else ``"group of N"``."""
    name = op.args.get("group_name", op.args.get("process_group"))
    name = getattr(name, "group_name", name)
    if axes and name in axes:
        return axes[name]
    size = op.args.get("group_size")
    if size is None:
        try:
            import torch.distributed as dist
            size = dist.distributed_c10d._resolve_process_group(
                name).size()
        except (KeyError, RuntimeError, ValueError):
            return f"group {name}"       # a group of a world now gone
    return f"group of {size}"


def analyze(recording, axes=None) -> dict:
    """Totals over a recording's top-level ops (a kernel node counts as
    its operator, not as its plain version's ops); `axes` names the
    collectives' groups (`collective_axis`)."""
    flops = mem = coll = 0
    coll_ops = defaultdict(int)
    coll_axes = defaultdict(int)
    by_class = defaultdict(int)
    nodes = defaultdict(int)
    n = 0
    for op, _ in iter_ops(recording.ops, descend=False):
        n += 1
        f = op_flops(op)
        if f:
            cls = ("matmul" if op.kind in _MATMUL else "conv"
                   if op.kind in _CONV else "attention kernels")
            by_class[cls] += f
            flops += f
        if op.name.startswith("repro_torch::"):
            nodes[op.name] += 1
        if _collective(op):
            b = sum(tv.nbytes for tv in op.outputs)
            coll += b
            coll_ops[op.kind] += b
            coll_axes[collective_axis(op, axes)] += b
        mem += 2 * op_bytes(op)
    return {
        "flops": flops,
        "flops_by_class": dict(by_class),
        "memory_bytes": mem,
        "collective_bytes": coll,
        "collective_bytes_by_op": dict(coll_ops),
        "collective_bytes_by_axis": dict(coll_axes),
        "argument_bytes": recording.argument_bytes,
        "output_bytes": recording.output_bytes,
        "peak_bytes": recording.peak_bytes,
        "kernel_nodes": dict(nodes),
        "n_ops": n,
    }


def collective_schedule(recording, limit: int = 40, axes=None):
    """(op, result shape, axis, times, bytes) of the recorded collectives,
    the largest traffic first (ties by op, axis and shape); `axes` names
    their groups (`collective_axis`)."""
    seen = defaultdict(int)
    for op, _ in iter_ops(recording.ops, descend=False):
        if _collective(op):
            shape = tuple(tv.shape for tv in op.outputs)
            seen[(op.kind, shape, collective_axis(op, axes),
                  sum(tv.nbytes for tv in op.outputs))] += 1
    out = [{"op": k, "shape": s, "axis": a, "times": t, "bytes": b}
           for (k, s, a, b), t in seen.items()]
    out.sort(key=lambda d: (-d["bytes"] * d["times"], d["op"], d["axis"],
                            str(d["shape"])))
    return out[:limit]
