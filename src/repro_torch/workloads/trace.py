"""Allocation-trace tapes (schema ``pim-malloc-trace/v1``), digests and the
tape lint.

A tape is a fixed-shape sequence of protocol rounds captured from a real
allocation-heavy workload. Pointer operands are stored symbolically: each
FREE/REALLOC slot carries a ``ptr_ref``, the flat slot id ``round * T +
thread`` of the round that produced the pointer (-1 = use the raw recorded
value, e.g. NULL or a deliberately bogus pointer). Replay
(`repro_torch.workloads.replay`) resolves refs against the pointers the
backend under test returned. Committed tapes live in ``benchmarks/tapes/``
with per-kind ``expect`` digests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..core import heap

TRACE_SCHEMA = "pim-malloc-trace/v1"

# canonical dtype per AllocResponse field, in field order: digests must be
# byte-stable across platforms and frameworks
_RESP_DTYPES = {
    "ptr": np.int32, "ok": np.uint8, "path": np.int32, "moved": np.uint8,
    "latency_cyc": np.float32, "backend_cyc": np.float32,
    "meta_hits": np.int32, "meta_misses": np.int32, "dram_bytes": np.int32,
}
SEMANTIC_FIELDS = ("ptr", "ok", "path", "moved")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _canon(resp_stack, fields) -> bytes:
    return b"".join(
        np.ascontiguousarray(_host(getattr(resp_stack, f)),
                             _RESP_DTYPES[f]).tobytes()
        for f in fields)


def response_digest(resp_stack, semantic_only: bool = False) -> str:
    """sha256 over the stacked [R, T] response fields in canonical dtypes.

    ``semantic_only`` restricts to (ptr, ok, path, moved)."""
    fields = SEMANTIC_FIELDS if semantic_only else tuple(_RESP_DTYPES)
    return hashlib.sha256(_canon(resp_stack, fields)).hexdigest()


@dataclasses.dataclass
class Trace:
    """One recorded workload tape (all arrays int32[R, T])."""

    name: str
    heap_bytes: int
    num_threads: int
    recorded_kind: str
    description: str
    op: np.ndarray
    size: np.ndarray
    ptr_ref: np.ndarray   # producing slot id (round*T + thread), -1 = raw
    ptr_raw: np.ndarray   # concrete recorded pointer (debug / raw operand)
    expect: dict = dataclasses.field(default_factory=dict)  # per-kind digests
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def rounds(self) -> int:
        return int(self.op.shape[0])

    @property
    def ops(self) -> int:
        return int((self.op != 0).sum())

    @classmethod
    def from_json(cls, doc: dict) -> "Trace":
        if doc.get("schema") != TRACE_SCHEMA:
            raise ValueError(f"not a {TRACE_SCHEMA} document: "
                             f"{doc.get('schema')!r}")
        r = doc["rounds"]
        arrs = {k: np.asarray(r[k], np.int32)
                for k in ("op", "size", "ptr_ref", "ptr_raw")}
        shapes = {a.shape for a in arrs.values()}
        if len(shapes) != 1 or arrs["op"].ndim != 2:
            raise ValueError(f"malformed rounds arrays: shapes {shapes}")
        if arrs["op"].shape[1] != doc["num_threads"]:
            raise ValueError("rounds thread axis != num_threads")
        return cls(name=doc["name"], heap_bytes=doc["heap_bytes"],
                   num_threads=doc["num_threads"],
                   recorded_kind=doc["recorded_kind"],
                   description=doc.get("description", ""),
                   expect=doc.get("expect", {}), meta=doc.get("meta", {}),
                   **arrs)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(json.load(f))


def trace_lint(trace: Trace) -> list:
    """Machine-checkable well-formedness rules for a tape; returns
    human-readable findings (empty == clean). The reference's rules:

      ops        every op code is one of the protocol ops.
      refs       a ``ptr_ref`` names a slot of a strictly earlier round and
                 lies inside the tape.
      race-A     within one round, two threads must not operate on the
                 same pointer chain (a duplicate ``ptr_ref``): the outcome
                 of racing same-chain ops is round-order-defined UB across
                 backends.
      race-B     a suspect free-class op (raw pointer operand with no
                 producing slot) must not share a round with a
                 metadata-creating op (MALLOC / CALLOC / growing REALLOC).
      epoch      no small ref (a producer within the size classes,
                 ``meta.max_size_class``, default 2048) may survive an
                 EPOCH_RESET round: arena kinds retire it at round start.
    """
    errs = []
    op, size, ref = trace.op, trace.size, trace.ptr_ref
    raw = trace.ptr_raw
    R, T = op.shape
    known = (heap.OP_NOOP, heap.OP_MALLOC, heap.OP_FREE, heap.OP_REALLOC,
             heap.OP_CALLOC, heap.OP_EPOCH_RESET)
    bad_op = ~np.isin(op, known)
    for r, t in zip(*np.nonzero(bad_op)):
        errs.append(f"[lint:ops] round {r} thread {t}: unknown op code "
                    f"{int(op[r, t])}")

    has_ref = ref >= 0
    this_round_base = (np.arange(R) * T)[:, None]
    bad_ref = has_ref & ((ref >= this_round_base) | (ref >= R * T))
    for r, t in zip(*np.nonzero(bad_ref)):
        errs.append(f"[lint:refs] round {r} thread {t}: ptr_ref "
                    f"{int(ref[r, t])} does not name an earlier round's slot")

    creator = (op == heap.OP_MALLOC) | (op == heap.OP_CALLOC) | \
        ((op == heap.OP_REALLOC) & (size > 0))
    free_class = (op == heap.OP_FREE) | ((op == heap.OP_REALLOC) &
                                         (size <= 0))
    suspect = free_class & ~has_ref & (raw >= 0)
    for r in range(R):
        refs_r = ref[r][has_ref[r]]
        uniq, counts = np.unique(refs_r, return_counts=True)
        for s in uniq[counts > 1]:
            ts = [int(t) for t in np.nonzero(ref[r] == s)[0]]
            errs.append(f"[lint:race-A] round {r}: threads {ts} both operate "
                        f"on the chain produced at slot {int(s)} — "
                        "same-round pointer race (modeled UB)")
        if suspect[r].any() and creator[r].any():
            ts = [int(t) for t in np.nonzero(suspect[r])[0]]
            cs = [int(t) for t in np.nonzero(creator[r])[0]]
            errs.append(f"[lint:race-B] round {r}: suspect free-class ops on "
                        f"threads {ts} (raw pointer, no producing slot) race "
                        f"metadata-creating ops on threads {cs} — "
                        "same-round pointer race (modeled UB)")

    any_reset = (op == heap.OP_EPOCH_RESET).any(axis=1)
    if any_reset.any():
        cum = np.cumsum(any_reset)   # resets in rounds [0..r]
        max_class = int(trace.meta.get("max_size_class", 2048))
        for r, t in zip(*np.nonzero(has_ref & ~bad_ref)):
            s = int(ref[r, t])
            rs, ts = divmod(s, T)
            psize = int(size[rs, ts])
            # resets in (rs, r]: a reset applies at round start, before
            # that round's allocs, so the producer's own round does not
            # count
            if 0 < psize <= max_class and cum[r] - cum[rs] > 0:
                errs.append(
                    f"[lint:epoch] round {r} thread {t}: ref to slot {s} "
                    f"({psize} B, produced round {rs}) crosses an epoch "
                    "reset — arena-managed pointers do not survive a reset")
    return errs
