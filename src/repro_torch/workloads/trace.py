"""Allocation-trace tapes (schema ``pim-malloc-trace/v1``) and digests.

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
