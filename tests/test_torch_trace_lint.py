"""`workloads.trace.trace_lint` against the reference's, on the committed
tapes (clean) and on crafted bad tapes that break each rule: an unknown
op, refs to the same or a later round and past the tape, two threads on
one pointer chain in a round (race-A), a raw free racing an alloc
(race-B), a small pointer crossing an epoch reset (a big one may). The
findings must be the same strings, in the same order."""
from pathlib import Path

import numpy as np
import pytest

from repro.workloads import trace as jtrace

from repro_torch.workloads import trace as ttrace

TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")


def pair(op, size, ref, raw, meta=None):
    arrs = [np.asarray(a, np.int32) for a in (op, size, ref, raw)]
    kw = dict(name="crafted", heap_bytes=1 << 20,
              num_threads=arrs[0].shape[1], recorded_kind="sw",
              description="", meta=meta or {})
    return (jtrace.Trace(op=arrs[0], size=arrs[1], ptr_ref=arrs[2],
                         ptr_raw=arrs[3], **kw),
            ttrace.Trace(op=arrs[0].copy(), size=arrs[1].copy(),
                         ptr_ref=arrs[2].copy(), ptr_raw=arrs[3].copy(),
                         **kw))


@pytest.mark.parametrize("name", NAMES)
def test_committed_tapes_are_clean_on_both(name):
    path = str(TAPES / f"{name}.json")
    assert ttrace.trace_lint(ttrace.Trace.load(path)) == \
        jtrace.trace_lint(jtrace.Trace.load(path)) == []


CRAFTED = {
    "ops": ([[1, 9], [0, 0]], [[16, 0], [0, 0]], [[-1, -1], [-1, -1]],
            [[-1, -1], [-1, -1]], None),
    "refs": ([[1, 2], [2, 2]], [[16, 0], [0, 0]], [[-1, 0], [2, 7]],
             [[-1, 5], [5, 5]], None),
    "race-A": ([[1, 1], [2, 3]], [[16, 16], [0, 64]], [[-1, -1], [0, 0]],
               [[-1, -1], [0, 0]], None),
    "race-B": ([[1, 0], [2, 1]], [[16, 0], [0, 32]], [[-1, -1], [-1, -1]],
               [[-1, -1], [4096, -1]], None),
    "epoch": ([[1, 1], [5, 0], [2, 2]], [[16, 9000], [0, 0], [0, 0]],
              [[-1, -1], [-1, -1], [0, 1]], [[-1, -1], [-1, -1], [0, 64]],
              {"max_size_class": 2048}),
}


@pytest.mark.parametrize("rule", sorted(CRAFTED))
def test_crafted_tape_findings_match_reference(rule):
    op, size, ref, raw, meta = CRAFTED[rule]
    jt, tt = pair(op, size, ref, raw, meta)
    want = jtrace.trace_lint(jt)
    assert want and any(f"[lint:{rule}]" in e for e in want)
    assert ttrace.trace_lint(tt) == want
