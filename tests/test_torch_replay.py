"""The committed tapes replayed through the port's ``fused`` kind on CPU.

Each tape's response stream must reproduce the reference's committed
``pallas`` digests (`digest_full` over all nine fields, float32 latencies
included, and `digest_sem`), its ok-op and dropped-free counts and its
live / high-water telemetry, with a conservation residual of 0. These are
JAX-free oracles: the same check runs on the card in chip_smoke.py.
"""
from pathlib import Path

import pytest

from repro_torch.workloads import replay, trace

TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")


@pytest.mark.parametrize("name", NAMES)
def test_tape_reproduces_committed_pallas_digests(name):
    tape = trace.Trace.load(str(TAPES / f"{name}.json"))
    resps, state, report = replay.replay(tape, "fused", device="cpu")
    assert replay.check_trace(tape, results={"fused": report}) == []
    assert report["digest_full"] == tape.expect["pallas"]["digest_full"]
    assert report["telemetry"]["conservation_residual"] == 0
    assert report["stats_dropped_frees"] == report["dropped_frees"]
    assert tuple(resps.ptr.shape) == tape.op.shape


def test_check_trace_reports_a_mismatch():
    tape = trace.Trace.load(str(TAPES / "decode_serve.json"))
    _, _, report = replay.replay(tape, "fused", device="cpu")
    report = dict(report, digest_sem="0" * 64)
    errs = replay.check_trace(tape, results={"fused": report})
    assert len(errs) == 1 and "digest_sem" in errs[0]
