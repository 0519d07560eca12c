"""The committed tapes through the port's scan-based kinds on the CPU.

Each of ``strawman``, ``sw`` and ``hwsw`` must reproduce every tape's
committed ``expect`` block (`digest_full` over all nine response fields,
float32 latencies included, `digest_sem`, ok-op and dropped-free counts,
live / high-water telemetry) with a conservation residual of 0; the
cross-backend contract of `check_trace` (``fused`` == ``hwsw`` in full,
``sw`` == ``hwsw`` on the semantic fields) holds, and fails a doctored
mismatch. JAX-free oracles: the same checks run on the card in
chip_smoke.py.
"""
import copy
from pathlib import Path

import pytest

from repro_torch.core import heap
from repro_torch.workloads import replay, trace

TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")


def load(name):
    return trace.Trace.load(str(TAPES / f"{name}.json"))


@pytest.mark.parametrize("kind", ["strawman", "sw", "hwsw"])
@pytest.mark.parametrize("name", NAMES)
def test_tape_reproduces_committed_digests(name, kind):
    tape = load(name)
    resps, state, report = replay.replay(tape, kind, device="cpu")
    assert replay.check_trace(tape, results={kind: report}) == []
    assert report["digest_full"] == tape.expect[kind]["digest_full"]
    assert report["telemetry"]["conservation_residual"] == 0
    if kind == "strawman":
        assert "stats_dropped_frees" not in report
    else:
        assert report["stats_dropped_frees"] == report["dropped_frees"]
    assert tuple(resps.ptr.shape) == tape.op.shape


def test_kinds_in_registration_order():
    assert heap.kinds() == ("strawman", "sw", "hwsw", "sanitizer", "arena",
                            "tlregion", "fused")


def test_check_trace_holds_the_parity_pairs():
    """All seven kinds on one tape pass; a doctored sw digest that still
    matches its own (doctored) expect block fails only the semantic
    parity with hwsw, and a doctored fused digest the full parity."""
    tape = load("decode_serve")
    results = replay.replay_all_kinds(tape, device="cpu")
    assert tuple(results) == heap.kinds()
    reports = {k: rep for k, (_, rep) in results.items()}
    assert replay.check_trace(tape, results=reports) == []
    for kind, key, level in (("sw", "digest_sem", "semantic"),
                             ("fused", "digest_full", "full")):
        bad = copy.deepcopy(tape)
        reps = {k: dict(v) for k, v in reports.items()}
        reps[kind][key] = "0" * 64
        bad.expect[replay.EXPECT_KEY.get(kind, kind)][key] = "0" * 64
        errs = replay.check_trace(bad, results=reps)
        assert errs == [f"{tape.name}: {kind} != hwsw on {level} response "
                        "stream"], errs


def test_attach_expectations_rederives_the_committed_blocks():
    """In memory only: the tape object is a copy, no file is written."""
    tape = load("decode_serve")
    fresh = copy.deepcopy(tape)
    reports = replay.attach_expectations(fresh, device="cpu")
    assert set(reports) == set(heap.kinds())
    for kind in heap.kinds():
        key = replay.EXPECT_KEY.get(kind, kind)
        assert fresh.expect[key] == {
            k: tape.expect[key][k] for k in fresh.expect[key]}


def test_replay_main_checks_all_kinds(capsys):
    path = str(TAPES / "decode_serve.json")
    assert replay.main(["--check", "--device", "cpu", path]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[OK]")
    for kind in heap.kinds():
        assert f"decode_serve/{kind}:" in out
    assert replay.main(["--check", "--device", "cpu", "--kinds",
                        "strawman,sw", path]) == 0
