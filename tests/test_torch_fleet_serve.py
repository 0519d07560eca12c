"""The port's closed-loop serving tier (`repro_torch.launch.serve_fleet`)
against the reference, on the CPU.

`SessionPlanner` is host numpy drawing from the same seeded generator in
the same order, so a session's plan must equal the reference's field by
field (three placements, overload, epoch mode), and a session's report
the reference's ``mesh=False`` report on every field, on ``sw`` (and its
overload config), ``hwsw``, ``fused`` (against ``pallas``) and ``arena``
in epoch mode, across the three placements. A
core's exported slice replays bit for bit and equals the reference's
export. Through the reference's own benchmark code over the port, the 4
``fleet_serve`` rows and the 9 ``fig_arena`` rows (its FleetServe expiry
lane and its graph_churn lane) of BENCH_BASELINE.json (read, never
written) reproduce within 1e-12 relative. The tolerance is otherwise
exact equality.
"""
import functools
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import system as jsys
from repro.launch import serve_fleet as jsf

from repro_torch.core import heap, system
from repro_torch.launch import serve_fleet as tsf
from repro_torch.workloads import replay, trace

BASELINE = Path(__file__).resolve().parents[1] / "BENCH_BASELINE.json"
T = 4
HEAP = 1 << 19
REF_KIND = {"fused": "pallas"}
TC = dict(seed=3, rounds=24, arrival_rate=8.0, num_tenants=10, queue_cap=32)
OVERLOAD = dict(seed=23, rounds=24, arrival_rate=48.0, num_tenants=8,
                queue_cap=8)  # fleet_serve's rule: 3 x capacity a round
# (kind, heap bytes, placement, traffic): every kind, placement and the
# overload config at least once
CASES = {
    "sw-least_loaded": ("sw", HEAP, "least_loaded", TC),
    "sw-overload": ("sw", HEAP, "least_loaded", OVERLOAD),
    "hwsw-round_robin": ("hwsw", HEAP, "round_robin",
                         dict(TC, arrival_rate=10.0)),
    "fused-chunked": ("fused", HEAP, "chunked", dict(TC, seed=5)),
    "arena-epoch": ("arena", 1 << 20, "round_robin",
                    dict(TC, arrival_rate=10.0, epoch_rounds=6)),
}
_CACHE = {}


def _cfg(kind, heap_bytes, mod=system):
    return mod.SystemConfig(kind=kind, heap_bytes=heap_bytes, num_threads=T)


def _engine(case, device="cpu"):
    kind, heap_bytes, placement, traffic = CASES[case]
    return tsf.FleetServe(_cfg(kind, heap_bytes), 2, 2,
                          traffic=tsf.TrafficConfig(**traffic),
                          placement=placement, device=device)


def _run(case):
    """(port plan, port responses, port report, reference engine,
    reference plan, reference report), one session each, cached."""
    if case not in _CACHE:
        kind, heap_bytes, placement, traffic = CASES[case]
        eng = _engine(case)
        plan = eng.plan()
        state, resps = eng.run(plan)
        jeng = jsf.FleetServe(_cfg(REF_KIND.get(kind, kind), heap_bytes,
                                   jsys), 2, 2,
                              traffic=jsf.TrafficConfig(**traffic),
                              placement=placement, mesh=False)
        jplan, jrep = jeng.serve()
        _CACHE[case] = (plan, resps, eng.report(plan, resps, state), jeng,
                        jplan, jrep)
    return _CACHE[case]


def _plans_equal(got, want):
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("placement,traffic", [
    ("round_robin", TC), ("least_loaded", TC), ("chunked", TC),
    ("least_loaded", OVERLOAD),
    ("chunked", dict(TC, epoch_rounds=5, zipf_a=2.2, free_frac=0.3))])
def test_plan_matches_reference_field_by_field(placement, traffic):
    got = tsf.FleetServe(_cfg("sw", HEAP), 2, 2, placement=placement,
                         traffic=tsf.TrafficConfig(**traffic),
                         device="cpu").plan()
    want = jsf.FleetServe(_cfg("sw", HEAP, jsys), 2, 2, placement=placement,
                          traffic=jsf.TrafficConfig(**traffic),
                          mesh=False).plan()
    _plans_equal(got, want)
    assert got.dispatched > 0


@pytest.mark.parametrize("case", list(CASES))
def test_session_matches_reference_plan_and_report(case):
    plan, _, rep, _, jplan, jrep = _run(case)
    _plans_equal(plan, jplan)
    assert rep == jrep
    assert rep["conservation_residual"] == 0 and rep["dispatched"] > 0
    # every external arrival is dropped, dispatched or still queued
    ext_left = rep["offered"] - rep["dropped"] - rep["external_dispatched"]
    assert 0 <= ext_left <= rep["backlog_end"]
    assert rep["ops"] == rep["accounting"]["ops"]
    if case == "arena-epoch":   # a reset round fills every slot
        assert rep["epoch_resets"] == 4 and rep["epoch_managed_allocs"] > 0
    else:
        assert rep["ops"] == rep["dispatched"] and "epoch_resets" not in rep
    if case == "sw-overload":
        assert rep["drop_rate"] > 0.5


@pytest.mark.parametrize("case", ["hwsw-round_robin", "fused-chunked",
                                  "arena-epoch"])
def test_core_slices_replay_bit_for_bit(case):
    """Each core's exported tape is lint clean, replays through
    `replay.replay` to that core's serve responses, and equals the
    reference's export of the same slice."""
    plan, resps, _, jeng, jplan, _ = _run(case)
    kind = CASES[case][0]
    checked = 0
    for rk in range(2):
        for ck in range(2):
            tape = _engine(case).trace(plan, rk, ck)
            want = jeng.trace(jplan, rk, ck)
            assert dict(tape.to_json(), recorded_kind=want.recorded_kind) \
                == want.to_json()
            assert trace.trace_lint(tape) == []
            if tape.ops == 0:
                continue
            got, _, rep = replay.replay(tape, kind, device="cpu")
            for f, served in zip(heap.AllocResponse._fields, resps):
                assert torch.equal(getattr(got, f), served[:, rk, ck]), f
            assert rep["telemetry"]["conservation_residual"] == 0
            checked += 1
    assert checked >= 2
    if case == "arena-epoch":
        assert tape.meta["epoch_rounds"] == 6


def test_tenants_are_sticky():
    plan = _run("hwsw-round_robin")[0]
    for k, (rk, ck) in plan.tenant_home.items():
        assert (plan.slot[plan.tenant == k] // T == rk * 2 + ck).all()


def _bench_config(kind, **kw):
    return system.SystemConfig(kind={"pallas": "fused"}.get(kind, kind),
                               **kw)


def _check_rows(fig, recs):
    rows = json.loads(BASELINE.read_text())["figs"][fig]["records"]
    got = {r["name"]: r for r in recs}
    assert set(got) == {r["name"] for r in rows}
    for row in rows:
        rec = got[row["name"]]
        assert rec.get("backend") == row.get("backend")
        if "wall" not in row["derived"]:
            assert rec["derived"] == row["derived"], row["name"]
        for key, want in row.items():
            if isinstance(want, float) and key != "wall_s":
                assert rec[key] == pytest.approx(want, rel=1e-12, abs=0), \
                    (row["name"], key)
    return len(rows)


def test_sessions_reproduce_the_fleet_serve_baseline_rows(monkeypatch):
    """benchmarks/fig_serve.py over the port: the 4 committed rows."""
    from benchmarks import fig_serve
    monkeypatch.setattr(fig_serve, "sysm", types.SimpleNamespace(
        SystemConfig=_bench_config))
    monkeypatch.setattr(fig_serve, "TrafficConfig", tsf.TrafficConfig)
    monkeypatch.setattr(fig_serve, "serve_session", functools.partial(
        tsf.serve_session, device="cpu"))
    assert _check_rows("fleet_serve", fig_serve.bench(smoke=True)) == 4


def test_sessions_reproduce_the_fig_arena_baseline_rows(monkeypatch):
    """benchmarks/fig_arena.py over the port: the expiry lane's three
    rows and claim, and the graph_churn lane's five."""
    from benchmarks import fig_arena
    monkeypatch.setattr(fig_arena, "sysm", types.SimpleNamespace(
        SystemConfig=_bench_config))
    monkeypatch.setattr(fig_arena, "TrafficConfig", tsf.TrafficConfig)
    monkeypatch.setattr(fig_arena, "FleetServe", functools.partial(
        tsf.FleetServe, device="cpu"))
    monkeypatch.setattr(fig_arena, "replay", functools.partial(
        replay.replay, device="cpu"))
    monkeypatch.setattr(fig_arena, "Trace", trace.Trace)
    assert _check_rows("fig_arena", fig_arena.bench(smoke=True)) == 9


def test_engine_refuses_a_mesh_a_placement_and_bad_traffic():
    cfg = _cfg("fused", HEAP)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsf.FleetServe(cfg, 2, 2, mesh=object(), device="cpu")
    assert tsf.FleetServe(cfg, 2, 2, mesh=None, device="cpu").mesh is None
    with pytest.raises(ValueError, match="unknown placement"):
        tsf.FleetServe(cfg, 2, 2, placement="nope", device="cpu")
    for bad in (dict(rounds=0), dict(zipf_a=1.0),
                dict(realloc_frac=0.6, free_frac=0.6),
                dict(epoch_rounds=-1), dict(epoch_max_class=0)):
        with pytest.raises(ValueError):
            tsf.TrafficConfig(**bad)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsf.FleetServe(_cfg("fused", HEAP), 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsf.serve_session(_cfg("fused", HEAP), 2, 2)
