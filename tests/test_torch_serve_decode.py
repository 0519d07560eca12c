"""The port's decode-serving engine (`repro_torch.launch.serve_decode` over
`repro_torch.launch.serving.ScanEngine`) against the reference, on the CPU.

`DecodeServe.plan` is host numpy drawing from the same seeded generator
in the same order, so it must equal the reference's plan field by field;
a whole session at the ``fig_decode`` smoke config must equal the
reference's ``mesh=False`` report on every field (hwsw, and fused against
pallas) and, through the reference's own benchmark code, the two
``fig_decode`` rows of BENCH_BASELINE.json (read, never written). A
session run in segments equals one run; a core's exported slice replays
bit for bit. The tolerance is exact equality, 1e-12 relative against the
committed rows.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import system as jsys
from repro.launch import serve_decode as jsd

from repro_torch.core import heap, system
from repro_torch.launch import serve_decode as tsd
from repro_torch.launch import serving
from repro_torch.workloads import replay

BASELINE = Path(__file__).resolve().parents[1] / "BENCH_BASELINE.json"
T = 4
HEAP = 1 << 20
REF_KIND = {"fused": "pallas"}
# the fig_decode smoke config (benchmarks/fig_decode.py)
SMOKE = dict(seed=29, rounds=32, session_rate=1.5, num_tenants=16,
             max_context=576, queue_cap=16)


def _cfg(kind, mod=system):
    return mod.SystemConfig(kind=kind, heap_bytes=HEAP, num_threads=T)


def _engine(kind="hwsw", R=2, C=2, placement="least_loaded", **traffic):
    return tsd.DecodeServe(_cfg(kind), R, C,
                           traffic=tsd.DecodeTraffic(**traffic),
                           placement=placement, device="cpu")


def _plans_equal(got, want):
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("placement,traffic", [
    ("least_loaded", dict(SMOKE)),
    # overload: drops, head-of-line blocking, stalls, overflow evictions
    ("round_robin", dict(seed=3, rounds=40, session_rate=6.0, num_tenants=6,
                         max_context=144, queue_cap=4)),
    ("chunked", dict(seed=1, rounds=24, session_rate=2.0, num_tenants=9,
                     decode_choices=(0, 8, 120), queue_cap=8)),
])
def test_plan_matches_reference_field_by_field(placement, traffic):
    got = _engine(placement=placement, **traffic).plan()
    want = jsd.DecodeServe(_cfg("hwsw", jsys), 2, 2,
                           traffic=jsd.DecodeTraffic(**traffic),
                           placement=placement, mesh=False).plan()
    _plans_equal(got, want)
    assert got.dispatched > 0


@pytest.mark.parametrize("kind", ["hwsw", "fused"])
def test_session_matches_reference_report(kind):
    got = tsd.serve_decode_session(_cfg(kind), 2, 2,
                                   traffic=tsd.DecodeTraffic(**SMOKE),
                                   device="cpu")
    want = jsd.serve_decode_session(_cfg(REF_KIND.get(kind, kind), jsys),
                                    2, 2, traffic=jsd.DecodeTraffic(**SMOKE),
                                    mesh=False)
    assert got == want
    assert got["conservation_residual"] == 0 and got["decode_tokens"] > 0


def test_sessions_reproduce_the_fig_decode_baseline_rows(monkeypatch):
    """The reference's own fig_decode benchmark code over the port (kind
    ``pallas`` served by ``fused``) gives the two committed rows."""
    from benchmarks import fig_decode

    def config(kind, **kw):
        return system.SystemConfig(kind={"pallas": "fused"}.get(kind, kind),
                                   **kw)

    def session(cfg, R, C, traffic, mesh):
        return tsd.serve_decode_session(cfg, R, C, traffic=traffic,
                                        mesh=mesh, device="cpu")

    monkeypatch.setattr(fig_decode, "sysm",
                        types.SimpleNamespace(SystemConfig=config))
    monkeypatch.setattr(fig_decode, "DecodeTraffic", tsd.DecodeTraffic)
    monkeypatch.setattr(fig_decode, "serve_decode_session", session)
    got = {r["name"]: r for r in fig_decode.bench(smoke=True)}
    rows = json.loads(BASELINE.read_text())["figs"]["fig_decode"]["records"]
    assert len(rows) == 2 and set(got) == {r["name"] for r in rows}
    for row in rows:
        rec = got[row["name"]]
        assert (rec["derived"], rec["backend"]) == (row["derived"],
                                                    row["backend"])
        for key, want in row.items():
            if isinstance(want, float) and key != "wall_s":
                assert rec[key] == pytest.approx(want, rel=1e-12, abs=0), \
                    (row["name"], key)


def test_run_segment_in_pieces_equals_one_run():
    eng = _engine("fused", **SMOKE)
    plan = eng.plan()
    state, resps = eng.run(plan)
    st = heap.sharded_init(eng.cfg, 2, 2, device="cpu")
    slots = eng.new_slots(plan.rounds)
    pieces = []
    for r0, r1 in ((0, 5), (5, 6), (6, 20), (20, plan.rounds)):
        grids = tuple(g[r0:r1] for g in (plan.op, plan.size, plan.ptr_ref,
                                         plan.ptr_raw))
        st, slots, seg = eng.run_segment(st, slots, r0, grids)
        pieces.append(seg)
    for f, whole in zip(heap.AllocResponse._fields, resps):
        assert torch.equal(torch.cat([getattr(p, f) for p in pieces]),
                           whole), f
    for a, b in zip(serving.fleet_health(eng.cfg, st, 2, 2).items(),
                    serving.fleet_health(eng.cfg, state, 2, 2).items()):
        assert a == b


@pytest.mark.parametrize("kind", ["hwsw", "fused"])
def test_decode_trace_export_replays_bit_for_bit(kind):
    """The hottest tenant's core slice replays through `replay.replay` to
    that core's serve responses; its arrays equal the reference's export."""
    eng = _engine(kind, **SMOKE)
    plan = eng.plan()
    _, resps = eng.run(plan)
    rank, core = plan.tenant_home[0]
    tape = eng.trace(plan, rank, core)
    assert tape.meta["workload"] == "llm-decode-paged-kv"
    got, _, report = replay.replay(tape, kind, device="cpu")
    for f, served in zip(heap.AllocResponse._fields, resps):
        assert torch.equal(getattr(got, f), served[:, rank, core]), f
    assert report["telemetry"]["conservation_residual"] == 0
    jeng = jsd.DecodeServe(_cfg(REF_KIND.get(kind, kind), jsys), 2, 2,
                           traffic=jsd.DecodeTraffic(**SMOKE), mesh=False)
    want = jeng.trace(jeng.plan(), rank, core)
    assert dict(tape.to_json(), recorded_kind=want.recorded_kind) == \
        want.to_json()


def test_engine_refuses_a_mesh_and_an_unknown_placement():
    for mesh in (object(), "ranks"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            tsd.DecodeServe(_cfg("fused"), 2, 2, mesh=mesh, device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            serving.ScanEngine(_cfg("fused"), 2, 2, mesh=mesh, device="cpu")
    for mesh in (False, None):
        assert serving.ScanEngine(_cfg("fused"), 2, 2, mesh=mesh,
                                  device="cpu").mesh is None
    with pytest.raises(ValueError, match="unknown placement"):
        _engine(placement="nope")


def test_traffic_is_validated():
    for bad in (dict(rounds=0), dict(zipf_a=1.0), dict(queue_cap=0),
                dict(session_rate=-1.0), dict(max_context=100)):
        with pytest.raises(ValueError):
            tsd.DecodeTraffic(**bad)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsd.DecodeServe(_cfg("fused"), 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsd.serve_decode_session(_cfg("fused"), 2, 2)
