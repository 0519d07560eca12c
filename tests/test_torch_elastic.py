"""The port's elastic serving tier (`repro_torch.launch.elastic`) against
the reference, on the CPU.

The chaos matrix (``sw`` and ``hwsw`` x 2 seeds of kills, stalls, dropped
rounds and pressure-driven migration) must equal the reference's reports
on every field, plan grids included, with the tier's guarantees: per-core
conservation, no dropped expiry frees, a killed core dark after its kill,
a migrated tenant's destination slice a closed tape that replays bit for
bit. A snapshot restored mid-session finishes equal to the uninterrupted
run, on the same device and on another device object, and a snapshot the
reference wrote on ``hwsw`` finishes in the port equal to the reference's
run. With no faults and no migration the segmented session equals one
`FleetServe.serve()`. Through the reference's own benchmark code over the
port, the 3 ``fig_elastic`` rows of BENCH_BASELINE.json (read, never
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
from repro.launch import elastic as jel
from repro.launch import serve_fleet as jsf

from repro_torch.checkpoint import ckpt
from repro_torch.core import heap, system
from repro_torch.core.heap import OP_NOOP
from repro_torch.launch import elastic as tel
from repro_torch.launch import fleet
from repro_torch.launch import serve_fleet as tsf
from repro_torch.workloads import replay

BASELINE = Path(__file__).resolve().parents[1] / "BENCH_BASELINE.json"
T = 4
SHAPE = (2, 2, T)
HEAP = 1 << 17
CELLS = [(kind, seed) for kind in ("sw", "hwsw") for seed in (0, 1)]
SNAP_ROUND = 13


def _cfg(kind="sw", mod=system):
    return mod.SystemConfig(kind=kind, heap_bytes=HEAP, num_threads=T)


def _tc(mod=tsf, **kw):
    return mod.TrafficConfig(**dict(dict(seed=3, rounds=24,
                                         arrival_rate=6.0, num_tenants=8,
                                         queue_cap=32), **kw))


def _chaos_engine(kind, seed, mod=tel, device="cpu"):
    """The reference test suite's chaos cell, in either package."""
    ref = mod is jel
    fleet_mod = jsf if ref else tsf
    kw = dict(mesh=False) if ref else dict(device=device)
    return mod.ElasticFleetServe(
        _cfg(kind, jsys if ref else system), 2, 2,
        traffic=_tc(fleet_mod, seed=3 + seed), placement="chunked",
        faults=mod.FaultPlan.generate(seed=100 + seed, rounds=24,
                                      shape=SHAPE),
        migration=mod.MigrationConfig(ratio=1.2, min_bytes=256,
                                      drain="interval", check_rounds=6),
        **kw)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """chaos(kind, seed) -> (port engine, port plan, port report,
    reference plan, reference report, reference snapshot dir or None), one
    session each, cached. The reference's hwsw run of seed 0 writes a
    snapshot at round 13 on its way (reading the state changes nothing it
    computes)."""
    cache = {}

    def run(kind, seed):
        if (kind, seed) not in cache:
            eng = _chaos_engine(kind, seed)
            plan, rep = eng.serve()
            jeng = _chaos_engine(kind, seed, jel).start()
            snap = None
            if (kind, seed) == ("hwsw", 0):
                jeng.run_until(SNAP_ROUND)
                snap = tmp_path_factory.mktemp("ref_snapshot")
                jeng.snapshot(str(snap))
            jplan, jrep = jeng.finish()
            cache[kind, seed] = (eng, plan, rep, jplan, jrep, snap)
        return cache[kind, seed]

    return run


@pytest.mark.parametrize("kind,seed", CELLS)
def test_chaos_matches_reference(chaos, kind, seed):
    eng, plan, rep, jplan, jrep, _ = chaos(kind, seed)
    for f in ("op", "size", "ptr_ref", "ptr_raw", "slot", "disp_round",
              "enq_round"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)
    assert rep == jrep
    assert rep["conservation_residual"] == 0
    assert rep["dropped_frees"] == 0 and rep["expiry_frees_dispatched"] > 0
    assert rep["kills"]
    for ev in rep["faults"]:
        if ev["kind"] == tel.KILL:
            assert (plan.op[ev["round"]:, ev["rank"], ev["core"]]
                    == OP_NOOP).all()


def test_chaos_migrates_somewhere(chaos):
    assert any(chaos(kind, seed)[2]["migrations"] for kind, seed in CELLS)


@pytest.mark.parametrize("kind", ["sw", "hwsw"])
def test_migrated_tenant_tape_replays_bit_for_bit(chaos, kind):
    """The first migration's destination core slice is a closed tape: its
    replay reproduces that core's serve responses."""
    eng, plan, rep, *_ = next(chaos(kind, s) for s in (0, 1)
                              if chaos(kind, s)[2]["migrations"])
    rk, ck = rep["migrations"][0]["dst"]
    tape = eng.trace(plan, rk, ck)
    got, _, _ = replay.replay(tape, kind, device="cpu")
    served = eng._stacked()
    for f in heap.AllocResponse._fields:
        assert torch.equal(getattr(got, f), getattr(served, f)[:, rk, ck]), f


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_snapshot_restore_equals_clean_run(chaos, device, tmp_path):
    """Snapshot at round 13, restore into a fresh engine (given its device
    as a string and as another device object), finish: the plan and the
    report equal the uninterrupted run's."""
    _, plan_c, rep_c, *_ = chaos("hwsw", 0)
    a = _chaos_engine("hwsw", 0).start()
    a.run_until(SNAP_ROUND)
    path = Path(a.snapshot(str(tmp_path)))
    assert (path / "COMMITTED").exists() and (path / "host.json").exists()
    b = _chaos_engine("hwsw", 0, device=device)
    b.restore(str(tmp_path))
    assert b.r == SNAP_ROUND and b.device == torch.device("cpu")
    plan_b, rep_b = b.finish()
    np.testing.assert_array_equal(plan_c.op, plan_b.op)
    np.testing.assert_array_equal(plan_c.ptr_ref, plan_b.ptr_ref)
    assert rep_b == rep_c


def test_reference_snapshot_finishes_in_the_port(chaos):
    """A snapshot the reference's engine wrote at round 13 on hwsw,
    restored into the port's engine and finished there, gives the
    reference's uninterrupted report."""
    *_, jrep, snap = chaos("hwsw", 0)
    b = _chaos_engine("hwsw", 0)
    b.restore(str(snap))
    assert b.r == SNAP_ROUND
    _, rep = b.finish()
    assert rep == jrep


def test_restore_rejects_identity_mismatch_and_no_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        _chaos_engine("sw", 0).restore(str(tmp_path))
    a = _chaos_engine("sw", 0).start()
    a.run_until(7)
    a.snapshot(str(tmp_path))
    for wrong in (tel.ElasticFleetServe(_cfg(), 2, 2, traffic=_tc(seed=999),
                                        placement="chunked", device="cpu"),
                  tel.ElasticFleetServe(_cfg("hwsw"), 2, 2,
                                        traffic=_tc(seed=3),
                                        placement="chunked", device="cpu")):
        with pytest.raises(ValueError, match="identity"):
            wrong.restore(str(tmp_path))


@pytest.mark.parametrize("placement", ["chunked", "least_loaded"])
def test_no_faults_no_migration_equals_fleetserve(placement):
    cfg, tc = _cfg(), _tc()
    plan0, rep0 = tsf.FleetServe(cfg, 2, 2, traffic=tc, placement=placement,
                                 device="cpu").serve()
    plan1, rep1 = tel.ElasticFleetServe(cfg, 2, 2, traffic=tc,
                                        placement=placement,
                                        device="cpu").serve()
    for f in ("op", "size", "ptr_ref"):
        np.testing.assert_array_equal(getattr(plan0, f), getattr(plan1, f))
    for k in rep0:                          # rep1 adds the elastic extras
        assert rep0[k] == rep1[k], k


def test_kill_reinitialises_the_core_in_the_live_state():
    """A kill writes a fresh core into [rk, ck] of every leaf of the live
    state, in place; the other cores keep their state; the session ends
    with the core dark and the fleet conserved."""
    eng = tel.ElasticFleetServe(_cfg("hwsw"), 2, 2, traffic=_tc(),
                                placement="chunked", device="cpu").start()
    eng.run_until(10)
    def leaves(state, n):
        return [x.reshape((n,) + x.shape[2:])
                for x in ckpt._flatten(state).values()]

    before = leaves(heap._clone(eng.state), 4)
    ptrs = [x.data_ptr() for x in leaves(eng.state, 4)]
    eng._kill(0, 0, 10)
    after = leaves(eng.state, 4)
    assert [x.data_ptr() for x in after] == ptrs
    fresh = leaves(heap.sharded_init(eng.cfg, 1, 1, device="cpu"), 1)
    for a, b, f in zip(after, before, fresh):
        assert torch.equal(a[0], f[0]) and torch.equal(a[1:], b[1:])
    plan, rep = eng.finish()
    assert (plan.op[10:, 0, 0] == OP_NOOP).all()
    assert rep["killed_cores"] == [[0, 0]]
    assert rep["dropped_frees"] == 0 and rep["conservation_residual"] == 0


@pytest.mark.parametrize("fault", [
    tel.FaultEvent(9, tel.STALL, 0, 0), tel.FaultEvent(9, tel.DROP),
    tel.FaultEvent(10, tel.KILL, 0, 0)])
def test_fault_semantics(fault):
    """A stall idles one core for one round, a drop the whole fleet for
    one round, a kill one core for the rest of the session (its tenants
    re-homed); the never-droppable lane drops nothing either way."""
    plan, rep = tel.ElasticFleetServe(
        _cfg(), 2, 2, traffic=_tc(), placement="chunked", device="cpu",
        faults=tel.FaultPlan((fault,))).serve()
    r = fault.round
    if fault.kind == tel.DROP:
        assert (plan.op[r] == OP_NOOP).all()
        assert plan.dispatched_per_round[r] == 0
    else:
        assert (plan.op[r, 0, 0] == OP_NOOP).all()
        later = (plan.op[r + 1:, 0, 0] != OP_NOOP).any()
        assert later == (fault.kind == tel.STALL)
    if fault.kind == tel.KILL:
        (kill,) = rep["kills"]
        for k in kill["tenants_rehomed"]:
            assert tuple(plan.tenant_home[k]) != (0, 0)
    assert rep["dropped_frees"] == 0 and rep["conservation_residual"] == 0


def test_epoch_drain_arena_session():
    """Epoch-mode chaos on the arena frontend: decisions only at the epoch
    boundaries, conservation and the no-drop guarantee intact."""
    tc = _tc(epoch_rounds=6)
    cfg = system.SystemConfig(kind="arena", heap_bytes=HEAP, num_threads=T)
    _, rep = tel.ElasticFleetServe(
        cfg, 2, 2, traffic=tc, placement="chunked", device="cpu",
        faults=tel.FaultPlan.generate(seed=11, rounds=24, shape=SHAPE,
                                      kills=1, stalls=1, drops=0),
        migration=tel.MigrationConfig(ratio=1.2, min_bytes=256,
                                      drain="epoch")).serve()
    assert rep["conservation_residual"] == 0 and rep["dropped_frees"] == 0
    assert rep["epoch_resets"] > 0
    assert {p["round"] for p in rep["pressure"]} == set(
        fleet.drain_epoch(tc, 0))


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_fault_plans_match_reference_and_round_trip(seed):
    got = tel.FaultPlan.generate(seed=seed, rounds=32, shape=SHAPE, kills=2,
                                 stalls=2, drops=1)
    want = jel.FaultPlan.generate(seed=seed, rounds=32, shape=SHAPE,
                                  kills=2, stalls=2, drops=1)
    assert got.to_json() == want.to_json()
    assert tel.FaultPlan.from_json(want.to_json()) == got
    assert len(got.validate(SHAPE, 32).events) == 5
    assert got.kill_rounds() == want.kill_rounds()


def test_fault_plans_and_migration_configs_are_validated():
    with pytest.raises(ValueError, match="round"):
        tel.FaultPlan((tel.FaultEvent(40, tel.DROP),)).validate(SHAPE, 32)
    with pytest.raises(ValueError, match="core"):
        tel.FaultPlan((tel.FaultEvent(3, tel.KILL, 7, 0),)).validate(SHAPE,
                                                                      32)
    with pytest.raises(ValueError, match="once"):
        tel.FaultPlan((tel.FaultEvent(3, tel.KILL, 0, 0),
                       tel.FaultEvent(5, tel.KILL, 0, 0))).validate(SHAPE,
                                                                    32)
    with pytest.raises(ValueError, match="fault kind"):
        tel.FaultEvent(3, "melt")
    with pytest.raises(ValueError, match="not enough rounds"):
        tel.FaultPlan.generate(seed=0, rounds=4, shape=SHAPE)
    with pytest.raises(ValueError, match="migration policy"):
        tel.MigrationConfig(policy="teleport")
    with pytest.raises(ValueError, match="drain"):
        tel.MigrationConfig(drain="sometimes")
    with pytest.raises(ValueError, match="plans its own session"):
        tel.ElasticFleetServe(_cfg(), 2, 2, device="cpu").serve(plan=object())


def test_storms_reproduce_the_fig_elastic_baseline_rows(monkeypatch):
    """benchmarks/fig_elastic.py over the port: the 3 committed rows."""
    from benchmarks import fig_elastic
    monkeypatch.setattr(fig_elastic, "sysm", types.SimpleNamespace(
        SystemConfig=system.SystemConfig))
    monkeypatch.setattr(fig_elastic, "TrafficConfig", tsf.TrafficConfig)
    monkeypatch.setattr(fig_elastic, "MigrationConfig", tel.MigrationConfig)
    monkeypatch.setattr(fig_elastic, "ElasticFleetServe", functools.partial(
        tel.ElasticFleetServe, device="cpu"))
    got = {r["name"]: r for r in fig_elastic.bench(smoke=True)}
    rows = json.loads(BASELINE.read_text())["figs"]["fig_elastic"]["records"]
    assert len(rows) == 3 and set(got) == {r["name"] for r in rows}
    for row in rows:
        rec = got[row["name"]]
        assert rec["derived"] == row["derived"]
        for key, want in row.items():
            if isinstance(want, float) and key != "wall_s":
                assert rec[key] == pytest.approx(want, rel=1e-12, abs=0), \
                    (row["name"], key)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tel.ElasticFleetServe(_cfg(), 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tel.serve_elastic(_cfg(), 2, 2)
