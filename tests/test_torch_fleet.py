"""The port's fleet tier (`repro_torch.launch.fleet`) and the serving
engines' report helpers (`repro_torch.launch.serving`) against the
reference, on the CPU.

Placements, tenant homing, the migration and drain policies, scatter and
gather, and `FleetRouter` over the port's `ShardedHeap` are held to the
reference's on its one-device path (``mesh=False``: its mesh path fails
here, ROADMAP C); `fleet_health`'s one batched pass to the reference's
per-core sweep; and, through the reference's own benchmark code over the
port, the 8 ``fig_fleet`` rows of BENCH_BASELINE.json (read, never
written) within 1e-12 relative. Inputs are numpy-seeded; the tolerance is
otherwise exact equality of every field (float32 latencies bit for bit).
"""
import dataclasses
import functools
import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import system as jsys
from repro.launch import fleet as jfleet
from repro.launch import serving as jserving

from repro_torch.core import heap, system
from repro_torch.launch import fleet, serving

BASELINE = Path(__file__).resolve().parents[1] / "BENCH_BASELINE.json"
T = 4
HEAP = 1 << 19
SHAPE = (2, 2, T)
CAP = 2 * 2 * T
REF_KIND = {"fused": "pallas"}


def _cfgs(kind):
    return (system.SystemConfig(kind=kind, heap_bytes=HEAP, num_threads=T),
            jsys.SystemConfig(kind=REF_KIND.get(kind, kind), heap_bytes=HEAP,
                              num_threads=T))


def _stream(n, seed):
    rng = np.random.RandomState(n + seed)
    return (rng.choice([heap.OP_MALLOC, heap.OP_FREE, heap.OP_REALLOC,
                        heap.OP_CALLOC], n).astype(np.int32),
            rng.randint(0, 1 << 14, n).astype(np.int32),
            rng.randint(-1, 1 << 16, n).astype(np.int32),
            rng.rand(SHAPE[0], SHAPE[1]))


@pytest.mark.parametrize("n", [0, 1, CAP - 1, CAP])
@pytest.mark.parametrize("placement", sorted(fleet.PLACEMENTS))
def test_scatter_gather_match_reference(n, placement):
    op, size, ptr, loads = _stream(n, 17)
    slots = fleet.PLACEMENTS[placement](n, SHAPE, loads=loads, start=3)
    np.testing.assert_array_equal(
        slots, jfleet.PLACEMENTS[placement](n, SHAPE, loads=loads, start=3))
    got = fleet.scatter_slots(op, size, ptr, SHAPE, slots, device="cpu")
    want = jfleet.scatter_slots(op, size, ptr, SHAPE, slots)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == SHAPE
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a response whose every field is its grid slot id: gather inverts
    ids = np.arange(CAP).reshape(SHAPE)
    resp = heap.AllocResponse(*(torch.from_numpy(ids.astype(np.int32))
                                for _ in heap.AllocResponse._fields))
    out = fleet.gather_slots(resp, slots)
    jout = jfleet.gather_slots(jheap.AllocResponse(
        *(jnp.asarray(ids, jnp.int32) for _ in heap.AllocResponse._fields)),
        slots)
    for f in heap.AllocResponse._fields:
        np.testing.assert_array_equal(out[f], slots)
        np.testing.assert_array_equal(out[f], jout[f])
    flat = fleet.gather_flat(resp, n)
    np.testing.assert_array_equal(flat["ptr"], np.arange(n))
    req = fleet.scatter_flat(op, size, ptr, SHAPE, device="cpu")
    np.testing.assert_array_equal(req.op.numpy().reshape(-1)[:n], op)


def test_policies_match_reference():
    loads = np.array([[4.0, 2.0], [9.0, 1.0]])
    for policy in fleet.PLACEMENTS:
        for i in range(9):
            for kw in ({}, {"loads": loads}, {"expected_tenants": 8}):
                assert fleet.tenant_core(policy, i, SHAPE, **kw) == \
                    jfleet.tenant_core(policy, i, SHAPE, **kw), (policy, kw)
    with pytest.raises(ValueError, match="unknown placement"):
        fleet.tenant_core("nope", 0, SHAPE)
    pressure = {"hottest_rank": 1}
    homes = {0: (1, 0), 1: (1, 1), 2: (0, 0), 3: (1, 1)}
    tb = {0: 64, 1: 4096, 3: 4096}
    for name in fleet.MIGRATIONS:
        for dead in (frozenset(), frozenset({(0, 1)})):
            for mm in (1, 2, 3):
                assert fleet.MIGRATIONS[name](
                    pressure, homes, tb, loads, SHAPE, dead=dead,
                    max_moves=mm) == jfleet.MIGRATIONS[name](
                        pressure, homes, tb, loads, SHAPE, dead=dead,
                        max_moves=mm)

    @dataclasses.dataclass
    class Traffic:
        rounds: int = 40
        epoch_rounds: int = 0

    for name in fleet.DRAINS:
        for tc in (Traffic(), Traffic(epoch_rounds=8)):
            assert fleet.DRAINS[name](tc, 6) == jfleet.DRAINS[name](tc, 6)


def test_scatter_rejects_over_capacity_and_bad_slots():
    z = np.zeros(CAP + 1, np.int32)
    with pytest.raises(ValueError, match="capacity"):
        fleet.scatter_flat(z, z, z, SHAPE, device="cpu")
    z2 = np.zeros(2, np.int32)
    for slots, msg in (([1, 1], "duplicate"), ([0, CAP], "out of range"),
                       ([0], "slots")):
        with pytest.raises(ValueError, match=msg):
            fleet.scatter_slots(z2, z2, z2, SHAPE, np.array(slots),
                                device="cpu")


@pytest.mark.parametrize("kind", ["hwsw", "fused"])
def test_router_matches_reference_mesh_false(kind):
    """Flat streams through every placement (frees pinned to the producing
    round's slots), a pre-batched round, the stats and the load signal."""
    tcfg, jcfg = _cfgs(kind)
    router = fleet.FleetRouter(heap.ShardedHeap(tcfg, 2, 2, mesh=False,
                                                device="cpu"))
    jrouter = jfleet.FleetRouter(jheap.ShardedHeap(jcfg, 2, 2, mesh=False))
    rng = np.random.RandomState(5)
    for placement in ("chunked", "round_robin", "least_loaded"):
        n = int(rng.randint(1, CAP + 1))
        sizes = rng.choice([16, 100, 2048, 3000, 8192], n).astype(np.int32)
        args = (np.full(n, heap.OP_MALLOC, np.int32), sizes,
                np.full(n, -1, np.int32))
        got = router.route_flat(*args, placement=placement)
        want = jrouter.route_flat(*args, placement=placement)
        np.testing.assert_array_equal(got["slots"], want["slots"])
        for f in heap.AllocResponse._fields:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        free = (np.full(n, heap.OP_FREE, np.int32), np.zeros(n, np.int32),
                got["ptr"])
        if placement == "least_loaded":
            with pytest.raises(ValueError, match="stateful"):
                router.route_flat(*free, placement=placement)
        g2 = router.route_flat(*free, placement=placement,
                               slots=got["slots"])
        w2 = jrouter.route_flat(*free, placement=placement,
                                slots=want["slots"])
        assert g2["ok"].all()
        for f in heap.AllocResponse._fields:
            np.testing.assert_array_equal(g2[f], w2[f], err_msg=f)
    sizes = rng.choice([16, 512, 4096], SHAPE).astype(np.int32)
    got = router.route(heap.malloc_request(torch.from_numpy(sizes)))
    want = jrouter.route(jheap.malloc_request(jnp.asarray(sizes)))
    for f in heap.AllocResponse._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert router.stats == jrouter.stats
    assert router.rounds == jrouter.rounds == 7
    assert router.capacity == CAP
    np.testing.assert_array_equal(router.core_loads, jrouter.core_loads)


@pytest.mark.parametrize("kind", ["strawman", "arena", "fused"])
def test_fleet_health_matches_reference_sweep(kind):
    """One batched pass over every core == the reference's per-core
    `telemetry.snapshot` sweep (live, residual, per-rank HWM, frag)."""
    tcfg, jcfg = _cfgs(kind)
    th = heap.ShardedHeap(tcfg, 2, 3, mesh=False, device="cpu")
    jh = jheap.ShardedHeap(jcfg, 2, 3, mesh=False)
    rng = np.random.RandomState(11)
    for _ in range(3):
        sizes = rng.choice([0, 16, 300, 2048, 5000, 40000],
                           (2, 3, T)).astype(np.int32)
        r = th.malloc(torch.from_numpy(sizes))
        jh.malloc(jnp.asarray(sizes))
        keep = rng.rand(2, 3, T) < 0.5
        drop = np.where(keep, -1, r.ptr.numpy())
        th.free(torch.from_numpy(drop))
        jh.free(jnp.asarray(drop))
    got = serving.fleet_health(tcfg, th.state, 2, 3)
    assert got == jserving.fleet_health(jcfg, jh.state, 2, 3)
    assert got["conservation_residual"] == 0 and got["live_bytes"] > 0


def test_report_helpers_match_reference():
    rng = np.random.RandomState(3)
    lat = rng.rand(6, 2, 2, T).astype(np.float32) * 1000
    for a, b in zip(serving.round_barrier_cum(lat),
                    jserving.round_barrier_cum(lat)):
        np.testing.assert_array_equal(a, b)
    for x in (lat.reshape(-1), np.zeros(0)):
        assert serving.pct(x) == jserving.pct(x)
    for rounds, e in ((10, 0), (10, 3), (9, 9)):
        np.testing.assert_array_equal(serving.epoch_boundaries(rounds, e),
                                      jserving.epoch_boundaries(rounds, e))


def test_routers_reproduce_the_fig_fleet_baseline_rows(monkeypatch):
    """benchmarks/fig_fleet.py over the port (`FleetRouter` over the
    port's `ShardedHeap` on the CPU, kind ``pallas`` served by ``fused``,
    its jnp calls by their torch counterparts): the 8 committed rows
    within 1e-12 relative (their wall-clock fields aside)."""
    from benchmarks import fig_fleet

    def config(kind, **kw):
        return system.SystemConfig(
            kind={"pallas": "fused"}.get(kind, kind), **kw)

    monkeypatch.setattr(fig_fleet, "sysm", types.SimpleNamespace(
        SystemConfig=config))
    monkeypatch.setattr(fig_fleet, "FleetRouter", fleet.FleetRouter)
    monkeypatch.setattr(fig_fleet, "heap_api", types.SimpleNamespace(
        ShardedHeap=functools.partial(heap.ShardedHeap, device="cpu"),
        malloc_request=heap.malloc_request, free_request=heap.free_request,
        realloc_request=heap.realloc_request))
    monkeypatch.setattr(fig_fleet, "jnp", types.SimpleNamespace(
        asarray=torch.as_tensor, arange=torch.arange, where=torch.where,
        broadcast_to=torch.broadcast_to,
        roll=lambda x, shift, axis: torch.roll(x, shift, dims=axis)))
    got = {r["name"]: r for r in fig_fleet.bench(smoke=True)}
    rows = json.loads(BASELINE.read_text())["figs"]["fig_fleet"]["records"]
    assert len(rows) == 8 and set(got) == {r["name"] for r in rows}
    for row in rows:
        rec = got[row["name"]]
        assert rec.get("backend") == row.get("backend")
        for key, want in row.items():
            if isinstance(want, float) and not key.startswith("wall"):
                assert rec[key] == pytest.approx(want, rel=1e-12, abs=0), \
                    (row["name"], key)
