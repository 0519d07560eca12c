"""Elastic FleetServe: pressure-driven migration, fault injection,
snapshot/restore.

The port of `repro.launch.elastic`. Million-user traffic is not stationary
and hardware is not immortal; this module wraps
:class:`repro_torch.launch.serve_fleet.FleetServe` into the serving tier
that survives both, without giving up the repo's core currency — bitwise
determinism:

  * **Live tenant migration.** At drain points (epoch boundaries by
    default — Temp blocks die at the reset for free, so a moving tenant
    drags no epoch state along) the engine reads the fleet's
    `HeapTelemetry` high-water marks (`telemetry.fleet_pressure`: one
    device-to-host copy a decision round, none in between). When
    per-rank HWMs diverge past `MigrationConfig.ratio`
    (`telemetry.hwm_divergence`), a migration policy
    (`fleet.MIGRATIONS`) picks tenants and destinations, and the planner
    drains each block with a FREE on its source core and replays a MALLOC
    of it on the destination — re-binding the block's producing slot so
    every later op follows it. Each core's session slice stays a closed
    tape: the migrated tenant's destination slice replays bit for bit
    through `repro_torch.workloads.replay`.

  * **Fault injection.** A :class:`FaultPlan` is a deterministic,
    seed-generated schedule of core kills (the heap state slice is
    re-initialized in place mid-session and every block that lived there
    is re-placed through the migration path), transient stalls (a core
    accepts no dispatch for one round; its queued work waits a barrier)
    and dropped rounds (nothing dispatches fleet-wide). The expiry-free
    lane is never droppable: frees whose block died with a core wait for
    the replay MALLOC to re-bind the slot, then dispatch, so
    ``dropped_frees == 0`` under every schedule.

  * **Snapshot / restore.** `snapshot()` checkpoints a mid-session engine
    through `repro_torch.checkpoint.ckpt` — heap state, slot file, planned
    grids and responses-so-far in the npz/manifest format, the host-side
    planner (rng mid-stream state, queues, ledgers) in a JSON sidecar, in
    the reference's layout and leaf names. `ElasticFleetServe.restore`
    rebuilds an engine that finishes the session bit for bit like the
    uninterrupted run, also onto another device (card <-> CPU: each leaf
    is placed on the restoring engine's device), from a snapshot the
    reference wrote on a kind both packages share, and across a rank mesh
    of processes: a snapshot taken on the mesh is the reference's one set
    of whole-fleet files (gathered to process 0, which writes them), and
    a restore gives each process of a mesh its own rank slice, so a
    session snapshotted on the mesh finishes on one device, and the other
    way round, bit for bit like the uninterrupted run.

Execution model: the session runs as `ScanEngine.run_segment` segments
split exactly at decision rounds (kills + drain points). The round body is
shared with the one-shot run, and the slot file + round offset are carried
across segments, so with no faults and no migrations the segmented session
equals `FleetServe.serve()` bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import torch

from ..checkpoint import ckpt
from ..core import heap as heap_api
from ..core import telemetry
from ..core.heap import AllocResponse
from ..parallel import comm
from . import fleet
from .serve_fleet import FleetServe, SessionPlanner, TrafficConfig
from .serving import SessionPlan

KILL, STALL, DROP = "kill", "stall", "drop"


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: kill/stall a (rank, core) or drop a round."""

    round: int
    kind: str                      # "kill" | "stall" | "drop"
    rank: int = -1                 # unused for "drop"
    core: int = -1

    def __post_init__(self):
        if self.kind not in (KILL, STALL, DROP):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.round < 0:
            raise ValueError(f"fault at round {self.round} < 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule (a tuple of :class:`FaultEvent`).

    Schedules are data: `generate` derives one from a seed, `to_json` /
    `from_json` round-trip it exactly, and the same plan + the same
    traffic seed always produces the same report and tapes.
    """

    events: tuple = ()

    def validate(self, shape: tuple, rounds: int):
        R, C, _ = shape
        for ev in self.events:
            if ev.round >= rounds:
                raise ValueError(f"fault at round {ev.round} >= {rounds}")
            if ev.kind != DROP and not (0 <= ev.rank < R
                                        and 0 <= ev.core < C):
                raise ValueError(f"fault core {(ev.rank, ev.core)} outside "
                                 f"[{R}, {C}]")
        kills = [(ev.rank, ev.core) for ev in self.events if ev.kind == KILL]
        if len(set(kills)) != len(kills):
            raise ValueError("a core can only be killed once")
        return self

    def at(self, r: int, kind: str):
        return [ev for ev in self.events
                if ev.round == r and ev.kind == kind]

    def stalled_at(self, r: int):
        return [(ev.rank, ev.core) for ev in self.at(r, STALL)]

    def is_dropped(self, r: int) -> bool:
        return bool(self.at(r, DROP))

    def kill_rounds(self):
        return sorted({ev.round for ev in self.events if ev.kind == KILL})

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(ev) for ev in self.events])

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls(tuple(FaultEvent(**d) for d in json.loads(s)))

    @classmethod
    def generate(cls, seed: int, rounds: int, shape: tuple, kills: int = 1,
                 stalls: int = 1, drops: int = 1,
                 min_round: int = 2) -> "FaultPlan":
        """Seed-derived schedule: distinct fault rounds in
        [min_round, rounds), kill cores drawn without replacement."""
        R, C, _ = shape
        n = kills + stalls + drops
        if n == 0:
            return cls()
        rng = np.random.default_rng(seed)
        span = rounds - min_round
        if span < n:
            raise ValueError(f"not enough rounds for {n} faults")
        rnds = min_round + rng.choice(span, size=n, replace=False)
        cores = rng.choice(R * C, size=max(kills, 1), replace=False)
        events = []
        for i in range(kills):
            events.append(FaultEvent(int(rnds[i]), KILL,
                                     int(cores[i]) // C, int(cores[i]) % C))
        for i in range(stalls):
            rc = int(rng.integers(R * C))
            events.append(FaultEvent(int(rnds[kills + i]), STALL,
                                     rc // C, rc % C))
        for i in range(drops):
            events.append(FaultEvent(int(rnds[kills + stalls + i]), DROP))
        return cls(tuple(sorted(events, key=lambda e: (e.round, e.kind))))


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """When and how the elastic tier moves tenants.

    ``ratio``/``min_bytes`` feed `telemetry.hwm_divergence`; ``policy`` /
    ``drain`` name entries in `fleet.MIGRATIONS` / `fleet.DRAINS`
    (registering a new policy there is the whole integration);
    ``check_rounds`` paces the ``interval`` drain policy; ``max_moves``
    bounds tenants moved per decision.
    """

    ratio: float = 2.0
    min_bytes: int = 4096
    policy: str = "hottest_tenant"
    drain: str = "epoch"
    check_rounds: int = 8
    max_moves: int = 1

    def __post_init__(self):
        if self.policy not in fleet.MIGRATIONS:
            raise ValueError(f"unknown migration policy {self.policy!r} "
                             f"(have {tuple(fleet.MIGRATIONS)})")
        if self.drain not in fleet.DRAINS:
            raise ValueError(f"unknown drain policy {self.drain!r} "
                             f"(have {tuple(fleet.DRAINS)})")


class ElasticFleetServe(FleetServe):
    """FleetServe that migrates under pressure, survives injected faults,
    and checkpoints/resumes mid-session (see module docstring), on
    `device` (the card unless the caller asks for the CPU).

    Incremental API (``serve()`` wraps it for one-shot use)::

        eng = ElasticFleetServe(cfg, 2, 2, traffic=tc, faults=fp,
                                migration=MigrationConfig())
        eng.start()
        eng.run_until(32)                  # rounds [0, 32)
        path = eng.snapshot(ckpt_dir)      # mid-session checkpoint
        eng.run_until(tc.rounds)
        plan, report = eng.finish()

        eng2 = ElasticFleetServe(...same identity, any device...)
        eng2.restore(ckpt_dir)             # back at round 32
        eng2.run_until(tc.rounds)          # finishes bit for bit alike

    The session's responses stay on the device, one stacked tensor a
    segment, until `finish` reports them (one copy to the host) or
    `snapshot` writes them.
    """

    def __init__(self, cfg, num_ranks: int, num_cores: int,
                 traffic: TrafficConfig = None,
                 placement: str = "round_robin", mesh=False,
                 faults: FaultPlan = None,
                 migration: MigrationConfig = None, device="cuda"):
        super().__init__(cfg, num_ranks, num_cores, traffic=traffic,
                         placement=placement, mesh=mesh, device=device)
        self.faults = (faults or FaultPlan()).validate(self.shape,
                                                       self.traffic.rounds)
        self.migration = migration
        self._planner = None

    # ------------------------------------------------------------------
    # incremental session driver
    # ------------------------------------------------------------------
    def start(self):
        """Begin a session at round 0 with a fresh fleet."""
        self._planner = self.planner()
        self.state = self.init_state()
        self.slots = self.new_slots(self.traffic.rounds)
        self.r = 0
        self._resps = []
        self.pressure_log = []
        return self

    def _decision_rounds(self):
        """Rounds where the fleet pauses between segments: every kill plus
        every drain point of the configured drain policy."""
        decide = set(self.faults.kill_rounds())
        if self.migration is not None:
            decide.update(fleet.DRAINS[self.migration.drain](
                self.traffic, self.migration.check_rounds))
        return decide

    def _kill(self, rk: int, ck: int, r: int):
        """Core (rk, ck) dies at round r: its heap state slice is
        re-initialized in the live state, in place (the fleet keeps its
        grid shape — a dead core just never gets work again) and the
        planner re-places its blocks. On a mesh only the process that holds
        rank rk touches its state."""
        lo, hi = ((0, self.num_ranks) if self.shard is None
                  else (self.shard.lo, self.shard.hi))
        if lo <= rk < hi:
            _write_slice(self.state, heap_api.sharded_init(
                self.cfg, 1, 1, device=self.device), rk - lo, ck)
        self._planner.kill_core(rk, ck, r)

    def _check_migration(self, r: int):
        # the one read of device state a decision round makes (on a mesh,
        # the [R, C] telemetry counters gathered: never the heaps)
        pres = telemetry.fleet_pressure(
            types.SimpleNamespace(telem=self.whole(self.state.telem)))
        div = telemetry.hwm_divergence(pres["rank_hwm"],
                                       ratio=self.migration.ratio,
                                       min_bytes=self.migration.min_bytes)
        self.pressure_log.append({"round": int(r), **div})
        if not div["trigger"]:
            return
        moves = fleet.MIGRATIONS[self.migration.policy](
            div, self._planner.homes, self._planner.tenant_bytes(),
            self._planner.loads, self.shape, dead=self._planner.dead,
            max_moves=self.migration.max_moves)
        for k, dst in moves:
            self._planner.migrate(k, dst, r)

    def run_until(self, stop: int):
        """Plan + execute rounds [current, stop) in decision-bounded
        segments."""
        if self._planner is None:
            self.start()
        stop = min(int(stop), self.traffic.rounds)
        decide = self._decision_rounds()
        drains = (set(fleet.DRAINS[self.migration.drain](
            self.traffic, self.migration.check_rounds))
            if self.migration is not None else set())
        p = self._planner
        while self.r < stop:
            for rk, ck in ((ev.rank, ev.core)
                           for ev in self.faults.at(self.r, KILL)):
                self._kill(rk, ck, self.r)
            if self.r in drains:
                self._check_migration(self.r)
            nxt = min([stop] + [d for d in decide if self.r < d < stop])
            for r in range(self.r, nxt):
                p.plan_round(r, stalled=self.faults.stalled_at(r),
                             drop_round=self.faults.is_dropped(r))
            sl = slice(self.r, nxt)
            self.state, self.slots, resps = self.run_segment(
                self.state, self.slots, self.r,
                (p.op[sl], p.size[sl], p.ref[sl], p.raw[sl]))
            self._resps.append(resps)
            self.r = nxt
        return self

    def finish(self):
        """Complete the session; returns (plan, report) like ``serve``."""
        self.run_until(self.traffic.rounds)
        plan = self._planner.finish()
        report = self.report(plan, self._stacked(), self.state)
        report.update(self._elastic_extras())
        return plan, report

    def _elastic_extras(self) -> dict:
        p = self._planner
        return {
            "migrations": [ev for ev in p.migration_log
                           if ev["kind"] == "migrate"],
            "kills": [ev for ev in p.migration_log if ev["kind"] == "kill"],
            "migration_ops_dispatched": p.mig_dispatched,
            "killed_cores": sorted([list(d) for d in p.dead]),
            "faults": json.loads(self.faults.to_json()),
            "pressure": self.pressure_log,
        }

    def serve(self, plan: SessionPlan = None):
        """One-shot elastic session (plan= is meaningless here: planning is
        interleaved with execution)."""
        if plan is not None:
            raise ValueError("ElasticFleetServe plans its own session; "
                             "use FleetServe for pre-planned tapes")
        self.start()
        return self.finish()

    def _stacked(self) -> AllocResponse:
        """The responses so far as one [rounds so far, R, C, T] stack on
        the device."""
        if not self._resps:
            return AllocResponse(*(
                torch.zeros((0,) + self.shape, dtype=torch.int32,
                            device=self.device)
                for _ in AllocResponse._fields))
        return AllocResponse(*(torch.cat(f) for f in zip(*self._resps)))

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------
    def _identity(self) -> dict:
        # normalized through a JSON round-trip so tuples (size_choices)
        # compare equal against a loaded sidecar
        return json.loads(json.dumps({
            "kind": self.cfg.kind,
            "shape": list(self.shape),
            "placement": self.placement,
            "traffic": dataclasses.asdict(self.traffic),
        }))

    def snapshot(self, ckpt_dir: str, step: int = None) -> str:
        """Checkpoint the mid-session engine; returns the checkpoint path.

        Device half (heap state, slot file, planned grids, responses so
        far) goes through `repro_torch.checkpoint.ckpt.save`, which copies
        it to the host before the next segment can update the state in
        place; host half (the planner) into a ``host.json`` sidecar inside
        the step directory. On a mesh every process calls it: the heap is
        gathered to process 0, which alone writes the files, and every
        process returns once they are committed.
        """
        step = self.r if step is None else step
        p = self._planner
        heap = self.state
        if self.shard is not None:
            heap = self.shard.gather_to(self.state, dst=0)
            if heap is None:
                comm.barrier()
                return os.path.join(ckpt_dir, f"step_{step:08d}")
        tree = {
            "heap": heap,
            "slots": self.slots,
            "plan": {"op": p.op, "size": p.size, "ref": p.ref, "raw": p.raw},
            "resps": self._stacked()._asdict(),
        }
        path = ckpt.save(tree, step, ckpt_dir)
        host = {
            "format": "pim-malloc-elastic-ckpt/v1",
            "identity": self._identity(),
            "round": int(self.r),
            "faults": self.faults.to_json(),
            "migration": (dataclasses.asdict(self.migration)
                          if self.migration else None),
            "planner": p.pack_host(),
            "pressure_log": self.pressure_log,
        }
        with open(os.path.join(path, "host.json"), "w") as f:
            json.dump(host, f)
        if self.shard is not None:
            comm.barrier()
        return path

    def restore(self, ckpt_dir: str, step: int = None):
        """Rebuild this engine's mid-session state from a snapshot.

        The engine must be constructed with the same identity (cfg kind,
        shape, placement, traffic); its device may differ: every device
        leaf is placed on this engine's device, and the resumed session
        is the same bit for bit either way. On a mesh each process keeps
        its own ranks of the checkpoint's whole fleet.
        """
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under "
                                        f"{ckpt_dir}")
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        with open(os.path.join(path, "host.json")) as f:
            host = json.load(f)
        if host["identity"] != self._identity():
            raise ValueError(f"checkpoint identity mismatch:\n"
                             f"  saved   {host['identity']}\n"
                             f"  engine  {self._identity()}")
        tc = self.traffic
        rounds, (R, C, T) = tc.rounds, self.shape
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]

        def resp_like(field):
            m = manifest[f"resps/{field}"]
            return torch.zeros(m["shape"], device=self.device,
                               dtype=getattr(torch, m["dtype"]))

        grid = np.zeros((rounds, R, C, T), np.int32)
        tree_like = {
            "heap": self.init_state(),
            "slots": self.new_slots(rounds),
            "plan": {k: grid for k in ("op", "size", "ref", "raw")},
            "resps": {f: resp_like(f) for f in AllocResponse._fields},
        }
        shardings = None
        if self.shard is not None:
            # the heap's leaves keep this process's ranks; the rest whole
            ranks = slice(self.shard.lo, self.shard.hi)
            shardings = {"heap": _like(tree_like["heap"], ranks)}
        tree = ckpt.restore(tree_like, step, ckpt_dir, shardings=shardings)

        self.r = int(host["round"])
        self.state = tree["heap"]
        self.slots = tree["slots"]
        self._resps = ([AllocResponse(**tree["resps"])] if self.r else [])
        self.faults = FaultPlan.from_json(host["faults"]).validate(
            self.shape, rounds)
        if host["migration"] is not None:
            self.migration = MigrationConfig(**host["migration"])
        self._planner = SessionPlanner.unpack(
            tc, self.shape, self.placement, host["planner"],
            (tree["plan"][k] for k in ("op", "size", "ref", "raw")))
        self.pressure_log = list(host["pressure_log"])
        return self


def serve_elastic(cfg, num_ranks: int, num_cores: int,
                  traffic: TrafficConfig = None,
                  placement: str = "round_robin", mesh=False,
                  faults: FaultPlan = None,
                  migration: MigrationConfig = None,
                  device="cuda") -> dict:
    """One-call convenience mirroring `serve_fleet.serve_session`, on
    `device` (the card unless the caller asks for the CPU)."""
    eng = ElasticFleetServe(cfg, num_ranks, num_cores, traffic=traffic,
                            placement=placement, mesh=mesh, faults=faults,
                            migration=migration, device=device)
    _, report = eng.serve()
    return report


def _like(tree, value):
    """`tree` with every tensor leaf replaced by `value`."""
    if isinstance(tree, torch.Tensor):
        return value
    return type(tree)(*(_like(x, value) for x in tree))


def _write_slice(full, fresh, rk: int, ck: int):
    """Copy the single-core tree `fresh` (leaves [1, 1, ...]) into slice
    [rk, ck] of every leaf of `full`, in place."""
    if isinstance(full, torch.Tensor):
        full[rk, ck].copy_(fresh[0, 0])
        return
    for a, b in zip(full, fresh):
        _write_slice(a, b, rk, ck)
