"""FleetServe: the closed-loop, multi-tenant serving tier over the fleet.

The port of `repro.launch.serve_fleet`. Where
`repro_torch.launch.fleet.FleetRouter` answers one pre-batched round at a
time, FleetServe runs the *steady state* the paper's scalability claim is
about: an open-arrival request stream from many tenants pushing sustained,
contended malloc/free/realloc traffic through a bounded admission queue
onto the [R ranks, C cores, T threads] PIM grid.

    report = serve_session(cfg, num_ranks=2, num_cores=4,
                           traffic=TrafficConfig(rounds=128, arrival_rate=24),
                           placement="least_loaded")

The engine has three stages:

  1. **Traffic + admission (host).** `TrafficConfig` draws Poisson
     arrivals per round; each request belongs to a tenant whose popularity,
     characteristic allocation size, and block lifetime are Zipf-distributed
     (a few hot tenants with big/long-lived blocks, a heavy tail of small
     ones). The op mix is configurable (malloc / calloc / realloc / early
     free); every allocation also schedules an expiry FREE after the
     tenant's lifetime. External arrivals pass a bounded admission queue —
     when it is full they are **dropped and accounted** (backpressure);
     expiry frees release capacity and therefore bypass admission (they
     queue separately and are never dropped).

  2. **Placement (host, shared with fleet.py).** Tenants are *sticky*:
     all of a tenant's ops must reach the per-core heap that served its
     mallocs, so placement assigns each newly admitted tenant a (rank,
     core) home via `fleet.tenant_core` — ``chunked`` (contiguous tenant
     blocks per core), ``round_robin`` (stripe across ranks), or
     ``least_loaded`` (fewest live bytes). Each round dispatches queued ops
     FIFO into their home core's T thread slots; ops whose home is full
     this round wait (head-of-line per core, work-conserving across cores).
     Stages 1 and 2 are host numpy drawing from
     ``np.random.default_rng(seed)`` in the reference's order, so both
     packages plan the same session.

  3. **The round driver (device).** The planned session — op / size /
     pointer-ref grids of shape [rounds, R, C, T] — runs through
     `repro_torch.launch.serving.ScanEngine`: one `heap.sharded_step` a
     round over the [R, C] fleet (on kind ``fused`` one launch of the
     heap-step kernel), the state updated in place round over round.
     Pointer operands are symbolic slot references resolved on the device
     against the pointers the fleet actually returned (the
     `repro_torch.workloads` tape mechanism, lifted to the grid), so the
     session is closed-loop: frees free the real pointers of this run.

The report carries end-to-end latency percentiles (p50/p95/p99 in modeled
DPU cycles: queue wait in round-barriers + own service latency), queue-depth
and drop-rate time series, fleet/per-rank cost accounting, and per-core
heap-telemetry conservation. `FleetServe.trace` exports any (rank, core)'s
slice of a session as a standard ``pim-malloc-trace/v1`` tape, so a serve
session can be replayed and parity-checked by `repro_torch.workloads.replay`.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from ..core.heap import (OP_CALLOC, OP_EPOCH_RESET, OP_FREE, OP_MALLOC,
                         OP_NOOP, OP_REALLOC, AllocRequest, AllocResponse)
from ..workloads.trace import Trace
from . import fleet
from .serving import (ScanEngine, SessionPlan, epoch_boundaries,
                      fleet_health, pct, resolve_pointers, response_host,
                      round_barrier_cum)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Open-arrival multi-tenant traffic: Poisson arrivals, Zipf tenants.

    ``arrival_rate`` is the mean number of *external* requests per protocol
    round (Poisson); expiry frees generated by block lifetimes add to it.
    Tenant popularity, characteristic allocation size, and block lifetime
    are all Zipf(``zipf_a``)-distributed across ``num_tenants``. The op mix
    splits external arrivals: ``realloc_frac`` resize a live block,
    ``calloc_frac`` are zeroed allocations, ``free_frac`` retire a live
    block early, the rest are plain mallocs. ``queue_cap`` bounds the
    admission queue — arrivals beyond it are dropped (backpressure).

    ``epoch_rounds = E > 0`` switches small-block lifetime management from
    explicit expiry FREEs to epoch reset (the ``arena`` / ``tlregion``
    frontends): allocations of at most ``epoch_max_class`` bytes become
    round-scoped *Temp* allocations — they schedule no expiry free and are
    never realloc/free targets — and every E-th round the whole grid issues
    ``OP_EPOCH_RESET`` instead of traffic, reclaiming all of them in one
    bulk round. Big (bypass-range) blocks keep the explicit expiry
    machinery either way. On backends without an arena frontend the reset
    rounds are idle and the Temp blocks simply leak, so pair this mode with
    an arena kind (the ``fig_arena`` benchmark's expiry lane).
    """

    seed: int = 0
    rounds: int = 64
    arrival_rate: float = 8.0
    num_tenants: int = 16
    zipf_a: float = 1.4
    max_lifetime: int = 32
    realloc_frac: float = 0.15
    calloc_frac: float = 0.10
    free_frac: float = 0.10
    queue_cap: int = 128
    size_choices: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    epoch_rounds: int = 0
    epoch_max_class: int = 2048

    def __post_init__(self):
        if not (self.rounds >= 1 and self.zipf_a > 1.0):
            raise ValueError("need rounds >= 1 and zipf_a > 1")
        if self.realloc_frac + self.calloc_frac + self.free_frac > 1.0:
            raise ValueError("the op mix's fractions sum past 1")
        if not (self.epoch_rounds >= 0 and self.epoch_max_class > 0):
            raise ValueError("need epoch_rounds >= 0 and epoch_max_class > 0")


class SessionPlanner:
    """Round-at-a-time host-side planner for FleetServe sessions.

    Exactly the closed-loop planning stage of `FleetServe.plan`, factored
    into an incremental object so the elastic tier
    (`repro_torch.launch.elastic.ElasticFleetServe`) can interleave planning
    with execution: observe heap telemetry at a drain point, queue a tenant
    migration (:meth:`migrate`), kill a core (:meth:`kill_core`), stall a
    core or drop a whole round (``plan_round`` arguments), then keep
    planning. With none of the elastic hooks used, planning all rounds and
    calling :meth:`finish` is bitwise-identical to the pre-refactor
    one-shot ``FleetServe.plan()`` (pinned against the reference's planner
    in tests/test_torch_fleet_serve.py).

    Three dispatch lanes, in priority order, all FIFO within a lane:

      * ``mig_q`` — migration ops (drain FREEs on the source core, replay
        MALLOCs on the destination). Never droppable.
      * ``free_q`` — lifetime-expiry FREEs. Never droppable.
      * ``queue`` — external arrivals, bounded by ``queue_cap``.

    Migration moves one *tracked* block per op pair: at :meth:`migrate` the
    block is claimed (no traffic may target it), a drain FREE with the
    producing slot frozen is queued to the old home and a replay MALLOC of
    the block's current size to the new home; the replay MALLOC re-binds
    ``alloc_slot[aid]`` at dispatch, so every later op on the block
    (expiry free, traffic realloc) resolves to the destination core's
    pointer — each core's session slice stays a closed tape.
    :meth:`kill_core` re-places a dead core's blocks through the same
    replay lane (no drain — the heap is gone) and re-homes its tenants;
    queued expiry frees for those blocks simply wait until the replay
    MALLOC re-binds their slot, so the expiry lane never drops.
    """

    def __init__(self, traffic: TrafficConfig, shape: tuple, placement: str):
        tc = self.traffic = traffic
        self.shape = shape
        self.placement = placement
        R, C, T = shape
        self.cap = R * C * T
        self.rng = np.random.default_rng(tc.seed)

        # tenant characteristics (Zipf popularity / size / lifetime)
        w = np.arange(1, tc.num_tenants + 1, dtype=np.float64) ** -tc.zipf_a
        self.pop = w / w.sum()
        sizes = np.asarray(tc.size_choices, np.int64)
        self.t_size = sizes[np.minimum(
            self.rng.zipf(tc.zipf_a, tc.num_tenants) - 1, len(sizes) - 1)]
        self.t_life = np.clip(self.rng.zipf(tc.zipf_a, tc.num_tenants), 1,
                              tc.max_lifetime).astype(np.int64)

        self.op = np.zeros((tc.rounds, R, C, T), np.int32)
        self.size = np.zeros_like(self.op)
        self.ref = np.full_like(self.op, -1)
        self.raw = np.full_like(self.op, -1)

        self.queue = collections.deque()   # external: (enq, tenant, op, size, aid)
        self.free_q = collections.deque()  # expiry frees: (enq, tenant, OP_FREE, 0, aid)
        self.mig_q = collections.deque()   # migration lane (see class docstring)
        self.expiry = collections.defaultdict(list)  # round -> [(tenant, aid)]
        self.alloc_slot = {}               # aid -> (global slot id, disp_round)
        self.alloc_bytes = {}              # aid -> bytes (load signal)
        self.alloc_owner = {}              # aid -> tenant
        self.live = collections.defaultdict(dict)  # tenant -> {aid: unclaimed}
        self.homes = {}                    # tenant -> (rank, core)
        self.loads = np.zeros((R, C))      # live bytes per core
        self.next_aid = 0
        self.boundary = epoch_boundaries(tc.rounds, tc.epoch_rounds)
        self.epoch_bytes = np.zeros((R, C))  # Temp bytes since last boundary
        self.dead = set()                  # killed (rank, core) — never dispatched
        self.migration_log = []            # one dict per migrate()/kill_core()
        self.mig_dispatched = 0            # migration-lane ops dispatched
        self.requeued_expiry = 0           # expiry frees re-pointed by a kill

        self.enq_r, self.disp_r, self.slot_r = [], [], []
        self.ten_r, self.ext_r = [], []
        self.depth_series = np.zeros(tc.rounds, np.int32)
        self.ext_depth_series = np.zeros(tc.rounds, np.int32)
        self.drops_series = np.zeros(tc.rounds, np.int32)
        self.disp_series = np.zeros(tc.rounds, np.int32)
        self.offered = 0
        self.dropped = 0

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def _home_of(self, aid) -> tuple:
        """(rank, core) where the block currently lives — derived from its
        producing slot, so a migration replay re-binds it automatically."""
        C, T = self.shape[1], self.shape[2]
        core = (self.alloc_slot[aid][0] % self.cap) // T
        return core // C, core % C

    def _masked_loads(self):
        if not self.dead:
            return self.loads
        masked = self.loads.copy()
        for d in self.dead:
            masked[d] = np.inf
        return masked

    def _fallback_home(self) -> tuple:
        """Least-loaded live core — the homing used when a policy's pick is
        dead (and for re-homing a killed core's tenants)."""
        C = self.shape[1]
        flat = int(np.argmin(self._masked_loads().reshape(-1)))
        return flat // C, flat % C

    def _home_for(self, k: int) -> tuple:
        home = fleet.tenant_core(
            self.placement, len(self.homes), self.shape,
            loads=self._masked_loads(),
            expected_tenants=self.traffic.num_tenants)
        if home in self.dead:
            home = self._fallback_home()
        return home

    def tenant_bytes(self) -> dict:
        """{tenant: tracked live bytes} — the migration policies' signal."""
        out = collections.defaultdict(int)
        for aid, b in self.alloc_bytes.items():
            out[self.alloc_owner[aid]] += b
        return dict(out)

    def claim_target(self, k):
        """Pick an unclaimed live alloc of tenant k (or None) and claim it
        so at most one in-flight op ever targets a block."""
        pool = [a for a, unclaimed in self.live[k].items() if unclaimed]
        if not pool:
            return None
        aid = pool[int(self.rng.integers(len(pool)))]
        self.live[k][aid] = False
        return aid

    # ------------------------------------------------------------------
    # elastic hooks
    # ------------------------------------------------------------------
    def migrate(self, k: int, dst: tuple, r: int) -> dict:
        """Queue a drain+replay migration of tenant ``k`` to ``dst``.

        Every *unclaimed* tracked block is moved (claimed blocks have an op
        in flight; they finish on the old core and stay there — their later
        frees still route by block home, not tenant home, so nothing is
        lost). The tenant's home flips immediately: all future allocations
        land on ``dst``.
        """
        src = self.homes.get(k)
        moved_bytes = 0
        moved = 0
        for aid, unclaimed in list(self.live[k].items()):
            if not unclaimed or self._home_of(aid) == dst:
                continue
            self.live[k][aid] = False
            self.mig_q.append(("move", r, k, aid, self.alloc_slot[aid][0],
                               self._home_of(aid)))
            moved += 1
            moved_bytes += self.alloc_bytes[aid]
        self.homes[k] = dst
        ev = {"kind": "migrate", "round": int(r), "tenant": int(k),
              "src": list(src) if src else None, "dst": list(dst),
              "blocks": int(moved), "bytes": int(moved_bytes)}
        self.migration_log.append(ev)
        return ev

    def kill_core(self, rk: int, ck: int, r: int) -> dict:
        """Mark core (rk, ck) dead and re-place its blocks/tenants.

        The caller is responsible for the matching heap-state surgery
        (re-initializing the core's state slice). Every tracked block that
        lived on the core is queued for a replay MALLOC on its (re-homed)
        tenant's live core — no drain free, the old heap is gone. Queued
        expiry frees for those blocks keep their aid and simply wait until
        the replay re-binds the slot: the never-droppable lane is requeued,
        not dropped.
        """
        self.dead.add((rk, ck))
        # a queued move whose source core died has nothing left to drain:
        # it degrades to a replay-only alloc (the move held the claim)
        self.mig_q = collections.deque(
            ("alloc", it[1], it[2], it[3], True)
            if it[0] == "move" and it[5] == (rk, ck) else it
            for it in self.mig_q)
        pending = {it[3] for it in self.mig_q}
        rehomed = []
        for k, home in list(self.homes.items()):
            if home == (rk, ck):
                self.homes[k] = self._fallback_home()
                rehomed.append(int(k))
        requeued = 0
        lost_bytes = 0
        for aid in list(self.alloc_slot):
            if self._home_of(aid) != (rk, ck) or aid in pending:
                continue
            k = self.alloc_owner[aid]
            unclaimed = self.live[k].get(aid)
            if unclaimed:
                self.live[k][aid] = False
            self.mig_q.append(("alloc", r, k, aid, bool(unclaimed)))
            requeued += 1
            lost_bytes += self.alloc_bytes[aid]
        self.requeued_expiry += sum(
            1 for it in self.free_q if self.alloc_owner.get(it[4]) is not None
            and it[4] in self.alloc_slot and self._home_of(it[4]) == (rk, ck))
        self.loads[rk, ck] = 0.0
        self.epoch_bytes[rk, ck] = 0.0
        ev = {"kind": "kill", "round": int(r), "core": [int(rk), int(ck)],
              "tenants_rehomed": rehomed, "blocks_replayed": int(requeued),
              "bytes_lost": int(lost_bytes)}
        self.migration_log.append(ev)
        return ev

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _ledger_mig(self, enq, r, gslot, k):
        self.enq_r.append(enq)
        self.disp_r.append(r)
        self.slot_r.append(gslot)
        self.ten_r.append(k)
        self.ext_r.append(False)
        self.disp_series[r] += 1
        self.mig_dispatched += 1

    def _dispatch_mig(self, item, r, used) -> bool:
        """Dispatch one migration-lane item (see class docstring).

        ``move`` items are atomic: the drain FREE on the source core and
        the replay MALLOC on the destination dispatch in the SAME round or
        not at all — dispatching the replay first would un-claim the block
        while its drain is still queued, letting a later free race the
        drain's ledger entry. ``alloc`` items (kill re-placement) have no
        drain half: the source heap is gone.
        """
        R, C, T = self.shape
        kind, enq, k, aid = item[:4]
        if kind == "move":
            slot, (srk, sck) = item[4], item[5]
            drk, dck = self.homes[k]
            if (used[srk, sck] >= T or (srk, sck) in self.dead
                    or used[drk, dck] >= T or (drk, dck) in self.dead):
                return False
            st = int(used[srk, sck])
            used[srk, sck] += 1
            self.op[r, srk, sck, st] = OP_FREE
            self.ref[r, srk, sck, st] = slot
            self.loads[srk, sck] -= self.alloc_bytes[aid]
            self._ledger_mig(enq, r, (srk * C + sck) * T + st, k)
            dt = int(used[drk, dck])
            used[drk, dck] += 1
            gslot = (drk * C + dck) * T + dt
            self.op[r, drk, dck, dt] = OP_MALLOC
            self.size[r, drk, dck, dt] = self.alloc_bytes[aid]
            self.alloc_slot[aid] = (r * self.cap + gslot, r)
            self.loads[drk, dck] += self.alloc_bytes[aid]
            self.live[k][aid] = True         # un-claim: move complete
            self._ledger_mig(enq, r, gslot, k)
            return True
        rk, ck = self.homes[k]               # "alloc": replay-only
        if used[rk, ck] >= T or (rk, ck) in self.dead:
            return False
        t = int(used[rk, ck])
        used[rk, ck] += 1
        gslot = (rk * C + ck) * T + t
        self.op[r, rk, ck, t] = OP_MALLOC
        self.size[r, rk, ck, t] = self.alloc_bytes[aid]
        self.alloc_slot[aid] = (r * self.cap + gslot, r)
        self.loads[rk, ck] += self.alloc_bytes[aid]
        if item[4]:                          # reclaim: no other op in flight
            self.live[k][aid] = True
        self._ledger_mig(enq, r, gslot, k)
        return True

    def _dispatch(self, item, external, r, used) -> bool:
        R, C, T = self.shape
        tc = self.traffic
        enq, k, o, s, aid = item
        if aid is not None:
            home = self._home_of(aid)        # ops follow the block
        else:
            home = self.homes.get(k)
            if home is None:
                home = self._home_for(k)
                self.homes[k] = home
        rk, ck = home
        if used[rk, ck] >= T or (rk, ck) in self.dead:
            return False                     # home core full this round
        if aid is not None and self.alloc_slot[aid][1] >= r:
            return False                     # target produced this round
        t = int(used[rk, ck])
        used[rk, ck] += 1
        gslot = (rk * C + ck) * T + t
        self.op[r, rk, ck, t] = o
        self.size[r, rk, ck, t] = s
        if aid is not None:
            self.ref[r, rk, ck, t] = self.alloc_slot[aid][0]
        if o in (OP_MALLOC, OP_CALLOC):
            if tc.epoch_rounds and s <= tc.epoch_max_class:
                # round-scoped Temp allocation: retired wholesale at the
                # next epoch boundary — no expiry free, and never a
                # realloc/free target (not entered in live)
                self.epoch_bytes[rk, ck] += s
                self.loads[rk, ck] += s
            else:
                new_aid = self.next_aid
                self.next_aid += 1
                self.alloc_slot[new_aid] = (r * self.cap + gslot, r)
                self.alloc_bytes[new_aid] = s
                self.alloc_owner[new_aid] = k
                self.live[k][new_aid] = True
                self.loads[rk, ck] += s
                self.expiry[r + int(self.t_life[k])].append((k, new_aid))
        elif o == OP_REALLOC:
            self.loads[rk, ck] += s - self.alloc_bytes[aid]
            self.alloc_slot[aid] = (r * self.cap + gslot, r)
            self.alloc_bytes[aid] = s
            self.live[k][aid] = True         # un-claim, stays live
        elif o == OP_FREE:
            self.loads[rk, ck] -= self.alloc_bytes.pop(aid)
            del self.live[k][aid]
            del self.alloc_slot[aid]
            del self.alloc_owner[aid]
        self.enq_r.append(enq)
        self.disp_r.append(r)
        self.slot_r.append(gslot)
        self.ten_r.append(k)
        self.ext_r.append(external)
        self.disp_series[r] += 1
        return True

    def plan_round(self, r: int, stalled=(), drop_round: bool = False):
        """Plan one round: arrivals, expiries, then dispatch.

        ``stalled`` is an iterable of (rank, core) that accept no dispatch
        this round (transient fault: their queued work waits one barrier);
        ``drop_round=True`` dispatches nothing fleet-wide (the round is
        lost — arrivals still enqueue, never-droppable lanes still queue).
        """
        tc = self.traffic
        rng = self.rng
        R, C, T = self.shape

        # -- external arrivals through the bounded admission queue ----
        for _ in range(int(rng.poisson(tc.arrival_rate))):
            self.offered += 1
            k = int(rng.choice(tc.num_tenants, p=self.pop))
            u = float(rng.random())
            item = None
            if u < tc.realloc_frac:
                aid = self.claim_target(k)
                if aid is not None:
                    nsz = int(self.t_size[k]) << int(rng.integers(0, 2))
                    item = (r, k, OP_REALLOC, nsz, aid)
            if item is None and u < tc.realloc_frac + tc.calloc_frac:
                item = (r, k, OP_CALLOC, int(self.t_size[k]), None)
            if item is None and u < (tc.realloc_frac + tc.calloc_frac
                                     + tc.free_frac):
                aid = self.claim_target(k)
                if aid is not None:
                    item = (r, k, OP_FREE, 0, aid)
            if item is None:
                item = (r, k, OP_MALLOC, int(self.t_size[k]), None)
            if len(self.queue) >= tc.queue_cap:
                self.dropped += 1
                self.drops_series[r] += 1
                # un-claim a target the dropped request had reserved
                if item[4] is not None and item[2] in (OP_REALLOC, OP_FREE):
                    self.live[item[1]][item[4]] = True
            else:
                self.queue.append(item)

        # -- lifetime expiries become internal frees ------------------
        for k, aid in self.expiry.pop(r, ()):
            state = self.live[k].get(aid)
            if state:                        # live and unclaimed
                self.live[k][aid] = False
                self.free_q.append((r, k, OP_FREE, 0, aid))
            elif state is False:             # claimed by an in-flight
                self.expiry[r + 1].append((k, aid))   # op: expire after it

        # -- epoch boundary: the whole grid turns the epoch over ------
        if self.boundary[r]:
            # every thread slot issues OP_EPOCH_RESET (idempotent on
            # the shared arena, per-region on tlregion); no traffic
            # dispatches this round — queued ops wait one barrier.
            # All Temp allocations since the last boundary are retired
            # wholesale, with no per-block FREE traffic.
            self.op[r] = OP_EPOCH_RESET
            self.loads -= self.epoch_bytes
            self.epoch_bytes[:] = 0
            self._record_depth(r)
            return

        # -- dispatch FIFO into per-core thread slots -----------------
        if not drop_round:
            used = np.zeros((R, C), np.int32)
            for rk, ck in self.dead:
                used[rk, ck] = T
            for rk, ck in stalled:
                used[rk, ck] = T
            lanes = ((self.mig_q, None), (self.free_q, False),
                     (self.queue, True))
            for q, external in lanes:
                for _ in range(len(q)):
                    item = q.popleft()
                    served = (self._dispatch_mig(item, r, used)
                              if external is None else
                              self._dispatch(item, external, r, used))
                    if not served:
                        q.append(item)       # retry next round, FIFO

        self._record_depth(r)

    def _record_depth(self, r):
        self.depth_series[r] = (len(self.queue) + len(self.free_q)
                                + len(self.mig_q))
        self.ext_depth_series[r] = len(self.queue)

    # ------------------------------------------------------------------
    # snapshot / restore (host half of ElasticFleetServe.snapshot)
    # ------------------------------------------------------------------
    def pack_host(self) -> dict:
        """JSON-able snapshot of every host-side planning structure.

        The op/size/ref/raw grids ride the npz checkpoint (device half);
        everything else — rng mid-stream state, queues, the alloc ledgers,
        homes/loads, series — round-trips through here. ``unpack`` into a
        fresh planner of the same TrafficConfig reproduces planning bitwise
        (the fresh ``__init__`` redraws the same tenant tables from the
        seed, then the saved rng state takes over mid-stream).
        """
        def q_item(it):
            enq, k, o, s, aid = it
            return [enq, k, o, s, -1 if aid is None else aid]

        return {
            "rng_state": self.rng.bit_generator.state,
            "queue": [q_item(it) for it in self.queue],
            "free_q": [q_item(it) for it in self.free_q],
            "mig_q": [list(it[:5]) + [list(it[5])] if it[0] == "move"
                      else list(it) for it in self.mig_q],
            "expiry": {str(r): [[k, a] for k, a in v]
                       for r, v in self.expiry.items()},
            "alloc_slot": {str(a): [int(s), int(d)]
                           for a, (s, d) in self.alloc_slot.items()},
            "alloc_bytes": {str(a): int(b)
                            for a, b in self.alloc_bytes.items()},
            "alloc_owner": {str(a): int(k)
                            for a, k in self.alloc_owner.items()},
            "live": {str(k): {str(a): bool(u) for a, u in d.items()}
                     for k, d in self.live.items()},
            "homes": {str(k): [int(h[0]), int(h[1])]
                      for k, h in self.homes.items()},
            "loads": self.loads.tolist(),
            "epoch_bytes": self.epoch_bytes.tolist(),
            "next_aid": self.next_aid,
            "dead": sorted([list(d) for d in self.dead]),
            "migration_log": self.migration_log,
            "mig_dispatched": self.mig_dispatched,
            "requeued_expiry": self.requeued_expiry,
            "ledger": [list(self.enq_r), list(self.disp_r),
                       list(self.slot_r), [int(t) for t in self.ten_r],
                       [bool(e) for e in self.ext_r]],
            "depth_series": self.depth_series.tolist(),
            "ext_depth_series": self.ext_depth_series.tolist(),
            "drops_series": self.drops_series.tolist(),
            "disp_series": self.disp_series.tolist(),
            "offered": self.offered,
            "dropped": self.dropped,
        }

    @classmethod
    def unpack(cls, traffic: TrafficConfig, shape: tuple, placement: str,
               host: dict, grids) -> "SessionPlanner":
        """Rebuild a mid-session planner from :meth:`pack_host` + the
        checkpointed op/size/ref/raw grids (as host numpy arrays)."""
        p = cls(traffic, shape, placement)
        p.rng.bit_generator.state = host["rng_state"]
        p.op, p.size, p.ref, p.raw = [np.array(g) for g in grids]

        def q_item(row):
            enq, k, o, s, aid = row
            return (int(enq), int(k), int(o), int(s),
                    None if aid == -1 else int(aid))

        p.queue = collections.deque(q_item(row) for row in host["queue"])
        p.free_q = collections.deque(q_item(row) for row in host["free_q"])
        p.mig_q = collections.deque(
            (it[0], int(it[1]), int(it[2]), int(it[3]), int(it[4]),
             tuple(it[5])) if it[0] == "move"
            else (it[0], int(it[1]), int(it[2]), int(it[3]), bool(it[4]))
            for it in host["mig_q"])
        p.expiry = collections.defaultdict(list)
        for r, v in host["expiry"].items():
            p.expiry[int(r)] = [(int(k), int(a)) for k, a in v]
        p.alloc_slot = {int(a): (int(s), int(d))
                        for a, (s, d) in host["alloc_slot"].items()}
        p.alloc_bytes = {int(a): int(b)
                         for a, b in host["alloc_bytes"].items()}
        p.alloc_owner = {int(a): int(k)
                         for a, k in host["alloc_owner"].items()}
        p.live = collections.defaultdict(dict)
        for k, d in host["live"].items():
            p.live[int(k)] = {int(a): bool(u) for a, u in d.items()}
        p.homes = {int(k): (int(h[0]), int(h[1]))
                   for k, h in host["homes"].items()}
        p.loads = np.asarray(host["loads"], np.float64)
        p.epoch_bytes = np.asarray(host["epoch_bytes"], np.float64)
        p.next_aid = int(host["next_aid"])
        p.dead = {tuple(d) for d in host["dead"]}
        p.migration_log = list(host["migration_log"])
        p.mig_dispatched = int(host["mig_dispatched"])
        p.requeued_expiry = int(host["requeued_expiry"])
        enq, disp, slot, ten, ext = host["ledger"]
        p.enq_r, p.disp_r, p.slot_r = list(enq), list(disp), list(slot)
        p.ten_r, p.ext_r = list(ten), list(ext)
        p.depth_series = np.asarray(host["depth_series"], np.int32)
        p.ext_depth_series = np.asarray(host["ext_depth_series"], np.int32)
        p.drops_series = np.asarray(host["drops_series"], np.int32)
        p.disp_series = np.asarray(host["disp_series"], np.int32)
        p.offered = int(host["offered"])
        p.dropped = int(host["dropped"])
        return p

    def finish(self) -> SessionPlan:
        return SessionPlan(
            shape=self.shape, placement=self.placement, op=self.op,
            size=self.size, ptr_ref=self.ref, ptr_raw=self.raw,
            enq_round=np.asarray(self.enq_r, np.int32),
            disp_round=np.asarray(self.disp_r, np.int32),
            slot=np.asarray(self.slot_r, np.int32),
            tenant=np.asarray(self.ten_r, np.int32),
            external=np.asarray(self.ext_r, bool),
            offered=self.offered, dropped=self.dropped,
            backlog_end=(len(self.queue) + len(self.free_q)
                         + len(self.mig_q)),
            queue_depth=self.depth_series,
            external_queue_depth=self.ext_depth_series,
            drops_per_round=self.drops_series,
            dispatched_per_round=self.disp_series,
            tenant_home=dict(self.homes))


class FleetServe(ScanEngine):
    """Closed-loop serving engine over one [R, C, T] fleet, on `device`
    (the card unless the caller asks for the CPU).

    ``mesh`` follows `ScanEngine`: ``False`` (the default) runs the rank
    axis on one device; ``None`` or a rank `DeviceMesh` of processes
    splits the ranks over the processes, every one of which plans the
    same session and reports the same numbers. Planning is
    this engine's own; the round driver, trace export and report plumbing
    live in `repro_torch.launch.serving` (shared with the decode engine).
    """

    def __init__(self, cfg, num_ranks: int, num_cores: int,
                 traffic: TrafficConfig = None, placement: str = "round_robin",
                 mesh=False, device="cuda"):
        if placement not in fleet.PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r} "
                             f"(have {tuple(fleet.PLACEMENTS)})")
        super().__init__(cfg, num_ranks, num_cores, mesh=mesh, device=device)
        self.traffic = traffic or TrafficConfig()
        self.placement = placement

    # ------------------------------------------------------------------
    # stage 1+2: host-side closed-loop planning
    # ------------------------------------------------------------------
    def planner(self) -> SessionPlanner:
        """A fresh round-at-a-time planner for this engine's traffic."""
        return SessionPlanner(self.traffic, self.shape, self.placement)

    def plan(self) -> SessionPlan:
        p = self.planner()
        for r in range(self.traffic.rounds):
            p.plan_round(r)
        return p.finish()

    # stage 3, the round driver, is ScanEngine.run / .run_segment, shared
    # with the decode engine.
    def serve(self, plan: SessionPlan = None):
        """Plan (unless given) and run one session; returns (plan, report)."""
        plan = plan or self.plan()
        state, resps = self.run(plan)
        return plan, self.report(plan, resps, state)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def report(self, plan: SessionPlan, resps: AllocResponse, state) -> dict:
        """The session's report from its plan, its stacked responses
        (copied to the host once) and its final fleet state."""
        R, C, T = plan.shape
        rounds = plan.rounds
        freq = self.cfg.dpu.freq_hz
        host = response_host(resps)
        lat = host["latency_cyc"]
        opf = plan.op.reshape(rounds, -1)
        pathf = host["path"].reshape(rounds, -1)
        okf = host["ok"].reshape(rounds, -1)

        round_cyc, cum = round_barrier_cum(lat)
        own = lat.reshape(rounds, -1)[plan.disp_round, plan.slot]
        e2e = cum[plan.disp_round] - cum[plan.enq_round] + own

        # account each round with the pointer operands the loop actually
        # resolved (slot refs against this run's returned pointers), not the
        # raw placeholders — accounting must see the served request
        resolved = resolve_pointers(plan, host["ptr"])
        acct = fleet.FleetAccounting(R)
        for r in range(rounds):
            req = AllocRequest(op=plan.op[r], size=plan.size[r],
                               ptr=resolved[r])
            acct.add_round(req, AllocResponse(
                *[host[f][r] for f in AllocResponse._fields]))

        health = fleet_health(self.cfg, state, R, C, self.shard)

        active = opf != OP_NOOP
        is_alloc = np.isin(opf, (OP_MALLOC, OP_CALLOC, OP_REALLOC))
        modeled_wall_us = float(round_cyc.sum() / freq * 1e6)
        n_disp = plan.dispatched
        report = {
            "shape": list(plan.shape), "rounds": rounds,
            "placement": plan.placement, "seed": self.traffic.seed,
            "capacity_per_round": self.capacity,
            # admission / backpressure
            "offered": plan.offered, "dropped": plan.dropped,
            "drop_rate": plan.dropped / max(plan.offered, 1),
            "dispatched": n_disp,
            "external_dispatched": int(plan.external.sum()),
            "expiry_frees_dispatched": int((~plan.external).sum()),
            "backlog_end": plan.backlog_end,
            "queue_depth_mean": float(plan.queue_depth.mean()),
            "queue_depth_max": int(plan.queue_depth.max()),
            "queue_depth": plan.queue_depth.tolist(),
            "external_queue_depth_max": int(plan.external_queue_depth.max()),
            "drops_per_round": plan.drops_per_round.tolist(),
            "dispatched_per_round": plan.dispatched_per_round.tolist(),
            # latency (modeled DPU cycles)
            **{f"e2e_{k}": v for k, v in pct(e2e).items()},
            **{f"service_{k}": v for k, v in pct(own).items()},
            "modeled_wall_us": modeled_wall_us,
            # all dispatched ops (allocs, frees, reallocs) over modeled wall
            "ops_per_sec": (n_disp / max(modeled_wall_us, 1e-9) * 1e6),
            # modeled wall per EXTERNAL request served — the serving cost a
            # tenant sees; expiry frees and epoch resets are management
            # overhead inside the wall, not calls (the fig_arena lane metric)
            "us_per_call": (modeled_wall_us
                            / max(int(plan.external.sum()), 1)),
            # outcome counters
            "ops": int(active.sum()), "ok_ops": int(okf.sum()),
            "failed_allocs": int((is_alloc & active & ~okf).sum()),
            "dropped_frees": int(((opf == OP_FREE) & (pathf == 2)).sum()),
            # heap health
            "live_bytes": health["live_bytes"],
            "conservation_residual": health["conservation_residual"],
            "accounting": acct.summary(freq),
        }
        report["us_per_op"] = report["accounting"]["us_per_op"]
        tc = self.traffic
        if tc.epoch_rounds:
            sizef = plan.size.reshape(rounds, -1)
            small_alloc = (np.isin(opf, (OP_MALLOC, OP_CALLOC))
                           & (sizef <= tc.epoch_max_class))
            report["epoch_rounds"] = tc.epoch_rounds
            report["epoch_resets"] = int(
                (opf == OP_EPOCH_RESET).any(axis=1).sum())
            report["epoch_managed_allocs"] = int(small_alloc.sum())
        return report

    def trace(self, plan: SessionPlan, rank: int, core: int,
              name: str = None) -> Trace:
        """Export (rank, core)'s slice as a ``pim-malloc-trace/v1`` tape
        (see `ScanEngine.trace` — closed by tenant stickiness)."""
        meta = {"placement": plan.placement, "rank": rank, "core": core,
                "seed": self.traffic.seed}
        if self.traffic.epoch_rounds:
            # the trace_lint epoch rule needs the small/big boundary this
            # session planned with (big bypass blocks survive resets)
            meta.update(epoch_rounds=self.traffic.epoch_rounds,
                        max_size_class=self.traffic.epoch_max_class)
        return super().trace(
            plan, rank, core, name=name,
            description=(f"FleetServe session slice rank={rank} core={core} "
                         f"placement={plan.placement}"),
            meta=meta)


def serve_session(cfg, num_ranks: int, num_cores: int,
                  traffic: TrafficConfig = None,
                  placement: str = "round_robin", mesh=False,
                  device="cuda") -> dict:
    """One-call convenience: build a FleetServe on `device` (the card
    unless the caller asks for the CPU), run one session, return the
    report."""
    engine = FleetServe(cfg, num_ranks, num_cores, traffic=traffic,
                        placement=placement, mesh=mesh, device=device)
    _, report = engine.serve()
    return report
