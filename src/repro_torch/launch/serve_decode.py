"""DecodeServe: closed-loop continuous-batching LLM decode on the fleet heap.

The port of `repro.launch.serve_decode`. The engine drives the paper's
flagship application shape: multi-tenant LLM serving whose KV cache is
paged through PIM-malloc. Every allocator op in the session is a KV-page
event of a serving schedule:

  1. **Sessions (host).** `DecodeTraffic` draws Poisson session arrivals;
     each session belongs to a tenant whose popularity is Zipf-distributed,
     carries a prompt length and a decode budget, and passes a bounded
     FIFO admission queue (arrivals beyond it are dropped and accounted).
     Placement is tenant-sticky via `fleet.tenant_core`, so a session's
     whole page chain lives on one (rank, core) heap.
  2. **Continuous batching (host).** Each protocol round the scheduler
     dispatches, in priority order, into the home core's T thread slots:
     (a) eviction frees (non-droppable: they release capacity); (b) one
     decode token per running session, which allocates ONE page
     (`PAGE_UNIT`, the thread-cache frontend path) whenever the token
     crosses a page boundary (no free slot: the token stalls); (c) queued
     prefills, one burst malloc of the whole prompt extent (the buddy
     bypass for long prompts), head-of-line blocking. A session ends when
     its decode budget is spent or its context hits ``max_context``
     (overflow: eviction); eviction frees every decode page and the
     prefill extent back through the protocol. `DecodeServe.plan` is pure
     host numpy and draws from ``np.random.default_rng(seed)`` in the
     reference's order, so both plan the same session.
  3. **The round driver (device).** The whole session, op / size /
     pointer-ref grids of shape [rounds, R, C, T], runs through
     `repro_torch.launch.serving.ScanEngine`: one `heap.sharded_step` per
     round over the [R, C] fleet (for kind ``fused`` one launch of the
     heap-step kernel), pointer operands resolved on the device against
     the pointers the fleet returned: eviction frees free the real pages
     of this run.

The report couples serving and allocator metrics: ``tokens_per_sec`` and
TTFT percentiles (arrival -> prefill dispatch through round barriers + the
prefill op's own modeled latency) beside alloc p50/p95/p99 service
latencies, per-rank heap high-water marks, external fragmentation and the
per-core conservation residual, all in the reference's float64 arithmetic
over the float32 latencies. `trace(plan, rank, core)` exports any core's
page traffic as a ``pim-malloc-trace/v1`` tape that replays bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools

import numpy as np

from ..core.heap import (OP_FREE, OP_MALLOC, OP_NOOP, AllocRequest,
                         AllocResponse)
from ..kvcache.paged import PAGE_UNIT
from ..workloads.trace import Trace
from . import fleet
from .serving import (ScanEngine, fleet_health, pct, resolve_pointers,
                      response_host, round_barrier_cum)

# ledger op kinds (DecodePlan.opkind)
PREFILL, DECODE_PAGE, EVICT_PAGE, EVICT_EXTENT = 0, 1, 2, 3

# session phases (host-side planner state machine)
_QUEUED, _DECODE, _EVICTED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class DecodeTraffic:
    """Multi-tenant LLM decode traffic: Poisson sessions, Zipf tenants.

    ``session_rate`` is the mean number of new sessions per protocol round
    (Poisson). A session draws its prompt from ``prompt_choices`` (tokens;
    short prompts prefill through the thread-cache frontend, long ones
    through the buddy bypass) and its decode budget from
    ``decode_choices`` (0 = the tenant dies right after prefill). Context
    is capped at ``max_context`` tokens — a session that would decode past
    it is evicted on **overflow**. ``max_context`` must be page-aligned so
    the overflow edge lands exactly on a page boundary (no page is ever
    allocated for a token that cannot be written). ``queue_cap`` bounds
    the session admission queue (backpressure: drops are accounted).
    """

    seed: int = 0
    rounds: int = 96
    session_rate: float = 1.5
    num_tenants: int = 8
    zipf_a: float = 1.4
    page_size: int = 16                       # tokens per KV page
    prompt_choices: tuple = (24, 48, 120, 512, 3000)
    decode_choices: tuple = (0, 8, 24, 56, 120)
    max_context: int = 576
    queue_cap: int = 16

    def __post_init__(self):
        if not (self.rounds >= 1 and self.zipf_a > 1.0):
            raise ValueError("need rounds >= 1 and zipf_a > 1")
        if not (self.queue_cap >= 1 and self.session_rate >= 0):
            raise ValueError("need queue_cap >= 1 and session_rate >= 0")
        if self.max_context % self.page_size:
            raise ValueError("max_context must be page-aligned "
                             "(overflow = page boundary)")


@dataclasses.dataclass
class DecodePlan:
    """One planned decode session: the device tape + serving ledger."""

    shape: tuple                 # (R, C, T)
    placement: str
    page_size: int
    op: np.ndarray               # int32[rounds, R, C, T]
    size: np.ndarray
    ptr_ref: np.ndarray          # global slot id round*(R*C*T) + grid slot, -1
    ptr_raw: np.ndarray
    # per dispatched allocator op, in dispatch order:
    enq_round: np.ndarray        # int32[n] (prefill: session arrival round)
    disp_round: np.ndarray       # int32[n]
    slot: np.ndarray             # int32[n] flat in-round grid slot id
    session: np.ndarray          # int32[n]
    opkind: np.ndarray           # int32[n] PREFILL/DECODE_PAGE/EVICT_*
    # per admitted session:
    s_tenant: np.ndarray         # int32[S]
    s_arrive: np.ndarray         # int32[S]
    s_prefill_round: np.ndarray  # int32[S] (-1 = never prefilled)
    s_prompt: np.ndarray         # int32[S] tokens
    s_decode_target: np.ndarray  # int32[S] tokens
    s_tokens: np.ndarray         # int32[S] decode tokens actually generated
    s_end_round: np.ndarray      # int32[S] (-1 = still running at end)
    s_overflow: np.ndarray       # bool[S] evicted on context overflow
    s_stalls: np.ndarray         # int32[S] tokens delayed by a full core
    # admission / series:
    offered: int
    dropped: int
    backlog_end: int             # queued sessions + pending frees at end
    queue_depth: np.ndarray      # int32[rounds] admission queue after dispatch
    drops_per_round: np.ndarray
    decode_tokens_per_round: np.ndarray
    tenant_home: dict

    @property
    def rounds(self) -> int:
        return int(self.op.shape[0])

    @property
    def dispatched(self) -> int:
        return int(self.slot.shape[0])


class DecodeServe(ScanEngine):
    """Closed-loop paged-KV decode engine over one [R, C, T] fleet, on
    `device` (the card unless the caller asks for the CPU).

    ``mesh`` follows `ScanEngine`: ``False`` and ``None`` run the rank
    axis on one device; a device mesh raises."""

    def __init__(self, cfg, num_ranks: int, num_cores: int,
                 traffic: DecodeTraffic = None,
                 placement: str = "least_loaded", mesh=False,
                 device="cuda"):
        if placement not in fleet.PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r} "
                             f"(have {tuple(fleet.PLACEMENTS)})")
        super().__init__(cfg, num_ranks, num_cores, mesh=mesh, device=device)
        self.traffic = traffic or DecodeTraffic()
        self.placement = placement

    # ------------------------------------------------------------------
    # host-side planning: the continuous-batching scheduler
    # ------------------------------------------------------------------
    def plan(self) -> DecodePlan:
        tc = self.traffic
        R, C, T = self.shape
        cap = R * C * T
        ps = tc.page_size
        rng = np.random.default_rng(tc.seed)

        w = np.arange(1, tc.num_tenants + 1, dtype=np.float64) ** -tc.zipf_a
        pop = w / w.sum()

        op = np.zeros((tc.rounds, R, C, T), np.int32)
        size = np.zeros_like(op)
        ref = np.full_like(op, -1)
        raw = np.full_like(op, -1)

        sessions = []                       # planner state machines
        admit_q = collections.deque()       # sessions awaiting prefill
        evict_q = collections.deque()       # (session, aid, opkind) frees
        homes = {}                          # tenant -> (rank, core)
        loads = np.zeros((R, C))            # live bytes per core
        alloc_slot = {}                     # aid -> (global slot id, round)
        alloc_bytes = {}
        aid_counter = itertools.count()

        enq_l, disp_l, slot_l, sess_l, kind_l = [], [], [], [], []
        depth_series = np.zeros(tc.rounds, np.int32)
        drops_series = np.zeros(tc.rounds, np.int32)
        tokens_series = np.zeros(tc.rounds, np.int32)
        offered = dropped = 0

        def home_of(s):
            k = s["tenant"]
            if k not in homes:
                homes[k] = fleet.tenant_core(
                    self.placement, len(homes), self.shape, loads=loads,
                    expected_tenants=tc.num_tenants)
            return homes[k]

        for r in range(tc.rounds):
            # -- session arrivals through the bounded admission queue ------
            for _ in range(int(rng.poisson(tc.session_rate))):
                offered += 1
                k = int(rng.choice(tc.num_tenants, p=pop))
                prompt = int(rng.choice(tc.prompt_choices))
                decode = int(rng.choice(tc.decode_choices))
                if len(admit_q) >= tc.queue_cap:
                    dropped += 1
                    drops_series[r] += 1
                    continue
                s = {"idx": len(sessions), "tenant": k, "arrive": r,
                     "prompt": prompt, "decode_target": decode, "pos": 0,
                     "prefill_round": -1, "pages": [], "tokens": 0,
                     "phase": _QUEUED, "stalls": 0, "end": -1,
                     "overflow": False}
                sessions.append(s)
                admit_q.append(s)

            used = np.zeros((R, C), np.int32)

            def emit(s, o, sz, aid=None, new=False, kind=0, enq=None):
                """Place one op on s's home core this round; returns the
                (possibly fresh) aid, or None when the core is full or the
                free targets a pointer produced this very round."""
                rk, ck = home_of(s)
                if used[rk, ck] >= T:
                    return None
                if aid is not None and alloc_slot[aid][1] >= r:
                    return None
                t = int(used[rk, ck])
                used[rk, ck] += 1
                gslot = (rk * C + ck) * T + t
                op[r, rk, ck, t] = o
                size[r, rk, ck, t] = sz
                if aid is not None:
                    ref[r, rk, ck, t] = alloc_slot[aid][0]
                if new:
                    aid = next(aid_counter)
                    alloc_slot[aid] = (r * cap + gslot, r)
                    alloc_bytes[aid] = sz
                    loads[rk, ck] += sz
                elif o == OP_FREE:
                    loads[rk, ck] -= alloc_bytes.pop(aid)
                    del alloc_slot[aid]
                enq_l.append(r if enq is None else enq)
                disp_l.append(r)
                slot_l.append(gslot)
                sess_l.append(s["idx"])
                kind_l.append(kind)
                return aid

            # (a) eviction frees first: non-droppable, they release pages
            for _ in range(len(evict_q)):
                s, aid, kind = evict_q.popleft()
                if emit(s, OP_FREE, 0, aid=aid, kind=kind) is None:
                    evict_q.append((s, aid, kind))   # retry next round

            # (b) one decode token per running session (continuous batch)
            for s in sessions:
                if s["phase"] != _DECODE:
                    continue
                target = s["prompt"] + s["decode_target"]
                horizon = min(target, tc.max_context)
                if s["pos"] >= horizon:
                    # done (budget spent) or overflow (context full):
                    # evict — free decode pages, then the prefill extent
                    s["phase"] = _EVICTED
                    s["end"] = r
                    s["overflow"] = s["pos"] < target
                    for aid in s["pages"][1:]:
                        evict_q.append((s, aid, EVICT_PAGE))
                    evict_q.append((s, s["pages"][0], EVICT_EXTENT))
                    continue
                p = s["pos"]
                prompt_pages = -(-s["prompt"] // ps)
                if p % ps == 0 and p // ps >= prompt_pages:
                    # token crosses a page boundary: frontend single-page
                    # malloc; a full home core stalls the token
                    aid = emit(s, OP_MALLOC, PAGE_UNIT, new=True,
                               kind=DECODE_PAGE)
                    if aid is None:
                        s["stalls"] += 1
                        continue
                    s["pages"].append(aid)
                s["pos"] += 1
                s["tokens"] += 1
                tokens_series[r] += 1

            # (c) queued prefills fill the remaining slots (FIFO)
            for _ in range(len(admit_q)):
                s = admit_q.popleft()
                prompt_pages = -(-s["prompt"] // ps)
                aid = emit(s, OP_MALLOC, prompt_pages * PAGE_UNIT, new=True,
                           kind=PREFILL, enq=s["arrive"])
                if aid is None:
                    admit_q.appendleft(s)   # head-of-line: stay FIFO
                    break
                s["pages"] = [aid]
                s["pos"] = s["prompt"]
                s["prefill_round"] = r
                s["phase"] = _DECODE

            depth_series[r] = len(admit_q)

        return DecodePlan(
            shape=self.shape, placement=self.placement, page_size=ps,
            op=op, size=size, ptr_ref=ref, ptr_raw=raw,
            enq_round=np.asarray(enq_l, np.int32),
            disp_round=np.asarray(disp_l, np.int32),
            slot=np.asarray(slot_l, np.int32),
            session=np.asarray(sess_l, np.int32),
            opkind=np.asarray(kind_l, np.int32),
            s_tenant=np.asarray([s["tenant"] for s in sessions], np.int32),
            s_arrive=np.asarray([s["arrive"] for s in sessions], np.int32),
            s_prefill_round=np.asarray(
                [s["prefill_round"] for s in sessions], np.int32),
            s_prompt=np.asarray([s["prompt"] for s in sessions], np.int32),
            s_decode_target=np.asarray(
                [s["decode_target"] for s in sessions], np.int32),
            s_tokens=np.asarray([s["tokens"] for s in sessions], np.int32),
            s_end_round=np.asarray([s["end"] for s in sessions], np.int32),
            s_overflow=np.asarray([s["overflow"] for s in sessions], bool),
            s_stalls=np.asarray([s["stalls"] for s in sessions], np.int32),
            offered=offered, dropped=dropped,
            backlog_end=len(admit_q) + len(evict_q)
            + sum(1 for s in sessions if s["phase"] == _DECODE),
            queue_depth=depth_series, drops_per_round=drops_series,
            decode_tokens_per_round=tokens_series,
            tenant_home=dict(homes))

    def serve(self, plan: DecodePlan = None):
        """Plan (unless given) and run one session; returns (plan, report)."""
        plan = plan or self.plan()
        state, resps = self.run(plan)
        return plan, self.report(plan, resps, state)

    # ------------------------------------------------------------------
    # reporting: serving metrics + allocator metrics, one place
    # ------------------------------------------------------------------
    def report(self, plan: DecodePlan, resps: AllocResponse, state) -> dict:
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

        # TTFT: session arrival -> prefill dispatch (round barriers) + the
        # prefill op's own modeled latency — prefill emits the first token
        is_prefill = plan.opkind == PREFILL
        ttft = (cum[plan.disp_round[is_prefill]]
                - cum[plan.enq_round[is_prefill]] + own[is_prefill])
        # allocator service latency over every page-alloc op
        is_alloc_op = (plan.opkind == PREFILL) | (plan.opkind == DECODE_PAGE)
        alloc_lat = own[is_alloc_op]

        resolved = resolve_pointers(plan, host["ptr"])
        acct = fleet.FleetAccounting(R)
        for r in range(rounds):
            req = AllocRequest(op=plan.op[r], size=plan.size[r],
                               ptr=resolved[r])
            acct.add_round(req, AllocResponse(
                *[host[f][r] for f in AllocResponse._fields]))

        health = fleet_health(self.cfg, state, R, C)

        active = opf != OP_NOOP
        is_alloc = opf == OP_MALLOC
        modeled_wall_us = float(round_cyc.sum() / freq * 1e6)
        decode_tokens = int(plan.s_tokens.sum())
        prefill_tokens = int(plan.s_prompt[plan.s_prefill_round >= 0].sum())
        n_disp = plan.dispatched
        prefilled = int((plan.s_prefill_round >= 0).sum())
        report = {
            "shape": list(plan.shape), "rounds": rounds,
            "placement": plan.placement, "seed": self.traffic.seed,
            "page_size": plan.page_size,
            "capacity_per_round": self.capacity,
            # sessions / admission
            "sessions_offered": plan.offered,
            "sessions_dropped": plan.dropped,
            "session_drop_rate": plan.dropped / max(plan.offered, 1),
            "sessions_prefilled": prefilled,
            "sessions_completed": int(((plan.s_end_round >= 0)
                                       & ~plan.s_overflow).sum()),
            "sessions_evicted_overflow": int(plan.s_overflow.sum()),
            "sessions_active_end": int(((plan.s_prefill_round >= 0)
                                        & (plan.s_end_round < 0)).sum()),
            "backlog_end": plan.backlog_end,
            "queue_depth_mean": float(plan.queue_depth.mean()),
            "queue_depth_max": int(plan.queue_depth.max()),
            "drops_per_round": plan.drops_per_round.tolist(),
            "decode_tokens_per_round": plan.decode_tokens_per_round.tolist(),
            # tokens (the serving side of the coupled report)
            "prefill_tokens": prefill_tokens,
            "decode_tokens": decode_tokens,
            "tokens_total": prefill_tokens + decode_tokens,
            "tokens_per_sec": (decode_tokens
                               / max(modeled_wall_us, 1e-9) * 1e6),
            "decode_stalls": int(plan.s_stalls.sum()),
            **{f"ttft_{k}": v for k, v in pct(ttft).items()},
            # allocator latency (the allocator side)
            **{f"alloc_{k}": v for k, v in pct(alloc_lat).items()},
            # op mix / outcome counters
            "prefill_allocs": int(is_prefill.sum()),
            "decode_page_allocs": int((plan.opkind == DECODE_PAGE).sum()),
            "evict_frees": int((plan.opkind >= EVICT_PAGE).sum()),
            "ops": int(active.sum()), "ok_ops": int(okf.sum()),
            "failed_allocs": int((is_alloc & active & ~okf).sum()),
            "dropped_frees": int(((opf == OP_FREE) & (pathf == 2)).sum()),
            # heap health (per-core conservation + per-rank high-water)
            **health,
            "modeled_wall_us": modeled_wall_us,
            "ops_per_sec": (n_disp / max(modeled_wall_us, 1e-9) * 1e6),
            "accounting": acct.summary(freq),
        }
        report["us_per_op"] = report["accounting"]["us_per_op"]
        return report

    def trace(self, plan: DecodePlan, rank: int, core: int,
              name: str = None) -> Trace:
        """Export (rank, core)'s page traffic as a ``pim-malloc-trace/v1``
        tape (see `ScanEngine.trace`: closed by tenant stickiness)."""
        return super().trace(
            plan, rank, core, name=name,
            description=(f"DecodeServe paged-KV session slice rank={rank} "
                         f"core={core} placement={plan.placement}"),
            meta={"placement": plan.placement, "rank": rank, "core": core,
                  "seed": self.traffic.seed, "page_size": plan.page_size,
                  "workload": "llm-decode-paged-kv"})


def serve_decode_session(cfg, num_ranks: int, num_cores: int,
                         traffic: DecodeTraffic = None,
                         placement: str = "least_loaded", mesh=False,
                         device="cuda") -> dict:
    """One-call convenience: build a DecodeServe on `device` (the card
    unless the caller asks for the CPU), run one session, return the
    report."""
    engine = DecodeServe(cfg, num_ranks, num_cores, traffic=traffic,
                         placement=placement, mesh=mesh, device=device)
    _, report = engine.serve()
    return report
