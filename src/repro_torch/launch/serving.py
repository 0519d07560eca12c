"""Shared serving-engine machinery for the closed-loop engines.

The port of `repro.launch.serving`. `DecodeServe`
(`repro_torch.launch.serve_decode`, paged-KV LLM decode) plans its
workload on the host and executes and reports it through this module:

  * :class:`SessionPlan`: a planned device tape (op / size / pointer-ref
    grids of shape [rounds, R, C, T]) plus the host-side dispatch ledger
    and admission/backpressure series.
  * :class:`ScanEngine`: the round driver. The whole planned session runs
    as a loop on the device: each round resolves its pointer operands
    from a flat slot file of the pointers the fleet returned earlier in
    the session (the `repro_torch.workloads` tape mechanism lifted to the
    grid), runs one `heap.sharded_step` over the [R, C] fleet and writes
    the pointers that survive back into the slot file; the responses are
    stacked on the device. Sessions are closed-loop: frees free the real
    pointers of this run. `ScanEngine.trace` exports any (rank, core)'s
    slice of a session as a standard ``pim-malloc-trace/v1`` tape.
  * report helpers: latency percentiles over round barriers (:func:`pct`,
    :func:`round_barrier_cum`), the pointers as the loop resolved them
    (:func:`resolve_pointers`), and the per-core heap-health sweep
    (:func:`fleet_health`: |residual| summed, so signed residuals of two
    broken cores never cancel into a clean-looking fleet).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from ..core import heap as heap_api
from ..core import telemetry
from ..core.heap import OP_REALLOC, AllocRequest, AllocResponse
from ..workloads.trace import Trace

PERCENTILES = (50, 95, 99)


@dataclasses.dataclass
class SessionPlan:
    """One planned serve session: the device tape + the host-side ledger."""

    shape: tuple                 # (R, C, T)
    placement: str
    op: np.ndarray               # int32[rounds, R, C, T]
    size: np.ndarray
    ptr_ref: np.ndarray          # global slot id round*(R*C*T) + grid slot, -1
    ptr_raw: np.ndarray
    # per dispatched request, in dispatch order:
    enq_round: np.ndarray        # int32[n]
    disp_round: np.ndarray       # int32[n]
    slot: np.ndarray             # int32[n] flat in-round grid slot id
    tenant: np.ndarray           # int32[n]
    external: np.ndarray         # bool[n] (False = expiry free)
    # admission/backpressure ledger:
    offered: int                 # external arrivals
    dropped: int                 # rejected at the full admission queue
    backlog_end: int             # still queued when the session ended
    queue_depth: np.ndarray      # int32[rounds] backlog after each dispatch
    external_queue_depth: np.ndarray  # int32[rounds] admission queue only
    drops_per_round: np.ndarray  # int32[rounds]
    dispatched_per_round: np.ndarray
    tenant_home: dict            # tenant -> (rank, core)

    @property
    def rounds(self) -> int:
        return int(self.op.shape[0])

    @property
    def dispatched(self) -> int:
        return int(self.slot.shape[0])


def epoch_boundaries(rounds: int, epoch_rounds: int) -> np.ndarray:
    """bool[rounds] mask of epoch-boundary rounds.

    With ``epoch_rounds = E > 0`` every E-th round (r = E-1, 2E-1, ...) is
    dedicated to ``OP_EPOCH_RESET``: the planner dispatches no traffic into
    it and every epoch-managed (small) allocation made since the previous
    boundary is invalid afterwards. ``epoch_rounds <= 0`` disables epochs
    (all-False mask)."""
    mask = np.zeros(rounds, bool)
    if epoch_rounds > 0:
        mask[epoch_rounds - 1::epoch_rounds] = True
    return mask


def pct(x, percentiles=PERCENTILES) -> dict:
    """{'p50_cyc': ..., ...} percentile dict (zeros for an empty sample)."""
    x = np.asarray(x)
    if x.size == 0:
        return {f"p{p}_cyc": 0.0 for p in percentiles}
    return {f"p{p}_cyc": float(np.percentile(x, p)) for p in percentiles}


def response_host(resps: AllocResponse) -> dict:
    """The one device -> host copy of a session's stacked responses: one
    host array per field, reused throughout the report."""
    return {f: getattr(resps, f).cpu().numpy()
            for f in AllocResponse._fields}


def round_barrier_cum(lat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(per-round barrier cycles, cumulative barrier prefix [rounds+1]).

    Threads within a round run concurrently; rounds serialize, so one
    round's barrier is its slowest thread and a queued request waits
    through the barriers between enqueue and dispatch."""
    rounds = lat.shape[0]
    flat = lat.reshape(rounds, -1)
    round_cyc = flat.max(axis=1) if flat.size else np.zeros(rounds)
    return round_cyc, np.concatenate([[0.0], np.cumsum(round_cyc)])


def resolve_pointers(plan, host_ptr: np.ndarray) -> np.ndarray:
    """Pointer operands as the loop resolved them (slot refs against this
    run's returned pointers), not the raw placeholders: accounting must
    see the served request."""
    flat_ptr = host_ptr.reshape(-1)
    return np.where(
        plan.ptr_ref >= 0,
        flat_ptr[np.clip(plan.ptr_ref, 0, flat_ptr.shape[0] - 1)],
        plan.ptr_raw).astype(np.int32)


def fleet_health(cfg, state, R: int, C: int) -> dict:
    """Per-core telemetry sweep over the final [R, C] fleet state, in one
    batched pass over all cores (`telemetry.core_health`).

    ``conservation_residual`` sums |per-core residuals| (signed residuals
    of two broken cores must not cancel into a clean-looking fleet);
    ``hwm_bytes_per_rank`` is each rank's busiest core (heaps are per-core,
    so a rank's high-water footprint is bounded by its hottest heap)."""
    h = telemetry.core_health(cfg, heap_api.fold(state, R * C))
    hwm_rank = h["hwm_bytes"].reshape(R, C).max(axis=1)
    return {
        "live_bytes": int(h["live_bytes"].sum()),
        "conservation_residual": int(np.abs(
            h["conservation_residual"]).sum()),
        "hwm_bytes_per_rank": [int(x) for x in hwm_rank],
        "hwm_bytes_max": int(hwm_rank.max()),
        "external_frag_mean": float(np.mean(h["external_frag"])),
    }


class ScanEngine:
    """The round driver every serving engine shares, on `device` (the card
    unless the caller asks for the CPU).

    ``mesh`` follows `repro_torch.core.heap.ShardedHeap`: ``False`` and
    ``None`` both run the rank axis on one device; a device mesh raises
    (the multi-GPU tier is not ported)."""

    def __init__(self, cfg, num_ranks: int, num_cores: int, mesh=False,
                 device="cuda"):
        self.cfg = cfg
        self.num_ranks = num_ranks
        self.num_cores = num_cores
        self._inner, self.mesh = heap_api.sharded_inner(cfg, mesh=mesh)
        self.device = _device.resolve(device)

    @property
    def shape(self) -> tuple:
        return (self.num_ranks, self.num_cores, self.cfg.num_threads)

    @property
    def capacity(self) -> int:
        R, C, T = self.shape
        return R * C * T

    def _grid(self, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                               device=self.device)

    def _round(self, state, slots, r: int, op_r, size_r, ref_r, raw_r):
        """One round: resolve the refs, step the fleet, record the
        surviving pointers in slots [r * cap, (r + 1) * cap)."""
        cap = self.capacity
        got = slots[torch.clamp(ref_r, 0, slots.shape[0] - 1).long()]
        ptr = torch.where(ref_r >= 0, got, raw_r)
        state, resp = self._inner(state, AllocRequest(op_r, size_r, ptr))
        # slot = the op's surviving pointer (the tape replayer's rule): a
        # failed relocating realloc keeps the old block, so the tenant's
        # scheduled expiry FREE must still reach it
        survived = ((op_r == OP_REALLOC) & (size_r > 0)
                    & (resp.ptr < 0) & (ptr >= 0))
        slots[r * cap:(r + 1) * cap] = torch.where(
            survived, ptr, resp.ptr).reshape(-1)
        return state, resp

    def run_segment(self, state, slots, r0: int, plan):
        """Execute rounds [r0, r0 + n) of a planned session, ``plan`` the
        tuple ``(op, size, ptr_ref, ptr_raw)`` of its [n, R, C, T] grids;
        ``slots`` is the whole session's slot file (rounds * capacity,
        int32 on the device), carried across segments. Returns (state,
        slots, resps); like `heap.step` it consumes `state` and `slots`.
        Running a session as segments equals one `run`: the same rounds."""
        op, size, ptr_ref, ptr_raw = (self._grid(x) for x in plan)
        resps = []
        for i in range(op.shape[0]):
            state, resp = self._round(state, slots, r0 + i, op[i], size[i],
                                      ptr_ref[i], ptr_raw[i])
            resps.append(resp)
        return state, slots, AllocResponse(
            *(torch.stack(f) for f in zip(*resps)))

    def new_slots(self, rounds: int) -> torch.Tensor:
        """An empty slot file for a session of `rounds` rounds."""
        return torch.full((rounds * self.capacity,), -1, dtype=torch.int32,
                          device=self.device)

    def run(self, plan):
        """Execute a planned session on a fresh fleet; returns the final
        [R, C] fleet state and the stacked [rounds, R, C, T] responses (on
        the device)."""
        state = heap_api.sharded_init(self.cfg, self.num_ranks,
                                      self.num_cores, device=self.device)
        state, _, resps = self.run_segment(
            state, self.new_slots(plan.rounds), 0,
            (plan.op, plan.size, plan.ptr_ref, plan.ptr_raw))
        return state, resps

    # ------------------------------------------------------------------
    # tape export: one core's slice of a session is a standard trace
    # ------------------------------------------------------------------
    def trace(self, plan, rank: int, core: int, name: str = None,
              description: str = None, meta: dict = None) -> Trace:
        """Export (rank, core)'s slice as a ``pim-malloc-trace/v1`` tape.

        Tenant stickiness guarantees every pointer ref in a core's slice
        points at a slot of the same core, so the slice is a closed,
        self-contained workload: replaying it through
        `repro_torch.workloads.replay` reproduces this core's serve
        responses bit for bit. Host numpy only."""
        R, C, T = plan.shape
        cap = R * C * T
        base = (rank * C + core) * T
        refs = plan.ptr_ref[:, rank, core, :]
        m = refs >= 0
        in_round = refs % cap
        if m.any() and not ((in_round[m] >= base)
                            & (in_round[m] < base + T)).all():
            raise ValueError("cross-core pointer ref: slice is not closed")
        new_ref = np.where(m, (refs // cap) * T + (in_round - base), -1)
        return Trace(
            name=name or f"serve_{plan.placement}_r{rank}c{core}",
            heap_bytes=self.cfg.heap_bytes, num_threads=T,
            recorded_kind=self.cfg.kind,
            description=description or
            f"serve session slice rank={rank} core={core} "
            f"placement={plan.placement}",
            op=plan.op[:, rank, core, :].astype(np.int32),
            size=plan.size[:, rank, core, :].astype(np.int32),
            ptr_ref=new_ref.astype(np.int32),
            ptr_raw=plan.ptr_raw[:, rank, core, :].astype(np.int32),
            meta=meta or {"placement": plan.placement, "rank": rank,
                          "core": core})
