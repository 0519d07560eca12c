"""Fleet-level request routing over a ShardedHeap: placement + accounting.

The port of `repro.launch.fleet`. A service front-end holds a flat stream
of allocation requests; the router scatters them onto the fleet's fixed
[R ranks, C cores, T threads] protocol grid (NOOP-padding the empty
slots), drives one `ShardedHeap.step` per round, gathers the responses
back into request order, and accumulates the DPU cost model's accounting
fleet-wide and per rank.

    heap = ShardedHeap(cfg, num_ranks=R, num_cores=C)
    router = FleetRouter(heap)
    resp = router.route(request_RCT)          # pre-batched [R, C, T] round
    out = router.route_flat(op, size, ptr)    # flat stream, any N <= R*C*T
    out = router.route_flat(op, size, ptr, placement="least_loaded")
    router.stats                              # totals + per-rank breakdown

Three pieces stand alone so the serving engines share them:

  * **placement**: the :data:`PLACEMENTS` registry maps a policy name to a
    slot policy ``fn(n, shape, loads=None, start=0) -> int array [n]`` of
    flat grid slot ids (slot ``(r, c, t)`` has id ``(r*C + c)*T + t``), and
    :func:`tenant_core` derives a sticky (rank, core) homing for the i-th
    admitted tenant under the same policy names (a tenant's frees and
    reallocs must reach the heap that served its mallocs: cores are
    independent); the migration and drain policies of the elastic tier
    sit beside them. All of it is host numpy;
  * **scatter/gather**: :func:`scatter_slots` / :func:`gather_slots` place
    a flat stream onto arbitrary slots (as tensors on a device) and invert
    it exactly (:func:`scatter_flat` / :func:`gather_flat` are the
    contiguous chunked special case);
  * **accounting**: :class:`FleetAccounting` accumulates
    `system.fleet_accounting` rounds into fleet totals + per-rank series.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..core import heap as heap_api
from ..core import system as sysm
from ..core.heap import AllocRequest, AllocResponse


# ---------------------------------------------------------------------------
# placement policies
# ---------------------------------------------------------------------------
def place_chunked(n: int, shape: tuple, loads=None, start: int = 0):
    """Contiguous row-major slots: request i -> slot start + i (mod cap).

    The original FleetRouter behavior — rank 0's cores fill first, matching
    a SimplePIM-style management layer handing contiguous work chunks to
    DPUs."""
    R, C, T = shape
    return (start + np.arange(n, dtype=np.int64)) % (R * C * T)


def place_round_robin(n: int, shape: tuple, loads=None, start: int = 0):
    """Stripe across ranks first, then cores, then thread slots: consecutive
    requests land on different ranks, spreading a small burst fleet-wide."""
    R, C, T = shape
    i = start + np.arange(n, dtype=np.int64)
    rank = i % R
    core = (i // R) % C
    th = (i // (R * C)) % T
    return (rank * C + core) * T + th


def place_least_loaded(n: int, shape: tuple, loads=None, start: int = 0):
    """Fill the thread slots of the least-loaded (rank, core) first.

    ``loads`` is a [R, C] (or flat [R*C]) per-core load signal — live bytes,
    outstanding ops, whatever the caller tracks; ties break row-major. With
    no loads this degrades to chunked."""
    R, C, T = shape
    if loads is None:
        return place_chunked(n, shape, start=start)
    order = np.argsort(np.asarray(loads, np.float64).reshape(-1),
                       kind="stable")
    slots = (order[:, None] * T + np.arange(T)[None, :]).reshape(-1)
    if n > slots.shape[0]:
        raise ValueError(f"{n} requests > fleet capacity {R * C * T}")
    return slots[:n].astype(np.int64)


PLACEMENTS = {
    "chunked": place_chunked,
    "round_robin": place_round_robin,
    "least_loaded": place_least_loaded,
}


def tenant_core(policy: str, i: int, shape: tuple, loads=None,
                expected_tenants: int = None) -> tuple:
    """Sticky (rank, core) homing for the i-th admitted tenant.

    All of a tenant's ops must reach the SAME per-core heap (pointers are
    core-local), so the serving tier places tenants, not single requests:

      * ``chunked``      — contiguous tenant blocks per core in row-major
        order (block size ``ceil(expected_tenants / (R*C))``, default 1);
      * ``round_robin``  — tenant i -> rank i % R, core (i // R) % C;
      * ``least_loaded`` — the core with the smallest ``loads`` entry
        (falls back to chunked blocks when no loads are tracked yet).

    A policy registered in :data:`PLACEMENTS` without a homing rule here is
    an error — it must not silently degrade to chunked homing.
    """
    R, C, T = shape
    if policy not in PLACEMENTS:
        raise ValueError(f"unknown placement {policy!r} "
                         f"(have {tuple(PLACEMENTS)})")
    if policy == "round_robin":
        return int(i % R), int((i // R) % C)
    if policy == "least_loaded" and loads is not None:
        flat = int(np.argmin(np.asarray(loads, np.float64).reshape(-1)))
        return flat // C, flat % C
    if policy not in ("chunked", "least_loaded"):
        raise ValueError(f"no tenant-homing rule for placement {policy!r}")
    chunk = max(1, -(-int(expected_tenants or R * C) // (R * C)))
    j = (i // chunk) % (R * C)
    return j // C, j % C


# ---------------------------------------------------------------------------
# migration + drain policies (the elastic tier's declarative hooks)
# ---------------------------------------------------------------------------
# A migration policy answers "pressure diverged — which tenants move where":
#     fn(pressure, homes, tenant_bytes, loads, shape, dead=frozenset(),
#        max_moves=1) -> [(tenant, (rank, core)), ...]
# with ``pressure`` a `repro_torch.core.telemetry.hwm_divergence` dict, ``homes``
# the planner's {tenant: (rank, core)}, ``tenant_bytes`` {tenant: tracked
# live bytes}, ``loads`` the [R, C] live-bytes signal, and ``dead`` the
# killed cores. A drain policy answers "at which rounds may the fleet pause
# to decide": fn(traffic, check_rounds) -> sorted round list. The elastic
# engine looks policies up by name in MIGRATIONS / DRAINS, as the serving
# engines do in PLACEMENTS.


def migrate_hottest_tenant(pressure, homes, tenant_bytes, loads, shape,
                           dead=frozenset(), max_moves: int = 1):
    """Move the biggest tenant(s) homed on the hottest rank to the
    least-loaded live core off that rank; ties break by tenant id."""
    R, C, T = shape
    hot = pressure["hottest_rank"]
    victims = sorted((k for k, (rk, _) in homes.items() if rk == hot),
                     key=lambda k: (-tenant_bytes.get(k, 0), k))
    masked = np.asarray(loads, np.float64).copy()
    masked[hot, :] = np.inf
    for d in dead:
        masked[d] = np.inf
    moves = []
    for k in victims[:max_moves]:
        if not np.isfinite(masked).any():
            break
        flat = int(np.argmin(masked.reshape(-1)))
        dst = (flat // C, flat % C)
        masked[dst] += tenant_bytes.get(k, 0)
        moves.append((k, dst))
    return moves


def migrate_none(pressure, homes, tenant_bytes, loads, shape,
                 dead=frozenset(), max_moves: int = 1):
    """Baseline: never move anything (the migration-off bench arm)."""
    return []


MIGRATIONS = {
    "hottest_tenant": migrate_hottest_tenant,
    "none": migrate_none,
}


def drain_epoch(traffic, check_rounds: int):
    """Decide only at epoch boundaries — the free drain point: Temp blocks
    die at the reset, so a migrating tenant drags no Temp state along.
    Falls back to no drain points when the traffic has no epoch mode."""
    E = traffic.epoch_rounds
    if not E:
        return []
    return list(range(E, traffic.rounds, E))


def drain_interval(traffic, check_rounds: int):
    """Decide every ``check_rounds`` rounds regardless of epoch mode."""
    step = max(1, int(check_rounds))
    return list(range(step, traffic.rounds, step))


def drain_never(traffic, check_rounds: int):
    return []


DRAINS = {
    "epoch": drain_epoch,
    "interval": drain_interval,
    "none": drain_never,
}


# ---------------------------------------------------------------------------
# scatter / gather
# ---------------------------------------------------------------------------
def scatter_slots(op, size, ptr, shape: tuple, slots,
                  device="cuda") -> AllocRequest:
    """Flat per-request arrays -> one [R, C, T] round at explicit grid
    slots, as int32 tensors on `device` (the card unless the caller asks
    for the CPU).

    ``slots`` are distinct flat slot ids (see the module docstring);
    unfilled slots become NOOPs. ``gather_slots`` with the same slots is
    the exact inverse."""
    R, C, T = shape
    total = R * C * T
    op = np.asarray(op, np.int32)
    slots = np.asarray(slots, np.int64)
    n = op.shape[0]
    if slots.shape[0] != n:
        raise ValueError(f"{n} requests but {slots.shape[0]} slots")
    if n > total:
        raise ValueError(f"{n} requests > fleet capacity {total} ({shape})")
    if n and (slots.min() < 0 or slots.max() >= total):
        raise ValueError(f"slot ids out of range [0, {total})")
    if np.unique(slots).shape[0] != n:
        raise ValueError("duplicate slot ids in one round")
    dev = _device.resolve(device)

    def pad(x, fill):
        out = np.full((total,), fill, np.int32)
        out[slots] = np.asarray(x, np.int32)
        return torch.from_numpy(out.reshape(R, C, T)).to(dev)

    return AllocRequest(op=pad(op, heap_api.OP_NOOP), size=pad(size, 0),
                        ptr=pad(ptr, -1))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def gather_slots(resp: AllocResponse, slots) -> dict:
    """[R, C, T] response -> flat host arrays in the original request
    order."""
    slots = np.asarray(slots, np.int64)
    return {f: _host(getattr(resp, f)).reshape(-1)[slots]
            for f in AllocResponse._fields}


def scatter_flat(op, size, ptr, shape: tuple, device="cuda") -> AllocRequest:
    """Flat per-request arrays (length N <= R*C*T) -> one [R, C, T] round.

    Unfilled slots become NOOPs; slot order is row-major (chunked), so
    `gather_flat` with the same N is the exact inverse."""
    n = np.asarray(op, np.int32).shape[0]
    return scatter_slots(op, size, ptr, shape, place_chunked(n, shape),
                         device=device)


def gather_flat(resp: AllocResponse, n: int) -> dict:
    """[R, C, T] response -> flat host arrays in the original request
    order."""
    return {f: _host(getattr(resp, f)).reshape(-1)[:n]
            for f in AllocResponse._fields}


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
class FleetAccounting:
    """Accumulates `system.fleet_accounting` rounds: totals + per-rank."""

    TOTALS = ("ops", "ok", "latency_cyc", "backend_cyc", "meta_hits",
              "meta_misses", "dram_bytes")

    def __init__(self, num_ranks: int):
        self.rounds = 0
        self.totals = {k: 0.0 for k in self.TOTALS}
        self.per_rank_latency_cyc = np.zeros(num_ranks)
        self.per_rank_ops = np.zeros(num_ranks, np.int64)
        self.per_rank_dram_bytes = np.zeros(num_ranks, np.int64)

    def add_round(self, request: AllocRequest, resp: AllocResponse) -> dict:
        """Account one [R, C, T] round (tensors or host arrays); returns the
        round's accounting."""
        acct = sysm.fleet_accounting(request, resp)
        self.rounds += 1
        for k in self.totals:
            self.totals[k] += acct[k]
        pr = acct.get("per_rank")
        if pr:
            self.per_rank_latency_cyc += np.asarray(pr["latency_cyc"])
            self.per_rank_ops += np.asarray(pr["ops"], np.int64)
            self.per_rank_dram_bytes += np.asarray(pr["dram_bytes"],
                                                   np.int64)
        return acct

    def summary(self, freq_hz: float) -> dict:
        """Accumulated fleet accounting across all added rounds."""
        ops = max(self.totals["ops"], 1)
        return {
            "rounds": self.rounds,
            **{k: (int(v) if k not in ("latency_cyc", "backend_cyc")
                   else float(v)) for k, v in self.totals.items()},
            "us_per_op": self.totals["latency_cyc"] / ops / freq_hz * 1e6,
            "dram_bytes_per_op": self.totals["dram_bytes"] / ops,
            "per_rank": {
                "ops": self.per_rank_ops.tolist(),
                "latency_cyc": self.per_rank_latency_cyc.tolist(),
                "dram_bytes": self.per_rank_dram_bytes.tolist(),
            },
        }


class FleetRouter:
    """Scatter/step/gather driver + cost accounting for one ShardedHeap
    (on the heap's device)."""

    def __init__(self, heap: heap_api.ShardedHeap):
        self.heap = heap
        self.acct = FleetAccounting(heap.num_ranks)
        self._core_ops = np.zeros((heap.num_ranks, heap.num_cores), np.int64)

    @property
    def shape(self) -> tuple:
        return self.heap.shape

    @property
    def rounds(self) -> int:
        return self.acct.rounds

    @property
    def capacity(self) -> int:
        """Requests servable per round: one per fleet hardware thread."""
        R, C, T = self.shape
        return R * C * T

    @property
    def core_loads(self) -> np.ndarray:
        """[R, C] cumulative routed-op counts: the default load signal for
        ``least_loaded`` placement (activity, not residency: the router
        has no pointer lifetimes; the serving tier tracks live bytes)."""
        return self._core_ops

    def route(self, request: AllocRequest) -> AllocResponse:
        """Serve one pre-batched [R, C, T] round and account for it."""
        resp = self.heap.step(request)
        self.acct.add_round(request, resp)
        self._core_ops += (_host(request.op) != heap_api.OP_NOOP).sum(axis=2)
        return resp

    def route_flat(self, op, size, ptr, placement: str = "chunked",
                   slots=None) -> dict:
        """Serve a flat request stream; returns flat response arrays + the
        full AllocResponse under 'resp' and the grid slots used under
        'slots'. ``placement`` picks the slot policy (:data:`PLACEMENTS`).

        Pointer locality: a FREE/REALLOC must reach the core that produced
        its pointer. ``chunked`` / ``round_robin`` are pure functions of
        the request index, so a free stream in the same order as its alloc
        stream lands on the same cores; ``least_loaded`` is stateful
        (loads change between rounds), so pointer-carrying streams must pin
        their placement by passing the alloc round's returned ``slots``
        back via ``slots=``."""
        n = np.asarray(op).shape[0]
        if slots is None:
            if placement == "least_loaded" and np.any(np.asarray(ptr) >= 0):
                raise ValueError(
                    "least_loaded placement is stateful: pointer-carrying "
                    "streams (FREE/REALLOC) must pin the producing round's "
                    "slots via slots= or they may land on the wrong core")
            slots = PLACEMENTS[placement](n, self.shape,
                                          loads=self.core_loads)
        resp = self.route(scatter_slots(op, size, ptr, self.shape, slots,
                                        device=self.heap.device))
        out = gather_slots(resp, slots)
        out["resp"] = resp
        out["slots"] = slots
        return out

    @property
    def stats(self) -> dict:
        """Accumulated fleet accounting across all routed rounds."""
        return self.acct.summary(self.heap.cfg.dpu.freq_hz)
