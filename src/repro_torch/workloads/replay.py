"""Closed-loop tape replay through the port's backends.

    PYTHONPATH=src python -m repro_torch.workloads.replay \\
        benchmarks/tapes/*.json [--kinds all|sw,hwsw,...] [--check] \\
        [--device cuda|cpu]

Replays a recorded `Trace` round by round through `heap.step` on one core:
each round's pointer operands are resolved on the device from a slot file
of the pointers THIS backend returned earlier in the replay, so the tape is
a real workload, not a transplant of foreign pointers.

Every replay emits a heap-health report: op/ok/fail counts, dropped frees,
modeled latency stats, and the telemetry of `repro_torch.core.telemetry`.
``--check`` verifies the cross-backend contract on each tape:

  * the tape is clean by `trace_lint`;
  * every kind's response stream matches its committed ``expect`` block
    (the port's ``fused`` kind the reference's ``pallas`` block; the arena
    kinds replayed with ``arena_inner="fused"`` their own blocks too);
  * ``fused`` == ``hwsw`` on the full response stream (kernel parity) and
    ``sw`` == ``hwsw`` on the semantic fields (ptr/ok/path/moved: the
    metadata cache may only change latencies and counters);
  * the conservation residual is zero for every kind.

Exit code 1 on any violation.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import heap, system as sysm, telemetry
from ..core.heap import AllocRequest, AllocResponse
from .trace import Trace, response_digest, trace_lint

# the reference's expect block each port kind is held to (else its own)
EXPECT_KEY = {"fused": "pallas"}
PARITY_PAIRS = (("fused", "hwsw", "full"), ("sw", "hwsw", "semantic"))


def _make_cfg(trace: Trace, kind: str,
              arena_inner: str = "hwsw") -> sysm.SystemConfig:
    return sysm.SystemConfig(kind=kind, heap_bytes=trace.heap_bytes,
                             num_threads=trace.num_threads,
                             arena_inner=arena_inner)


class SlotFile:
    """Pointer operands of an [R, C, T] tape, resolved on the device.

    Slot ``r * T + t`` of core c holds the pointer that round r, thread t
    returned on this backend; `request(r)` resolves round r's refs against
    it (a ref of -1 takes the raw operand), `record(r, ...)` fills it."""

    def __init__(self, op, size, ptr_ref, ptr_raw):
        self.op, self.size, self.ref, self.raw = op, size, ptr_ref, ptr_raw
        R, C, T = op.shape
        self.slots = torch.full((C, R * T), -1, dtype=torch.int32,
                                device=op.device)

    def request(self, r) -> AllocRequest:
        ref = self.ref[r]
        got = self.slots.gather(
            1, torch.clamp(ref, 0, self.slots.shape[1] - 1).long())
        return AllocRequest(self.op[r], self.size[r],
                            torch.where(ref >= 0, got, self.raw[r]))

    def record(self, r, req: AllocRequest, resp: AllocResponse):
        # a slot records the op's SURVIVING pointer: a failed relocating
        # realloc leaves the old block intact (C contract), so later refs to
        # the realloc slot resolve to the still-live old pointer, not NULL
        T = req.op.shape[-1]
        survived = ((req.op == heap.OP_REALLOC) & (req.size > 0)
                    & (resp.ptr < 0) & (req.ptr >= 0))
        self.slots[:, r * T:(r + 1) * T] = torch.where(survived, req.ptr,
                                                       resp.ptr)


def replay_rounds(cfg, state, op, size, ptr_ref, ptr_raw):
    """Step over [R, C, T] tape tensors, resolving refs from the slot file
    on the device. Returns (state, AllocResponse with [R, C, T] leaves)."""
    slots = SlotFile(op, size, ptr_ref, ptr_raw)
    resps = []
    for r in range(op.shape[0]):
        req = slots.request(r)
        state, resp = heap.step(cfg, state, req)
        slots.record(r, req, resp)
        resps.append(resp)
    return state, AllocResponse(*(torch.stack(f) for f in zip(*resps)))


def replay(trace: Trace, kind: str = "sw", device="cuda",
           arena_inner: str = "hwsw"):
    """Replay one tape on one backend, on one core; the arena kinds spill
    to ``arena_inner`` (``hwsw`` or ``fused``: the same results).

    Returns (resps, state, report): the stacked [R, T] AllocResponse (on the
    device), the final SystemState, and the heap-health report dict."""
    cfg = _make_cfg(trace, kind, arena_inner)
    state = heap.init(cfg, device=device)
    dev = state.telem.live_bytes.device

    def tape(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None]

    state, resps = replay_rounds(cfg, state, tape(trace.op),
                                 tape(trace.size), tape(trace.ptr_ref),
                                 tape(trace.ptr_raw))
    resps = AllocResponse(*(x[:, 0] for x in resps))

    def host(x):
        return x.detach().cpu().numpy()

    op = trace.op
    path, ok, lat = host(resps.path), host(resps.ok), host(resps.latency_cyc)
    is_alloc = np.isin(op, (heap.OP_MALLOC, heap.OP_CALLOC))
    is_re = op == heap.OP_REALLOC
    re_free0 = is_re & (trace.size <= 0) & (trace.ptr_raw >= 0)
    freeish = (op == heap.OP_FREE) | re_free0
    active = op != heap.OP_NOOP
    freq = cfg.dpu.freq_hz
    round_max_cyc = lat.max(axis=1) if lat.size else np.zeros((0,))
    report = {
        "name": trace.name,
        "kind": kind,
        "device": str(dev),
        "rounds": trace.rounds,
        "ops": int(active.sum()),
        "ok_ops": int(ok.sum()),
        "malloc_ops": int((op == heap.OP_MALLOC).sum()),
        "calloc_ops": int((op == heap.OP_CALLOC).sum()),
        "realloc_ops": int(is_re.sum()),
        "free_ops": int((op == heap.OP_FREE).sum()),
        "failed_allocs": int(((is_alloc | is_re) & active & ~ok).sum()),
        "dropped_frees": int((freeish & (path == 2)).sum()),
        "moved_reallocs": int(host(resps.moved).sum()),
        "us_per_op": float(lat[active].mean() / freq * 1e6)
        if active.any() else 0.0,
        "max_us": float(lat.max() / freq * 1e6) if lat.size else 0.0,
        "modeled_wall_us": float(round_max_cyc.sum() / freq * 1e6),
        "meta_dram_bytes": int(host(resps.dram_bytes).sum()),
        "digest_full": response_digest(resps),
        "digest_sem": response_digest(resps, semantic_only=True),
        "telemetry": telemetry.snapshot(cfg, state),
    }
    if kind != "strawman":
        report["stats_dropped_frees"] = int(state.alloc.stats.dropped_frees[0])
    return resps, state, report


def replay_all_kinds(trace: Trace, kinds=None, device="cuda") -> dict:
    """{kind: (resps, report)} over the registry (or an explicit subset)."""
    out = {}
    for kind in (kinds or heap.kinds()):
        resps, _, report = replay(trace, kind, device)
        out[kind] = (resps, report)
    return out


def check_trace(trace: Trace, kinds=None, results=None, device="cuda") -> list:
    """Verify the cross-backend contract; returns error strings.
    ``results`` reuses prior {kind: report} replays (else every kind
    replays here)."""
    errs = list(trace_lint(trace))
    if results is None:
        results = {k: rep for k, (_, rep) in
                   replay_all_kinds(trace, kinds, device).items()}
    for kind, rep in results.items():
        exp_key = EXPECT_KEY.get(kind, kind)
        exp = trace.expect.get(exp_key)
        if exp is None:
            errs.append(f"{trace.name}/{kind}: no committed expectation "
                        f"{exp_key!r}")
        else:
            for key in ("digest_full", "digest_sem", "ok_ops",
                        "dropped_frees"):
                if exp.get(key) != rep[key]:
                    errs.append(f"{trace.name}/{kind}: {key} {exp.get(key)!r}"
                                f" != {rep[key]!r}")
            for key in ("live_bytes", "hwm_bytes"):
                if exp.get(key) != rep["telemetry"][key]:
                    errs.append(f"{trace.name}/{kind}: telemetry {key} "
                                f"{exp.get(key)} != {rep['telemetry'][key]}")
        if rep["telemetry"]["conservation_residual"] != 0:
            errs.append(f"{trace.name}/{kind}: conservation residual "
                        f"{rep['telemetry']['conservation_residual']}")
    for a, b, level in PARITY_PAIRS:
        if a not in results or b not in results:
            continue
        key = "digest_full" if level == "full" else "digest_sem"
        if results[a][key] != results[b][key]:
            errs.append(f"{trace.name}: {a} != {b} on {level} response "
                        "stream")
    return errs


def expect_blocks(reports: dict) -> dict:
    """A tape's ``expect`` from {kind: replay report}, in the reference's
    layout: each kind's block under its `EXPECT_KEY`, the blocks sorted by
    that key, whatever order `heap.kinds()` gives (the reference's
    ``heap.kinds()`` is sorted), so a saved tape equals the reference's
    byte for byte."""
    return {EXPECT_KEY.get(kind, kind): {
        "digest_full": rep["digest_full"],
        "digest_sem": rep["digest_sem"],
        "ok_ops": rep["ok_ops"],
        "dropped_frees": rep["dropped_frees"],
        "live_bytes": rep["telemetry"]["live_bytes"],
        "hwm_bytes": rep["telemetry"]["hwm_bytes"],
    } for kind, rep in sorted(reports.items(),
                              key=lambda kv: EXPECT_KEY.get(kv[0], kv[0]))}


def attach_expectations(trace: Trace, kinds=None, device="cuda") -> dict:
    """Replay on every kind (or `kinds`) and set `trace.expect` to
    `expect_blocks` of the reports, in memory (nothing is written);
    returns the reports."""
    reports = {k: rep for k, (_, rep) in
               replay_all_kinds(trace, kinds, device).items()}
    trace.expect = expect_blocks(reports)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tapes", nargs="+", help="trace JSON files")
    ap.add_argument("--kinds", default="all",
                    help="comma-separated backend subset (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true",
                    help="verify committed digests; exit 1 on any mismatch")
    args = ap.parse_args(argv)
    kinds = None if args.kinds == "all" else tuple(args.kinds.split(","))

    failures = []
    for path in args.tapes:
        trace = Trace.load(path)
        reports = {k: rep for k, (_, rep) in
                   replay_all_kinds(trace, kinds, args.device).items()}
        if args.check:
            errs = check_trace(trace, results=reports)
            failures.extend(errs)
            status = "OK" if not errs else f"{len(errs)} MISMATCH(ES)"
            print(f"[{status}] {path}: {trace.rounds} rounds, "
                  f"{trace.ops} ops")
            for e in errs:
                print(f"  !! {e}")
        for kind, rep in reports.items():
            tel = rep["telemetry"]
            print(f"  {trace.name}/{kind}: ok={rep['ok_ops']}/{rep['ops']} "
                  f"dropped={rep['dropped_frees']} "
                  f"us/op={rep['us_per_op']:.3f} "
                  f"live={tel['live_bytes']} hwm={tel['hwm_bytes']} "
                  f"frag={tel['external_frag']:.2f}")
    if failures:
        print(f"{len(failures)} workload-replay check failure(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
