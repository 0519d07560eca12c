"""pimcheck: static verifier for the allocator backends + tape linter.

The port of `repro.analysis.pimcheck`. Records one representative mixed
round of every registered backend (`heap.REGISTRY`) with
`trace_utils.record`, at three tiers:

  single   `heap.step` at C=1
  vmap     `heap.multicore_step` at C=2 (the core axis the reference vmaps)
  sharded  `heap.sharded_step` over R=2 ranks x C=2 cores

and runs the checker passes from `repro_torch.analysis.passes` over the
recorded ops. Also lints trace tapes (`workloads.trace.trace_lint`) and
self-tests the passes against the seeded-bug fixtures. On the card the
``fused`` kind records one ``repro_torch::heap_step`` kernel node a round,
which the passes check through its plain version.

CLI:

    python -m repro_torch.analysis.pimcheck --all-kinds --tapes --fixtures
    python -m repro_torch.analysis.pimcheck --kinds hwsw,fused --tiers single
    python -m repro_torch.analysis.pimcheck --all-kinds --device cpu

Entry points run on the card unless ``--device cpu`` (``device="cpu"``)
is given. The exit code is non-zero on any unsuppressed finding, tape-lint
error, or fixture the passes fail to flag. Findings are printed per target
and, when `$GITHUB_STEP_SUMMARY` is set, appended there as a markdown
table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import torch

from .. import device as _device
from ..core import heap, system as sysm
from ..workloads.trace import Trace, trace_lint
from . import trace_utils
from .fixtures import FIXTURES, fix_init, fix_request
from .passes import PASS_NAMES, TracedStep, run_passes

TIERS = ("single", "vmap", "sharded")
DEFAULT_TAPES = os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, os.pardir,
    "benchmarks", "tapes", "*.json")


def _mixed_request(num_threads: int, device="cuda") -> heap.AllocRequest:
    """A representative round exercising every op class, so the recording
    covers the malloc, free, realloc and calloc paths at once: one core's
    ``[1, T]`` request."""
    ops = [heap.OP_MALLOC, heap.OP_FREE, heap.OP_REALLOC, heap.OP_CALLOC,
           heap.OP_NOOP]
    mk = [64, 0, 256, 16, 0]
    pt = [-1, 4096, 8192, -1, -1]
    reps = (num_threads + len(ops) - 1) // len(ops)
    dev = _device.resolve(device)

    def row(xs):
        return torch.tensor([(xs * reps)[:num_threads]], dtype=torch.int32,
                            device=dev)

    return heap.AllocRequest(op=row(ops), size=row(mk), ptr=row(pt))


def _traced(fn, state, req, target, tier) -> TracedStep:
    rec, (state_out, resp) = trace_utils.record(fn, state, req)
    n_state = len(trace_utils.leaves(state))
    return TracedStep(
        target=target, tier=tier, recording=rec,
        state_in=rec.arguments[:n_state], req_in=rec.arguments[n_state:],
        state_out=rec.outputs[:len(trace_utils.leaves(state_out))],
        resp_out=rec.outputs[len(trace_utils.leaves(state_out)):])


def trace_kind(kind: str, tier: str = "single", heap_bytes: int = 1 << 18,
               num_threads: int = 4, device="cuda") -> TracedStep:
    """Record one backend round at one deployment tier."""
    dev = _device.resolve(device)
    cfg = sysm.SystemConfig(kind=kind, heap_bytes=heap_bytes,
                            num_threads=num_threads)
    req = _mixed_request(num_threads, dev)
    if tier == "single":
        fn = lambda s, r: heap.step(cfg, s, r)  # noqa: E731
        state = heap.init(cfg, device=dev)
    elif tier == "vmap":
        fn = lambda s, r: heap.multicore_step(cfg, s, r)  # noqa: E731
        state = heap.multicore_init(cfg, 2, device=dev)
        req = heap.AllocRequest(*(x.expand(2, -1).contiguous() for x in req))
    elif tier == "sharded":
        # the fleet round: the rank axis folded onto the core axis
        fn = lambda s, r: heap.sharded_step(cfg, s, r)  # noqa: E731
        state = heap.sharded_init(cfg, 2, 2, device=dev)
        req = heap.AllocRequest(*(x.expand(2, 2, -1).contiguous()
                                  for x in req))
    else:
        raise ValueError(f"unknown tier {tier!r} (want one of {TIERS})")
    return _traced(fn, state, req, kind, tier)


def trace_fixture(name: str, device="cuda") -> TracedStep:
    fn, _expect = FIXTURES[name]
    return _traced(fn, fix_init(device), fix_request(device),
                   f"fixture:{name}", "single")


def kernel_nodes(tr: TracedStep) -> dict:
    """{kernel operator: nodes} at the top level of a recording."""
    out = {}
    for op in tr.ops:
        if op.name.startswith("repro_torch::"):
            out[op.name] = out.get(op.name, 0) + 1
    return out


def check_kinds(kinds, tiers, passes=None, heap_bytes=1 << 18,
                num_threads=4, device="cuda"):
    """Run the passes over (kind, tier) pairs; returns (rows, active,
    suppressed) where rows summarize per-target results."""
    rows, active, suppressed = [], [], []
    for kind in kinds:
        for tier in tiers:
            tr = trace_kind(kind, tier, heap_bytes, num_threads, device)
            act, sup = run_passes(tr, passes)
            active.extend(act)
            suppressed.extend(sup)
            rows.append({
                "target": kind, "tier": tier,
                "ops": sum(1 for _ in trace_utils.iter_ops(tr.ops)),
                "kernel_nodes": kernel_nodes(tr),
                "findings": len(act), "suppressed": len(sup),
            })
    return rows, active, suppressed


def check_fixtures(passes=None, device="cuda"):
    """Self-test: every seeded-bug fixture must be flagged by its pass.

    Returns (rows, failures) — a failure is a fixture the passes missed.
    """
    rows, failures = [], []
    for name, (_fn, expect_pass) in FIXTURES.items():
        tr = trace_fixture(name, device)
        act, _sup = run_passes(tr, passes)
        hit = [f for f in act if f.pass_name == expect_pass]
        if not hit:
            failures.append(f"fixture {name}: expected a {expect_pass} "
                            "finding, got "
                            f"{[f.pass_name for f in act] or 'none'}")
        rows.append({"target": f"fixture:{name}", "tier": "single",
                     "ops": len(tr.ops), "findings": len(act),
                     "flagged_by_expected": bool(hit)})
    return rows, failures


def lint_tapes(paths):
    """trace_lint every tape; returns (rows, errors)."""
    rows, errors = [], []
    for path in paths:
        try:
            trace = Trace.load(path)
            errs = trace_lint(trace)
        except (ValueError, KeyError, OSError) as e:
            errs = [f"unreadable tape: {e}"]
            trace = None
        errors.extend(f"{os.path.basename(path)}: {e}" for e in errs)
        rows.append({"target": f"tape:{os.path.basename(path)}",
                     "tier": "-",
                     "rounds": trace.rounds if trace else 0,
                     "findings": len(errs)})
    return rows, errors


def _step_summary(rows, active, suppressed, tape_errors, fixture_failures):
    lines = ["## pimcheck", "",
             "| target | tier | findings | suppressed |",
             "|---|---|---:|---:|"]
    for r in rows:
        lines.append(f"| {r['target']} | {r['tier']} | {r['findings']} | "
                     f"{r.get('suppressed', 0)} |")
    lines.append("")
    for f in active:
        lines.append(f"- ❌ {f.fmt()}")
    for f, reason in suppressed:
        lines.append(f"- ⚠️ suppressed: {f.fmt()} — {reason}")
    for e in tape_errors:
        lines.append(f"- ❌ tape lint: {e}")
    for e in fixture_failures:
        lines.append(f"- ❌ {e}")
    if not (active or tape_errors or fixture_failures):
        lines.append("- ✅ all passes green")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pimcheck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all-kinds", action="store_true",
                    help="verify every kind in heap.REGISTRY")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated backend subset")
    ap.add_argument("--tiers", default=",".join(TIERS),
                    help=f"comma-separated tiers (default {','.join(TIERS)})")
    ap.add_argument("--passes", default=None,
                    help=f"comma-separated pass subset of {PASS_NAMES}")
    ap.add_argument("--tapes", nargs="*", default=None, metavar="PATH",
                    help="lint trace tapes (no paths: benchmarks/tapes/*)")
    ap.add_argument("--fixtures", action="store_true",
                    help="self-test the passes on the seeded-bug fixtures")
    ap.add_argument("--heap-bytes", type=int, default=1 << 18)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run: cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full report as JSON")
    args = ap.parse_args(argv)

    kinds = ()
    if args.all_kinds:
        kinds = heap.kinds()
    elif args.kinds:
        kinds = tuple(args.kinds.split(","))
    tiers = tuple(args.tiers.split(","))
    passes = tuple(args.passes.split(",")) if args.passes else None
    device = _device.resolve(args.device)

    rows, active, suppressed = check_kinds(
        kinds, tiers, passes, args.heap_bytes, args.threads, device)
    for f in active:
        print(f"FINDING {f.fmt()}")
    for f, reason in suppressed:
        print(f"suppressed {f.fmt()}\n  reason: {reason}")

    tape_rows, tape_errors = [], []
    if args.tapes is not None:
        paths = args.tapes or sorted(glob.glob(DEFAULT_TAPES))
        tape_rows, tape_errors = lint_tapes(paths)
        for e in tape_errors:
            print(f"TAPE LINT {e}")
    rows += tape_rows

    fixture_failures = []
    if args.fixtures:
        fx_rows, fixture_failures = check_fixtures(passes, device)
        rows += fx_rows
        for e in fixture_failures:
            print(f"FIXTURE MISS {e}")

    for r in rows:
        nodes = "".join(f" {k}={v}" for k, v in
                        r.get("kernel_nodes", {}).items())
        print(f"  {r['target']:<28} {r['tier']:<8} "
              f"findings={r['findings']} suppressed={r.get('suppressed', 0)}"
              + (f" ops={r['ops']}" if "ops" in r else "") + nodes)

    report = {
        "device": str(device),
        "rows": rows,
        "findings": [f.fmt() for f in active],
        "suppressed": [{"finding": f.fmt(), "reason": r}
                       for f, r in suppressed],
        "tape_errors": tape_errors,
        "fixture_failures": fixture_failures,
    }
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(report, fp, indent=1)
    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a") as fp:
            fp.write(_step_summary(rows, active, suppressed, tape_errors,
                                   fixture_failures))

    bad = len(active) + len(tape_errors) + len(fixture_failures)
    print(f"pimcheck: {len(rows)} target(s), {bad} failure(s), "
          f"{len(suppressed)} suppressed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
