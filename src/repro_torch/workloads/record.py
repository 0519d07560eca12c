"""Record the workload tapes through the port.

    PYTHONPATH=src python -m repro_torch.workloads.record \\
        [--out DIR] [--scenarios all] [--full] [--kind hwsw] [--device cuda]

Records each scenario (`repro_torch.workloads.scenarios`) on ``--kind``
(the reference's ``hwsw`` by default; ``fused`` runs the heap-step kernel
once per round), replays it on every registered kind to fill the per-kind
``expect`` blocks, and writes the JSON tapes into ``--out`` (default
``build/tapes`` of the checkout, which git ignores). At the smoke sizes a
recording on ``hwsw`` equals the committed ``benchmarks/tapes/*.json``
byte for byte; compare with ``cmp``. The reference's tapes directory is
refused as ``--out``: a port run never rewrites them.
"""
from __future__ import annotations

import argparse
import os
import sys

from .replay import attach_expectations
from .scenarios import RECORD_KIND, SCENARIOS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
REFERENCE_TAPES = os.path.join(ROOT, "benchmarks", "tapes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tapes"))
    ap.add_argument("--scenarios", default="all")
    ap.add_argument("--full", action="store_true",
                    help="record the full-scale (non-smoke) variants")
    ap.add_argument("--kind", default=RECORD_KIND,
                    help="the kind that records (default: hwsw)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(REFERENCE_TAPES):
        ap.error(f"--out {args.out}: the reference's committed tapes are "
                 "not written by the port")
    names = (list(SCENARIOS) if args.scenarios == "all"
             else args.scenarios.split(","))
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        trace = SCENARIOS[name](smoke=not args.full, kind=args.kind,
                                device=args.device)
        reports = attach_expectations(trace, device=args.device)
        path = os.path.join(args.out, f"{name}.json")
        trace.save(path)
        print(f"wrote {path}: {trace.rounds} rounds / {trace.ops} ops; "
              + "; ".join(
                  f"{k}: ok={r['ok_ops']} dropped={r['dropped_frees']} "
                  f"live={r['telemetry']['live_bytes']}"
                  for k, r in sorted(reports.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
