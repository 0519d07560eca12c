#!/usr/bin/env python3
"""Run the whole dry-run grid (10 arches x 4 shapes x 2 production meshes)
in parallel processes and print its tables.

    python3 tools/dryrun_grid.py [--jobs 8] [--out DIR] [--device cuda]

Each (arch, shape) runs as ``python -m repro_torch.launch.dryrun --arch A
--shape S --both-meshes --out DIR`` in its own process (a full-shape
train cell records up to ~10^6 ops on fake tensors, minutes of host
time), `--jobs` at a time; then the 80 JSON results under DIR are read
back and printed as two markdown tables, a row per arch and a column per
shape. The one-device table: TFLOP / memory TB / peak GB, starred where it
does not fit one card / state GB per device on 16x16, 2x16x16. The
per-device table (the SPMD program on fake worlds of 256 and 512 ranks),
for 16x16 then 2x16x16: collective GB a device / the collective term in
seconds at NVLink / whether the device's peak fits its card / the
roofline's largest term of three. Then one JSON line of totals. Exits
non-zero if a cell failed. ``--deadline S`` stops the cells still running
S seconds in (the cheapest shapes run first) and lists them as cut;
``--no-run`` prints the tables of the results already in DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the cheapest shapes first: on the H100's host a decode or long cell took
# 9-42 s, a train cell 58-627 s, a prefill cell 788-2350 s (8 jobs)
ORDER = ("decode_32k", "long_500k", "train_4k", "prefill_32k")


def run_cell(arch, shape, out, device, deadline):
    """One (arch, shape) on both meshes in its own process; killed at
    `deadline` (``time.monotonic()``), when its return code is None."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = Path(out) / f"{arch}__{shape}.log"
    left = deadline - time.monotonic()
    if left <= 0:
        return arch, shape, None, 0.0
    with open(log, "w") as f:
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--both-meshes", "--out", str(out),
                 "--device", device], stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT, timeout=left).returncode
        except subprocess.TimeoutExpired:
            rc = None
    return arch, shape, rc, time.perf_counter() - t0


def cell(a, b):
    """One-device table cell from an (arch, shape)'s 16x16 and 2x16x16
    results: TFLOP / memory TB / peak GB (fits one card) / state GB per
    device on each mesh."""
    if a["status"] != "ok":
        return a["status"]
    x = a["op_analysis"]
    st = [sum(r["state_bytes_per_device"].values()) / 1e9 for r in (a, b)]
    return (f"{x['flops'] / 1e12:.4g} / {x['memory_bytes'] / 1e12:.4g} / "
            f"{x['peak_bytes'] / 1e9:.4g}{'' if a['fits_one_card'] else '*'}"
            f" / {st[0]:.3g}, {st[1]:.3g}")


def spmd_cell(a, b):
    """Per-device table cell: for 16x16, then 2x16x16, collective GB a
    device / collective_s / fits its card / the largest roofline term."""
    if a["status"] != "ok":
        return a["status"]
    parts = []
    for r in (a, b):
        d = r["spmd_program"]
        if d["status"] != "ok":
            parts.append("per device: error")
            continue
        rf = r["roofline"]
        parts.append(f"{d['collective_bytes'] / 1e9:.4g} / "
                     f"{rf['collective_s']:.3g} / "
                     f"{'fits' if d['fits_per_device'] else 'no'} / "
                     f"{rf['bottleneck'].split('_')[0]}")
    return "; ".join(parts)


def table(out, archs, shapes, fmt=cell):
    """Print the grid under `out` as one markdown table of `fmt`'s cells:
    a row per arch, a column per shape."""
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---" * (len(shapes) + 1) + "|")
    for arch in archs:
        cells = []
        for shape in shapes:
            paths = [Path(out) / f"{arch}__{shape}__{m}.json"
                     for m in ("16_16", "2_16_16")]
            cells.append(fmt(*(json.loads(p.read_text()) for p in paths))
                         if all(p.exists() for p in paths) else "no result")
        print(f"| {arch} | " + " | ".join(cells) + " |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-run", action="store_true",
                    help="print the table of the results already in --out")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds after which running cells are stopped "
                         "and no new one starts (their results: no result)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models.config import SHAPES
    if args.no_run:
        table(args.out, configs.ARCHS, tuple(SHAPES))
        table(args.out, configs.ARCHS, tuple(SHAPES), spmd_cell)
        return 0
    os.makedirs(args.out, exist_ok=True)
    # the cheapest shapes first, so that a deadline cuts the fewest cells
    cells = [(a, s) for s in ORDER for a in configs.ARCHS]
    t0 = time.perf_counter()
    deadline = time.monotonic() + (args.deadline or float("inf"))
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        done = list(ex.map(lambda c: run_cell(*c, args.out, args.device,
                                              deadline), cells))
    failed = [(a, s) for a, s, rc, _ in done if rc]
    cut = [(a, s) for a, s, rc, _ in done if rc is None]
    table(args.out, configs.ARCHS, tuple(SHAPES))
    table(args.out, configs.ARCHS, tuple(SHAPES), spmd_cell)
    secs = {f"{a}/{s}": round(t, 1) for a, s, _, t in done}
    print(json.dumps({"cells": 2 * len(cells), "failed": failed,
                      "cut_at_deadline": cut,
                      "wall_s": round(time.perf_counter() - t0, 1),
                      "cell_s": secs}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
