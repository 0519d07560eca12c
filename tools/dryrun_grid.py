#!/usr/bin/env python3
"""Run the whole dry-run grid (10 arches x 4 shapes x 2 production meshes)
in parallel processes and print its table.

    python3 tools/dryrun_grid.py [--jobs 8] [--out DIR] [--device cuda]

Each (arch, shape) runs as ``python -m repro_torch.launch.dryrun --arch A
--shape S --both-meshes --out DIR`` in its own process (a full-shape
train cell records up to ~10^6 ops on fake tensors, minutes of host
time), `--jobs` at a time; then the 80 JSON results under DIR are read
back and printed as one markdown table (a row per arch, a column per
shape; in each cell TFLOP / memory TB / peak GB, starred where it does
not fit one card / state GB per device on 16x16, 2x16x16 / the larger
roofline term: the one-device program is the same on both meshes) and
one JSON line of totals. Exits non-zero if a cell failed. ``--no-run``
prints the table of the results already in DIR.
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


def run_cell(arch, shape, out, device):
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = Path(out) / f"{arch}__{shape}.log"
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--both-meshes", "--out", str(out),
             "--device", device], stdout=f, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT).returncode
    return arch, shape, rc, time.perf_counter() - t0


def cell(a, b):
    """One table cell from an (arch, shape)'s 16x16 and 2x16x16 results:
    TFLOP / memory TB / peak GB (fits one card) / state GB per device on
    each mesh / the roofline's larger term."""
    if a["status"] != "ok":
        return a["status"]
    x, rf = a["op_analysis"], a["roofline"]
    st = [sum(r["state_bytes_per_device"].values()) / 1e9 for r in (a, b)]
    return (f"{x['flops'] / 1e12:.4g} / {x['memory_bytes'] / 1e12:.4g} / "
            f"{x['peak_bytes'] / 1e9:.4g}{'' if a['fits_one_card'] else '*'}"
            f" / {st[0]:.3g}, {st[1]:.3g} / "
            f"{rf['bottleneck'].split('_')[0]}")


def table(out, archs, shapes):
    """Print the grid under `out` as one markdown table: a row per arch,
    a column per shape."""
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---" * (len(shapes) + 1) + "|")
    for arch in archs:
        cells = []
        for shape in shapes:
            paths = [Path(out) / f"{arch}__{shape}__{m}.json"
                     for m in ("16_16", "2_16_16")]
            cells.append(cell(*(json.loads(p.read_text()) for p in paths))
                         if all(p.exists() for p in paths) else "no result")
        print(f"| {arch} | " + " | ".join(cells) + " |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-run", action="store_true",
                    help="print the table of the results already in --out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models.config import SHAPES
    if args.no_run:
        table(args.out, configs.ARCHS, tuple(SHAPES))
        return 0
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s) for a in configs.ARCHS for s in SHAPES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        done = list(ex.map(lambda c: run_cell(*c, args.out, args.device),
                           cells))
    failed = [(a, s) for a, s, rc, _ in done if rc != 0]
    table(args.out, configs.ARCHS, tuple(SHAPES))
    secs = {f"{a}/{s}": round(t, 1) for a, s, _, t in done}
    print(json.dumps({"cells": 2 * len(cells), "failed": failed,
                      "wall_s": round(time.perf_counter() - t0, 1),
                      "cell_s": secs}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
