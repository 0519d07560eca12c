#!/usr/bin/env python3
"""Run chip_smoke's phase 7 (granite-3-8b served at full width) from the
checkout at ROOT and print its decode numbers as one JSON line.

    python3 tools/serve_phase.py ROOT [--seed N]

Needs one NVIDIA GPU. To compare two commits on one card, unpack the other
commit (``git archive``) into a git-ignored directory and run this script
on both checkouts in turns (parent, change, change, parent) in one call:
host times move between calls and machines, device times much less.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

KEYS = ("decode_ms_per_step", "tokens_per_s", "prefill_ms", "step_busy_ms",
        "step_wall_ms", "step_launches", "step_pa_device_ms", "pa_ms",
        "pa_device_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=Path, help="the checkout to run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("serve_phase: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke
    from repro_torch.kernels import _build
    for name in ("heap_step", "paged_attention"):
        _build.build(name)
    torch.cuda.init()  # phase 7 resets the memory stats first thing
    res, _ = chip_smoke.phase_serve(args.seed, torch.device("cuda", 0))
    print(json.dumps({"root": str(args.root),
                      **{k: res.get(k) for k in KEYS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
