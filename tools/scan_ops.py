#!/usr/bin/env python3
"""Count the PyTorch ops one `heap.step` round of a scan-based kind
(strawman, sw, hwsw) makes, per part of the round, on the host.

    PYTHONPATH=src python3 tools/scan_ops.py [--cores 64] [--rounds 6]

Serves the first `--rounds` rounds of chip_smoke's session stream (the
paper's config, `--seed`) at `--cores` cores on the CPU through each kind
and counts, for the last round, the ops PyTorch dispatches that are not
views: on the card each of them is about one kernel launch, which is
what a scan-based round's time follows. Prints one JSON line per kind:
the total and its split into the malloc phase, the free phase, the
metadata-cache sim and the pricing. Needs no GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

VIEWS = ("unsqueeze", "select", "slice", "view", "expand", "alias",
         "squeeze", "permute", "detach", "lift_fresh", "t.default")
PARTS = (("pim_malloc", "malloc"), ("pim_malloc", "free"),
         ("system", "strawman_malloc"), ("system", "strawman_free"),
         ("buddy_cache", "simulate_traces"), ("system", "_price_round"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cores", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    import chip_smoke as cs
    from repro_torch.core import buddy_cache, heap, pim_malloc, system

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(v in str(func) for v in VIEWS):
                self.n += 1
            return func(*args, **(kwargs or {}))

    mods = {"pim_malloc": pim_malloc, "system": system,
            "buddy_cache": buddy_cache}
    parts = collections.Counter()
    originals = {}

    def counted(name, fn):
        def run(*a, **k):
            with Count() as c:
                out = fn(*a, **k)
            parts[name] += c.n
            return out
        return run

    for mod, name in PARTS:
        originals[mod, name] = getattr(mods[mod], name)
        setattr(mods[mod], name, counted(name, originals[mod, name]))
    try:
        cpu = torch.device("cpu")
        tape = cs.session_tape(np.random.default_rng(args.seed),
                               args.rounds, args.cores, 16)
        for kind in ("hwsw", "sw", "strawman"):
            cfg = cs.paper_cfg(kind)
            state = heap.init(cfg, num_cores=args.cores, device=cpu)
            sess = cs.slot_file(tape, cpu)
            for r in range(args.rounds):
                parts.clear()
                req = sess.request(r)
                with Count() as c:
                    state, resp = heap.step(cfg, state, req)
                sess.record(r, req, resp)
            print(json.dumps({"kind": kind, "cores": args.cores,
                              "round": args.rounds - 1, "ops": c.n,
                              **{k: v for k, v in parts.items() if v}}))
    finally:
        for (mod, name), fn in originals.items():
            setattr(mods[mod], name, fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
