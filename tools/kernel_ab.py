#!/usr/bin/env python3
"""Time the heap-step and buddy-batch kernels of the checkout at ROOT on
chip_smoke's full-width inputs, and print the numbers as one JSON line.

    python3 tools/kernel_ab.py ROOT [--seed N] [--out F]

Heap step: chip_smoke's 512-core session (64 rounds, the paper's
geometry), its requests resolved once through ROOT's `heap.step`, then
replayed through ROOT's `fused_heap_step` from the initial state: CUDA
events per round over back-to-back launches, the kernel's device time per
launch from torch.profiler, and their difference, the wrapper's host time
per call. With the batched refill on and off where ROOT's wrapper takes
it.

Buddy batch: chip_smoke phase 8's trees (512 cores, 32 MiB heaps of 4 KiB
blocks) and request sizes, at B=1 (the copy in and out and one walk) and
at B=128 (the main path's batch), CUDA events and device time.

Needs one NVIDIA GPU. To compare two commits on one card, unpack the
other commit (``git archive``) into a git-ignored directory and run this
script on both checkouts in turns (parent, change, change, parent) in one
call.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # chip_smoke's tape generators
CORES, ROUNDS = 512, 64


def heap_numbers(cfg, fresh, reqs, step, refill, n_pass=2):
    """(events ms per round, device ms per launch, launches recorded) of
    `step` over `reqs` from fresh copies of the state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    kw = dict(cs.geometry(cfg))
    if refill is not None:
        kw["batch_refill"] = refill

    def run():
        leaves = [x.clone() for x in cs.state_args(fresh)]
        torch.cuda.synchronize()
        for req in reqs:
            step(*req, *leaves, **kw)

    run()
    ms = []
    for _ in range(n_pass):
        leaves = [x.clone() for x in cs.state_args(fresh)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for req in reqs:
            step(*req, *leaves, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / len(reqs))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us, seen = cs.kernel_events(prof)
    return sum(ms) / len(ms), (us / 1e3 / seen if seen else None), seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=Path, help="the checkout to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path[:0] = [str(HERE), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import buddy, heap, system as sysm
    from repro_torch.core.pim_malloc import PimMallocConfig
    from repro_torch.kernels import _build, heap_step
    from repro_torch.kernels import buddy_traverse as bt
    device = torch.device("cuda", 0)
    for name in ("heap_step", "buddy_traverse"):
        _build.load(name)
    res = {"root": str(args.root)}

    # ---- heap step ---------------------------------------------------------
    cfg = sysm.SystemConfig(
        kind="fused", heap_bytes=CONFIG.heap_bytes,
        num_threads=CONFIG.num_threads,
        pm=PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                           num_threads=CONFIG.num_threads,
                           size_classes=CONFIG.size_classes,
                           block_bytes=CONFIG.block_bytes))
    tape = cs.session_tape(np.random.default_rng(args.seed), ROUNDS, CORES,
                           cfg.num_threads)
    fresh = heap.init(cfg, num_cores=CORES, device=device)
    state = cs.clone_state(fresh)
    sess = cs.slot_file(tape, device)
    reqs = []
    for r in range(ROUNDS):
        req = sess.request(r)
        state, resp = heap.step(cfg, state, req)
        sess.record(r, req, resp)
        reqs.append(req)
    step = heap_step.fused_heap_step
    has_refill = "batch_refill" in inspect.signature(step).parameters
    settings = (True, False) if has_refill else (None,)
    for refill in settings + settings[::-1]:
        ev, dev, seen = heap_numbers(cfg, fresh, reqs, step, refill)
        key = {True: "on", False: "off", None: "serial"}[refill]
        res.setdefault(f"heap_{key}", []).append(
            dict(events_ms=ev, device_ms=dev, device_events=seen,
                 host_ms=None if dev is None else ev - dev))

    # ---- buddy batch -------------------------------------------------------
    heap_b, mb = CONFIG.heap_bytes, CONFIG.block_bytes
    bcfg = buddy.BuddyConfig(heap_bytes=heap_b, min_block=mb)
    tree0 = buddy.init(bcfg, device=device).longest.repeat(CORES, 1)
    rng = np.random.default_rng(args.seed + 8)
    sizes = torch.from_numpy(cs.buddy_sizes(rng, CORES, cs.BUDDY_BATCH)).to(
        device)
    kw = dict(heap_bytes=heap_b, min_block=mb)
    for label, s in (("b1", sizes[:, :1].contiguous()), ("b128", sizes)):
        for _ in range(2):
            ms, _, prof = cs.time_calls(
                lambda: bt.buddy_alloc_batch_kernel(tree0, s, **kw), n=20)
            dev, seen = cs.device_ms(prof, cs.BUDDY_KERNEL)
            res.setdefault(f"buddy_{label}", []).append(
                dict(events_ms=ms, device_ms=dev, device_events=seen))
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
