#!/usr/bin/env python3
"""Host cost per call of two kernel wrappers of the checkout at ROOT, and
of the same launch behind each way of registering it as a torch
operator; prints one JSON line.

    python3 tools/op_cost.py ROOT [--calls N] [--out F]

Paged attention at granite-3-8b's decode shape (B=8, H=32, KVH=8, D=128,
page 128, 6 pages, bf16; chip_smoke phase 6) and one heap-step round at
the paper's width (C=512, T=16, 32 MiB heaps; phase 3's first round).
For each: host microseconds per call (the host clock over N back-to-back
calls, before the synchronise that ends them) and CUDA-event milliseconds
per call (what phase 6 reports: host-bound, so about the host cost),
each the median of `--reps` passes taken in turns over the routes (the
host's noise moves a pass by tens of percent). Routes for paged
attention: ROOT's wrapper as it is; its launcher called straight through
``ctypes`` (the floor); and, where ROOT has the kernels as operators
(``kernels/_library.py``), the operator's CUDA implementation called
directly (the launch without the dispatcher), the launch behind its
``torch.library.Library`` operator (as ROOT's wrapper calls it) and
behind a ``torch.library.custom_op`` defined here. For the heap round:
the wrapper and, where there is one, its CUDA implementation directly.

Needs one NVIDIA GPU. To compare two commits on one card, unpack the
other (``git archive``) into a git-ignored directory and run this script
on both in turns (parent, change, change, parent) in one call.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def host_us(fn, n):
    """(host microseconds per call over n back-to-back calls, CUDA-event
    ms per call) after warm-up: one pass."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return 1e6 * host / n, start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("op_cost: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import ctypes

    import numpy as np
    import chip_smoke as cs
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import heap, system as sysm
    from repro_torch.core.pim_malloc import PimMallocConfig
    from repro_torch.kernels import _build, heap_step
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda", 0)
    n = args.calls
    res = {"root": str(args.root), "calls": n}

    # ---- paged attention at granite's decode shape ------------------------
    g = torch.Generator(device="cpu").manual_seed(0)
    B, H, KVH, D, page, P = 8, 32, 8, 128, 128, 6
    q = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    kp = torch.randn(B * P, page, KVH, D, generator=g).to(dev,
                                                           torch.bfloat16)
    vp = torch.randn(B * P, page, KVH, D, generator=g).to(dev,
                                                           torch.bfloat16)
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    sl = torch.full((B,), 576, dtype=torch.int32, device=dev)
    args_pa = (q, kp, vp, pt, sl)
    routes = {"paged_attention": (lambda: pa.paged_attention(*args_pa), n)}

    lib = _build.load("paged_attention")
    pps, splits = pa.split_plan(B * KVH, P, pa.sm_count(dev))
    out = torch.empty_like(q)
    acc = torch.empty((B * KVH, splits, H // KVH, D), dtype=torch.float32,
                      device=dev)
    ml = torch.empty((B * KVH, splits, H // KVH, 2), dtype=torch.float32,
                     device=dev)
    V = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream

    def direct():
        lib.paged_attention_launch(
            V(q.data_ptr()), V(kp.data_ptr()), V(vp.data_ptr()),
            V(pt.data_ptr()), V(sl.data_ptr()), V(out.data_ptr()),
            V(acc.data_ptr()), V(ml.data_ptr()), 1, B, H, KVH, D, B * P,
            page, P, pps, splits, V(stream))

    routes["paged_attention_ctypes"] = (direct, n)
    if hasattr(pa, "_launch"):
        op = torch.ops.repro_torch.paged_attention.default
        routes["paged_attention_launch"] = (lambda: pa._launch(*args_pa), n)
        routes["paged_attention_library_op"] = (lambda: op(*args_pa), n)

        @torch.library.custom_op("op_cost_probe::paged_attention",
                                 mutates_args=(), device_types="cuda")
        def probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
            return pa._launch(q, k, v, t, s)

        @probe.register_fake
        def _(q, k, v, t, s):
            return torch.empty_like(q)

        routes["paged_attention_custom_op"] = (lambda: probe(*args_pa), n)

    # ---- one heap-step round at the paper's width --------------------------
    cfg = sysm.SystemConfig(
        kind="fused", heap_bytes=CONFIG.heap_bytes,
        num_threads=CONFIG.num_threads,
        pm=PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                           num_threads=CONFIG.num_threads,
                           size_classes=CONFIG.size_classes,
                           block_bytes=CONFIG.block_bytes))
    tape = cs.session_tape(np.random.default_rng(0), 1, 512,
                           cfg.num_threads)
    state = heap.init(cfg, num_cores=512, device=dev)
    req = cs.slot_file(tape, dev).request(0)
    leaves = cs.state_args(state)
    geom = cs.geometry(cfg)
    m = max(n // 4, 50)
    routes["heap_step"] = (
        lambda: heap_step.fused_heap_step(*req, *leaves, **geom), m)
    if hasattr(heap_step, "_launch"):
        flat = (*req, *leaves, geom["heap_bytes"], geom["block_bytes"],
                list(geom["size_classes"]), True)
        routes["heap_step_launch"] = (lambda: heap_step._launch(*flat), m)

    passes = {k: [] for k in routes}
    for _ in range(args.reps):
        for k, (fn, calls) in routes.items():
            passes[k].append(host_us(fn, calls))
    for k, got in passes.items():
        res[k] = {"host_us": statistics.median(h for h, _ in got),
                  "events_ms": statistics.median(e for _, e in got),
                  "host_us_passes": [h for h, _ in got]}
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
