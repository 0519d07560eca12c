"""Quickstart: the PIM-malloc allocator surface of the PyTorch port.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] \
        [--cores 8] [--rounds 64] [--kinds strawman,sw,hwsw,...]

The port of examples/quickstart.py. Three views of ONE protocol
(`repro_torch.core.heap`):
  1. the paper's Table-2 facade: initAllocator / pimMalloc / pimFree /
     pimRealloc / pimCalloc (a stateful handle, one `heap.step` a call),
  2. raw `heap.step` with a mixed-op `AllocRequest`,
  3. a `MultiCoreHeap` (C cores on an explicit core axis, one `heap.step`
     a round) raced across every registered kind with the DPU cost model.
     Kind ``fused`` (the reference's ``pallas``) runs the hand-written
     heap-step kernel on the card, one launch a round.

It runs on the card unless ``--device cpu`` is given, and raises without a
GPU. The last line counts the heap-step kernel's launches (0 on the CPU,
where ``fused`` runs the kernel's plain version).
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import heap, initAllocator
from repro_torch.core import system as sysm
from repro_torch.kernels import heap_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--kinds", default=",".join(sysm.KINDS),
                    help="comma-separated kinds of the race (default: all)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    heap_step.fused_heap_step.launches = 0

    # --- 1. Table 2 facade --------------------------------------------------
    a = initAllocator(1 << 20, device=dev)  # 1 MB heap, PIM-malloc-SW kind
    p1 = a.pimMalloc(100)       # thread-cache hit (128 B class)
    p2 = a.pimMalloc(100)
    p3 = a.pimMalloc(8192)      # bypass -> buddy backend
    print(f"pimMalloc: {p1=} {p2=} {p3=}")
    a.pimFree(p2)
    p4 = a.pimMalloc(100)       # LIFO: reuses p2's sub-block
    print(f"after free+malloc: {p4=} (== {p2=}: {p4 == p2})")
    p5 = a.pimRealloc(p4, 120)  # same 128 B class -> grows in place
    p6 = a.pimRealloc(p5, 300)  # 512 B class -> relocates (alloc+copy+free)
    print(f"pimRealloc: in-place {p5 == p4}, then moved to {p6=}")
    p7 = a.pimCalloc(64, 16)    # 1 KB zeroed -> 1024 B class
    a.pimFree(p1), a.pimFree(p3), a.pimFree(p6), a.pimFree(p7)
    print("stats:", a.stats)

    # --- 2. one mixed-op protocol round -------------------------------------
    cfg = sysm.SystemConfig(kind="hwsw", heap_bytes=1 << 20, num_threads=4)
    st = heap.init(cfg, device=dev)

    def i32(xs):
        return torch.tensor([xs], dtype=torch.int32, device=dev)  # [1, T]

    st, r0 = heap.step(cfg, st, heap.malloc_request(i32([64, 256, 64,
                                                          8192])))
    ptr0 = r0.ptr[0].tolist()
    req = heap.AllocRequest(
        op=i32([heap.OP_REALLOC, heap.OP_FREE, heap.OP_CALLOC,
                heap.OP_NOOP]),
        size=i32([512, 0, 96, 0]),
        ptr=i32([ptr0[0], ptr0[1], -1, -1]))
    st, r1 = heap.step(cfg, st, req)
    print("mixed round ptrs:", r1.ptr[0].cpu().numpy(), "paths:",
          r1.path[0].cpu().numpy(), f"moved: {r1.moved[0].cpu().numpy()}")

    # --- 3. multi-core race over the design points --------------------------
    C, R = args.cores, args.rounds
    print(f"\n{R} rounds x {C} cores x 16 threads x 32 B (DPU cost model):")
    for kind in args.kinds.split(","):
        cfg = sysm.SystemConfig(kind=kind, heap_bytes=1 << 22)
        mch = heap.MultiCoreHeap(cfg, num_cores=C, device=dev)
        reqs = heap.malloc_request(torch.full((R, C, 16), 32,
                                              dtype=torch.int32, device=dev))
        mch.state, resp = heap.run_rounds(cfg, mch.state, reqs)
        us = resp.latency_cyc.cpu().numpy() / cfg.dpu.freq_hz * 1e6
        print(f"  {kind:9s}: mean {us.mean():8.3f} us   p99 "
              f"{np.percentile(us, 99):8.3f} us")
    print(f"heap-step kernel launches: {heap_step.fused_heap_step.launches}")


if __name__ == "__main__":
    main()
