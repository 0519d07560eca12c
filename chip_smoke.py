#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--out F]

Phases (each raises on failure; nothing is caught and carried on):

  1. versions, and the card's name and power limit from nvidia-smi;
  2. build ``heap_step.cu`` for sm_90a from the checkout's source;
  3. the CUDA kernel against its plain PyTorch version on the card, all 31
     outputs bit for bit, over the first rounds of the session stream at
     the paper's width (32 MiB heap, T=16, 8 classes, CAP=1024, C=512);
  4. the four committed tapes replayed through kind ``fused`` on the card:
     the reference's committed ``pallas`` digests, counts and telemetry,
     conservation residual 0;
  5. the main path: a 512-core session of 64 rounds through
     `heap.step`, its stream made from ``--seed`` (malloc / free / realloc /
     calloc / noop ~ 40/30/15/10/5 %, sizes log-uniform over 16 B - 16 KiB,
     each thread freeing or reallocating only its own live slots, resolved
     on the device); the kernel launch counter is reset just before and
     read just after; then the conservation residual of every core,
     kernel and plain-version timings (CUDA events, and the kernel's own
     device time from a torch.profiler trace, over the launches the trace
     recorded), and the device busy share of a few steps.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the port's sources beside the script.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TAPES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/heap_step.cu"
REPLACES = "src/repro/kernels/heap_step.py:569"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
INT_OPS_PER_S = 67e12       # non-tensor 32-bit peak (data sheet, fp32 rate)
CORES = 512          # the paper's core count (Table 3)
ROUNDS = 64          # rounds of the main-path session
CHECK_ROUNDS = 16    # session rounds held kernel against plain version
PLAIN_ROUNDS = 8     # rounds the plain version is timed over
PROFILE_ROUNDS = 10  # steps in the profiler window (2 of them warm-up)


def session_tape(rng, rounds, cores, threads):
    """A [R, C, T] tape of ops, sizes and slot refs: each thread frees or
    reallocates only slots it produced earlier and has not released."""
    import numpy as np
    shape = (rounds, cores, threads)
    kind = rng.choice(5, size=shape, p=[0.40, 0.30, 0.15, 0.10, 0.05])
    lo, hi = math.log(16), math.log(16 * 1024)
    sizes = np.exp(rng.uniform(lo, hi, size=shape)).astype(np.int32)
    op = np.zeros(shape, np.int32)
    size = np.zeros(shape, np.int32)
    ref = np.full(shape, -1, np.int32)
    live = [[[] for _ in range(threads)] for _ in range(cores)]
    for r in range(rounds):
        for c in range(cores):
            for t in range(threads):
                k, own = kind[r, c, t], live[c][t]
                slot = r * threads + t
                if k in (1, 2) and not own:
                    k = 0  # nothing live to free or move: malloc instead
                if k == 0:
                    op[r, c, t], size[r, c, t] = 1, sizes[r, c, t]
                    own.append(slot)
                elif k == 1:
                    op[r, c, t] = 2
                    ref[r, c, t] = own.pop(rng.integers(len(own)))
                elif k == 2:
                    op[r, c, t], size[r, c, t] = 3, sizes[r, c, t]
                    ref[r, c, t] = own.pop(rng.integers(len(own)))
                    own.append(slot)
                elif k == 3:
                    op[r, c, t], size[r, c, t] = 4, sizes[r, c, t]
                    own.append(slot)
    return op, size, ref


def slot_file(tape, device):
    """The session tape on the device, its refs resolved by a SlotFile."""
    import torch
    from repro_torch.workloads.replay import SlotFile
    op, size, ref = (torch.from_numpy(a).to(device) for a in tape)
    return SlotFile(op, size, ref, torch.full_like(ref, -1))


def state_args(state):
    al, ca = state.alloc, state.cache
    return [al.buddy.longest, al.counts, al.stacks, al.block_cls,
            al.block_free, al.big_log2, ca.tags, ca.last_used, ca.clock]


def clone_state(state):
    import torch
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(*(clone_state(x) for x in state))


def geometry(cfg):
    p = cfg.pm
    return dict(heap_bytes=p.heap_bytes, block_bytes=p.block_bytes,
                size_classes=p.size_classes)


def phase_kernel_vs_plain(cfg, state, tape, rounds, device):
    """Kernel and plain version on the same inputs, round by round; the
    carried state advances through heap.step. Returns max |difference|."""
    import torch
    from repro_torch.core import heap
    from repro_torch.kernels import heap_step
    sess = slot_file(tape, device)
    worst = 0
    for r in range(rounds):
        req = sess.request(r)
        leaves = state_args(state)
        plain = heap_step.protocol_round(*req, *leaves, **geometry(cfg))
        kern = heap_step.fused_heap_step(*req, *(x.clone() for x in leaves),
                                         **geometry(cfg))
        for name, a, b in zip(heap_step.FusedRoundOut._fields, kern, plain):
            if a.shape != b.shape:
                raise AssertionError(f"round {r}, output {name}: shape "
                                     f"{tuple(a.shape)} != {tuple(b.shape)}")
            diff = int((a.long() - b.long()).abs().max())
            worst = max(worst, diff)
            if diff:
                raise AssertionError(f"kernel != plain at round {r}, "
                                     f"output {name}: max |diff| {diff}")
        state, resp = heap.step(cfg, state, req)
        sess.record(r, req, resp)
    return worst


def phase_tapes(device):
    """The committed tapes through kind fused; returns kernel launches."""
    from repro_torch.kernels import heap_step
    from repro_torch.workloads import replay, trace
    before = heap_step.fused_heap_step.launches
    total_rounds = 0
    for name in TAPES:
        tape = trace.Trace.load(str(ROOT / "benchmarks" / "tapes" /
                                    f"{name}.json"))
        _, _, rep = replay.replay(tape, "fused", device=device)
        errs = replay.check_trace(tape, results={"fused": rep})
        if errs:
            raise AssertionError(f"tape {name}: " + "; ".join(errs))
        total_rounds += tape.rounds
        print(f"tape {name}: {tape.rounds} rounds, ok={rep['ok_ops']}/"
              f"{rep['ops']}, digest_full {rep['digest_full'][:16]}... "
              f"== expect[pallas], residual 0")
    launched = heap_step.fused_heap_step.launches - before
    if device.type == "cuda" and launched != total_rounds:
        raise AssertionError(f"tape replay launched the kernel {launched} "
                             f"times for {total_rounds} rounds")
    return launched


def round_bytes(rec, cfg, cores):
    """Least bytes one round must move for these inputs: requests and
    records, the cache, and the metadata words, tree nodes and stack
    entries this round's data reads or writes (each once)."""
    p = cfg.pm
    T = p.num_threads
    E = cfg.bc.n_entries
    s = {f: int(getattr(rec, f).sum()) for f in
         ("m_hit", "m_refill", "m_bypass", "m_lvdown", "m_lvup", "f_push",
          "f_big", "f_lvup", "valid_old")}
    n_malloc_backend = s["m_refill"] + s["m_bypass"]
    words = (cores * T * (3 + 22)                     # requests + records
             + cores * (4 * E + 2)                    # cache read + write
             + 2 * s["valid_old"]                     # realloc metadata
             + 4 * s["m_hit"]                         # pop + count + block
             + n_malloc_backend * 2                   # root read + leaf write
             + s["m_lvdown"] + 3 * s["m_lvup"]        # descent, up-walk
             + s["m_refill"] * (p.max_sub + 4)        # carve + metadata
             + s["m_bypass"]                          # big_log2
             + 4 * s["f_push"]                        # push + count + block
             + s["f_big"] * 4 + 3 * s["f_lvup"])      # coalescing walk
    return 4 * words


def round_ops(rec, cfg, cores):
    """Integer operations one round does for these inputs (a generous
    count: every thread's vector phases plus every LRU-and-tree step)."""
    T = cfg.pm.num_threads
    E = cfg.bc.n_entries
    steps = sum(int(getattr(rec, f).sum()) for f in
                ("m_hits", "m_miss", "f_hits", "f_miss"))
    return cores * T * 80 + steps * (3 * E + 12)


def time_kernel(cfg, fresh, reqs):
    """Times of the kernel over the recorded rounds, each pass from a fresh
    copy of the initial state (the kernel works in place).

    Pass 1 (untimed, also the warm-up) keeps every round's records. Pass 2
    launches back to back with a CUDA event between launches and keeps no
    output, so the caching allocator recycles the records' memory instead
    of allocating (a device allocation stalls the host inside the timed
    window). Pass 3 repeats pass 2 under torch.profiler for the kernel's own
    device time, without the host's enqueue gaps, averaged over the
    launches the trace recorded. Returns (event ms per round, per-round
    event ms, profiler device ms per launch or None, recorded launches,
    pass 1's records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import heap_step

    def run(keep, events=None):
        leaves = [x.clone() for x in state_args(fresh)]
        torch.cuda.synchronize()
        recs = []
        for r, req in enumerate(reqs):
            if events:
                events[r].record()
            out = heap_step.fused_heap_step(*req, *leaves, **geometry(cfg))
            if keep:
                recs.append(out)  # records are fresh tensors every launch
        if events:
            events[-1].record()
        torch.cuda.synchronize()
        return recs

    recs = run(keep=True)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(reqs) + 1)]
    run(keep=False, events=events)
    ms = [events[r].elapsed_time(events[r + 1]) for r in range(len(reqs))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(keep=False)
    dev_us, seen = kernel_events(prof)
    dev_ms = dev_us / 1e3 / seen if seen else None
    return (events[0].elapsed_time(events[-1]) / len(reqs), ms, dev_ms, seen,
            recs)


def kernel_events(prof):
    """(device µs, event count) of the fused kernel in a profiler trace."""
    us, n = 0.0, 0
    for e in prof.key_averages():
        if "heap_step_kernel" in e.key and device_us(e) > 0:
            us += device_us(e)
            n += e.count
    return us, n


def device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def time_plain(cfg, fresh, reqs):
    """Mean CUDA-event time of the plain version per round."""
    import torch
    from repro_torch.kernels import heap_step
    leaves = [x.clone() for x in state_args(fresh)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for req in reqs:
        out = heap_step.protocol_round(*req, *leaves, **geometry(cfg))
        leaves = list(out[:heap_step.N_STATE])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(reqs)


def profile_steps(cfg, fresh, reqs):
    """Device busy share of `heap.step` rounds, from a torch.profiler trace:
    (device ms per round, wall ms per round, launches per round, fused
    kernel launches the trace recorded, the top kernels by device time as
    (ms per round, launches in the window, name)). Device time is None
    where the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import heap
    state = clone_state(fresh)
    for req in reqs[:2]:  # warm-up outside the trace
        state, _ = heap.step(cfg, state, req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in reqs[2:]:
            state, _ = heap.step(cfg, state, req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(reqs) - 2
    dev, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0 and e.device_type.name == "CUDA":
            dev += us
            launches += e.count
            top.append((us / n / 1e3, e.count, e.key[:60]))
    top.sort(reverse=True)
    return (dev / n / 1e3 if dev > 0 else None), 1e3 * wall / n, \
        launches / n, kernel_events(prof)[1], top[:5]


def run(seed, device, cores=CORES, rounds=ROUNDS):
    import numpy as np
    import torch
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import heap, system as sysm, telemetry
    from repro_torch.core.pim_malloc import PimMallocConfig
    from repro_torch.kernels import heap_step

    cfg = sysm.SystemConfig(
        kind="fused", heap_bytes=CONFIG.heap_bytes,
        num_threads=CONFIG.num_threads,
        pm=PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                           num_threads=CONFIG.num_threads,
                           size_classes=CONFIG.size_classes,
                           block_bytes=CONFIG.block_bytes))
    C, T, R = cores, cfg.num_threads, rounds
    tape = session_tape(np.random.default_rng(seed), R, C, T)
    result = {"cores": C, "threads": T, "rounds": R, "seed": seed}

    # ---- 3: kernel against plain version, full width ----------------------
    t0 = time.perf_counter()
    fresh = heap.init(cfg, num_cores=C, device=device)
    state_mib = sum(x.numel() * 4 for x in state_args(fresh)) / 2 ** 20
    worst = phase_kernel_vs_plain(cfg, clone_state(fresh), tape,
                                  CHECK_ROUNDS, device)
    print(f"kernel == plain version, all 31 outputs, {CHECK_ROUNDS} "
          f"rounds at C={C} T={T} heap={cfg.heap_bytes >> 20} MiB "
          f"({state_mib:.0f} MiB of state): max |diff| {worst} "
          f"[{time.perf_counter() - t0:.1f} s]")

    # ---- 4: committed tapes through the kernel ----------------------------
    tape_launches = phase_tapes(device)
    print(f"tapes: kernel launched {tape_launches} times")

    # ---- 5: the main path, counters reset just before ---------------------
    state = clone_state(fresh)
    sess = slot_file(tape, device)
    reqs = []
    heap_step.fused_heap_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(R):
        req = sess.request(r)
        state, resp = heap.step(cfg, state, req)
        sess.record(r, req, resp)
        reqs.append(req)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = heap_step.fused_heap_step.launches
    if launches != R:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times in {R} rounds")
    resid = telemetry.conservation_residuals(cfg, state)
    if resid.shape != (C,) or np.any(resid != 0):
        raise AssertionError(f"conservation residual nonzero on "
                             f"{int(np.count_nonzero(resid))} cores")
    lat = resp.latency_cyc
    if lat.shape != (C, T) or not bool(torch.isfinite(lat).all()):
        raise AssertionError("non-finite or misshapen latencies")
    ops = int((sess.op != 0).sum())
    fails = int(state.alloc.stats.fails.sum())
    print(f"session: {R} rounds x {C} cores x {T} threads, {ops} ops, "
          f"{fails} failed allocs, residual 0 on all {C} cores; "
          f"step {1e3 * step_s / R:.3f} ms/round, "
          f"{ops / step_s:.4g} allocator ops/s")

    kernel_ms, round_ms, device_ms, seen, recs = time_kernel(cfg, fresh,
                                                             reqs)
    plain_rounds = min(PLAIN_ROUNDS, R)
    plain_ms = time_plain(cfg, fresh, reqs[:plain_rounds])
    nbytes = sum(round_bytes(rc, cfg, C) for rc in recs) / R
    nops = sum(round_ops(rc, cfg, C) for rc in recs) / R
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / INT_OPS_PER_S
    steps = max(int((rc.m_hits + rc.m_miss + rc.f_hits + rc.f_miss)
                    .sum(-1).max()) for rc in recs)
    dev = "not measured" if device_ms is None else \
        f"{device_ms:.4f} ms/launch over the {seen} of {R} launches the " \
        f"profiler recorded"
    print(f"kernel {kernel_ms:.4f} ms/round (CUDA events, back to back "
          f"after warm-up; per round min {min(round_ms):.4f}, max "
          f"{max(round_ms):.4f}); kernel device time {dev}; "
          f"plain version {plain_ms:.4f} ms/round over {plain_rounds} "
          f"rounds; bound {max(bytes_ms, ops_ms):.6f} ms "
          f"({nbytes:.0f} B, {nops:.0f} int ops per round); longest "
          f"per-core chain {steps} LRU-and-tree steps in one round")
    busy_ms, wall_ms, per_round, seen_steps, top = profile_steps(
        cfg, fresh, reqs[:PROFILE_ROUNDS])
    if busy_ms is None:
        print("profiler: no device time recorded; busy share not measured")
    else:
        short = "" if seen_steps == PROFILE_ROUNDS - 2 else \
            " (launches lost: the busy share is understated)"
        print(f"profiler over {PROFILE_ROUNDS - 2} steps: device busy "
              f"{busy_ms:.4f} of {wall_ms:.4f} ms/round "
              f"({100 * busy_ms / wall_ms:.1f} %), {per_round:.0f} device "
              f"launches/round, the fused kernel recorded {seen_steps} of "
              f"{PROFILE_ROUNDS - 2} times{short}; top: " + "; ".join(
                  f"{k} {ms:.4f} ms/round x{c}" for ms, c, k in top))
    result.update(step_ms=1e3 * step_s / R, ops_per_s=ops / step_s,
                  profile_busy_ms=busy_ms, profile_wall_ms=wall_ms,
                  profile_launches_per_round=per_round,
                  profile_kernel_events=seen_steps,
                  profile_top=[list(t) for t in top],
                  kernel_ms=kernel_ms, kernel_round_ms=round_ms,
                  kernel_device_ms=device_ms, kernel_device_events=seen,
                  plain_ms=plain_ms,
                  bytes_per_round=nbytes, ops_per_round=nops,
                  bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                  max_chain_steps=steps, state_mib=state_mib,
                  tape_launches=tape_launches)
    kernels = [{
        "name": "fused_heap_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]
    return result, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write results as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / KERNEL_SOURCE).exists():
        print("chip_smoke: the port's sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)

    # ---- 1: versions and the card -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    # ---- 2: build the kernel from source ----------------------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build("heap_step", verbose=True)
    _build.load("heap_step")
    print(f"built {KERNEL_SOURCE} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")

    result, kernels = run(args.seed, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, gpu=smi, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
