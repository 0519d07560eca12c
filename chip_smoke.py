#!/usr/bin/env python3
"""Drive the port's main paths on one NVIDIA GPU and check them end to end.

    python3 chip_smoke.py [--seed N] [--out F]

Phases (each raises on failure; nothing is caught and carried on):

  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the five kernels (``heap_step.cu``, ``paged_attention.cu``,
     ``buddy_traverse.cu``, ``freelist.cu``, ``flash_attention.cu``) for
     sm_90a from the checkout's sources, one ``nvcc`` each, started
     together;
  3. the CUDA kernel against its plain PyTorch version on the card, all 31
     outputs bit for bit, over the first rounds of the session stream at
     the paper's width (32 MiB heap, T=16, 8 classes, CAP=1024, C=512),
     with the batched run-carve refill on and off (both versions take the
     same setting); the share of core-rounds whose backend took each of
     the reference's three branches (skip, run-carve, serial walk),
     computed with the ported helpers on the pre-round state
     (`tools/heap_mutants.py` shows that the kernel takes the run-carve
     on just those core-rounds);
  4. the four committed tapes replayed through kind ``fused`` on the card
     with the batched refill on and off (``PIM_MALLOC_BATCH_REFILL``): the
     reference's committed ``pallas`` digests, counts and telemetry,
     conservation residual 0;
  5. the main path: a 512-core session of 64 rounds through
     `heap.step`, its stream made from ``--seed`` (malloc / free / realloc /
     calloc / noop ~ 40/30/15/10/5 %, sizes log-uniform over 16 B - 16 KiB,
     each thread freeing or reallocating only its own live slots, resolved
     on the device); the kernel launch counter is reset just before and
     read just after; then the conservation residual of every core,
     kernel and plain-version timings (CUDA events, and the kernel's own
     device time from a torch.profiler trace, over the launches the trace
     recorded; the kernel with the batched refill on and off on the same
     rounds, in turns), and the device busy share of a few steps;
 5b. the paper's scan-based design points (``strawman``, ``sw``,
     ``hwsw``: plain PyTorch rounds, no kernel of their own): the four
     tapes through each, held to its own committed ``expect`` block, and
     `check_trace` over all four kinds with phase 4's fused reports (lint
     clean, fused == hwsw in full, sw == hwsw on ptr/ok/path/moved,
     residual 0); then the first 16 rounds of phase 5's stream through
     hwsw, sw, strawman (its first 8) and fused from fresh states at
     C=512 in lockstep, each kind resolving its own slots: hwsw == fused
     on every response field and state leaf bit for bit, sw == hwsw on
     ptr/ok/path/moved and the allocator state, residual 0 on every core
     of every kind; each kind's ms per `heap.step` round (host clock,
     ending in a synchronise), and one more round under the profiler for
     its device launches and busy share;
 5c. the layered and checked design points and the sharded tier (plain
     PyTorch rounds; the arena kinds' spills over ``fused`` launch the
     heap kernel): (a) the four tapes through ``sanitizer``, ``arena`` and
     ``tlregion``, the arena kinds over ``hwsw`` and over ``fused``, each
     held to its kind's committed expect block, residual 0; (b) the first
     16 rounds of phase 5's stream with every 8th round an EPOCH_RESET on
     every core (lint clean), through arena and tlregion over each
     backend from fresh states in lockstep at C=512: over fused == over
     hwsw on every response field and state leaf every round, residual 0,
     the heap kernel's launches (counter set to 0 just before, read just
     after) and the share of core-rounds on which, by the responses, no
     thread needed its backend; (c) the sanitizer on the same stream
     without resets (every tag 0, FIFO quarantine, residual 0) and on a
     seeded misuse stream of 32 rounds, reset at round 24 (double frees,
     frees through pointers retired by moving reallocs, realloc after
     free, frees of blocks that left the quarantine, wild and misaligned
     pointers, stale pointers after a reset): the reports == the
     generator's counts on every core (the quarantine's parked and
     evicted counts included), FIFO quarantine, residual 0, and its first
     8 cores on the card == on the CPU; (d)
     ShardedHeap(R=4, C=128) == MultiCoreHeap(C=512) per (rank, core) on
     hwsw and fused over 8 rounds, and `fleet_pressure`; (e) each new
     kind's ms per round (host clock) and one profiled round (launches,
     busy share), and the phase's peak device memory;
 5d. the workload generators and the decode-serving engine (the heap
     kernel's launch counter set to 0 just before each path and read just
     after): (a) the four scenarios re-recorded at the reference's smoke
     sizes on ``hwsw`` with the seven kinds' expect blocks attached, each
     serialised byte-equal to its committed tape (in memory: nothing is
     written), and recorded again on ``fused``: the same requests (one
     kernel launch per recorded round); (b) the scenarios at the
     reference's ``record --full`` sizes on fused and on hwsw: equal tapes
     apart from ``recorded_kind``, lint clean, their replays fused ==
     hwsw in full with residual 0; (c) `graphupd.compare_all` at the
     paper's partition (384 nodes, 4000 + 2000 edges, 2 MiB heap) on every
     kind, the fused row == the hwsw row; (d) DecodeServe at
     benchmarks/fig_decode.py's full size (R=2, C=4, T=16, 1 MiB heaps, 96
     rounds, 6 sessions a round, 32 tenants) on fused and hwsw in
     lockstep through `ScanEngine.run_segment`, bit for bit, residual 0,
     each report == the CPU's on every field, the hottest tenant's core
     slice replayed bit for bit; (e) DecodeServe on the paper's fleet
     (R=4, C=128, T=16, 32 MiB heaps, 96 rounds, 2048 tenants, ``FLEET_RATE``
     sessions a round) on fused and hwsw in lockstep, bit for bit,
     residual 0, the kernel launched once a round; ms per round per kind
     (host clock), one profiled round's launches and busy share, the
     planner's host seconds and the modeled tokens/s and us/op;
  6. the paged-attention kernels (split and merge) against their plain
     version on the card (fp32 to 2e-5, bf16 to 2e-2, atol = rtol): MHA,
     GQA and MQA at head_dim 32 and 128 with seq_len 0, 1, a page boundary
     and full, -1 entries and permuted page tables, granite-3-8b's decode
     shape (B=8, H=32, KVH=8, D=128, page 128, P=6), head_dim 160, and a
     long sequence (B=1, granite's heads, 8192 tokens in 64 pages of 128)
     that crosses many splits;
  7. the serving path: granite-3-8b at full width (40 layers, bf16,
     weights from ``--seed`` on the card), 8 requests of 512 prompt tokens
     and 64 greedy decode steps through `launch.serve.serve`, page ids from
     a PagePool of the reference's default kind ``sw`` on the card; both
     kernels' launch counters are reset just before and read just after
     (paged attention 40 x 64, the heap step 0: the pool's rounds are
     plain PyTorch ops); then the pool's counters (how many threads
     reached the heap's backend, 0 fails) and the pool rounds' time, every
     step's logits finite, the last step's layer-0 attention == the plain
     version, and timings: prefill, decode per step, the paged-attention
     kernels per call (CUDA events; device time from torch.profiler, the
     split kernel and the merge summed), its plain version,
     `scaled_dot_product_attention` over gathered K/V as a yardstick
     (never on the path), the bytes bound, and the device busy share of a
     few decode steps;
  8. the buddy batch through `kernels.ops.buddy_alloc_batch` at the
     allocator's width (C=512 cores, 32 MiB heaps of 4 KiB blocks: 16384-
     node trees): first the small geometries of tests/test_kernels.py,
     then 4 chained batches of B=128 requests per core (sizes from
     ``--seed``, log-uniform over 4 KiB - 1 MiB, ~3 % each 0, negative and
     above 2^30) with the counter reset just before and read just after;
     every batch == the plain version bit for bit, the free bytes of every
     tree == heap minus the blocks served; timings and bound, and the
     kernel's time at B=1 (the tree's copy in and out and one walk), which
     splits its time between the copies and the walk;
  9. the freelist op through `kernels.ops.freelist_op` at the allocator's
     width (16 threads x 512 cores = 8192 thread caches, 8 classes, CAP
     1024: 256 MiB of stacks): 8 chained ops with op in {-1, 0, 1} and
     classes from -1 to NC, each == the plain version bit for bit;
     timings and bound;
 10. flash attention through `kernels.ops.flash_attention_op`: the kernel
     against its plain version over a sweep at the reference's input scale
     (randn x 0.2; causal, windowed, non-causal with S != T; MHA, GQA,
     MQA; head_dim 64, 128, 256; S = 192 and 1000; fp32 to 3e-5, bf16 to
     2.5e-2, atol = rtol), then the main path at full width, each shape
     driven with the counter reset just before and read just after:
     granite-3-8b's prefill attention (B=8, S=T=512, H=32, KVH=8, hd=128,
     causal, bf16) and a long context (B=1, S=T=8192, the same heads).
     There the inputs are unit-scale randn, so scores spread as real q and
     k give them, and each bf16 output is held to its plain version both
     at 2.5e-2 and within two bf16 rounding steps of each element
     (|diff| <= 2^-6 |want| + 2^-14 max|want|); the same inputs in fp32
     go through the kernel again (not counted) and are held at 3e-5.
     The launches of each route (bf16 on the tensor cores, fp32 on the
     CUDA cores) are counted and printed. Then timings, bounds, and
     `scaled_dot_product_attention` as a yardstick (never on the path).
     `tools/flash_mutants.py` shows that these checks, and phase 6's,
     fail deliberately broken kernels.

In the ``kernels`` record, each kernel's ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are per launch: averaged over the launches
of its main path for the heap step (phase 5) and phases 8-9, for one call
at each shape of phase 10 (one entry per shape), at the last decode
step's layer-0 inputs for paged attention (phase 7).

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the port's sources beside the script.
"""
from __future__ import annotations

import argparse
import dataclasses
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
SCAN_KINDS = ("hwsw", "sw", "strawman")  # the reference's scan-based kinds
STRAW_ROUNDS = 8     # session rounds strawman serves in phase 5b
REGION_KINDS = ("arena", "tlregion")  # the region frontends (phase 5c)
INNERS = ("hwsw", "fused")  # the backends their spills go to
RESET_EVERY = 8      # every 8th round of phase 5c's stream resets
SHARD_RANKS = 4      # ShardedHeap ranks in phase 5c (x CORES / 4 cores)
SHARD_ROUNDS = 8     # session rounds of the sharded tier
SMALL_CORES = 8      # the sanitizer's card-against-CPU check
MISUSE_ROUNDS = 32   # rounds of the sanitizer's misuse stream (phase 5c)
OP_EPOCH_RESET = 5   # the protocol's reset op (repro_torch.core.heap)

PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PA_REPLACES = "src/repro/kernels/paged_attention.py:94"
# the kernels of one call, in a profiler trace: the split kernel (one per
# call) and the merge (one per call with more than one split)
PA_KERNEL = "paged_attention_kernel"
PA_MERGE = "paged_attention_merge"
FP32_OPS_PER_S = 67e12      # non-tensor fp32 peak (data sheet)
# (H, KVH, D): MHA, GQA with G = 4, MQA, at head_dim 32 and 128
PA_HEADS = ((4, 4, 32), (8, 2, 32), (4, 1, 32),
            (4, 4, 128), (8, 2, 128), (4, 1, 128))
PA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 6: (H, KVH, D, page, pages, seq_lens)
PA_CASES = tuple((H, KVH, D, 16, 4, (0, 1, 16, 17, 64))
                 for H, KVH, D in PA_HEADS) + (
    (32, 8, 128, 128, 6, (513, 530, 545, 560, 575, 576, 0, 768)),
    (32, 8, 160, 128, 6, (1, 128, 129, 768)))
PA_LONG = (32, 8, 128, 128, 64, (8192,))  # B=1, across many splits
SERVE_ARCH = "granite_3_8b"
SERVE_BATCH = 8       # requests
SERVE_PROMPT = 512    # prompt tokens per request
SERVE_STEPS = 64      # greedy decode steps
SERVE_PROFILE = 4     # decode steps in the profiler window (after 1 warm-up)
PA_CALLS = 100        # back-to-back calls per timing

BUDDY_SOURCE = "src/repro_torch/kernels/csrc/buddy_traverse.cu"
BUDDY_REPLACES = "src/repro/kernels/buddy_traverse.py:174"
BUDDY_KERNEL = "buddy_alloc_batch_kernel"  # its name in a profiler trace
BUDDY_BATCH = 128     # requests per core and batch
BUDDY_BATCHES = 4     # chained batches of the main path
BUDDY_ODD = 0.03      # share of each of: 0, negative, above 2^30
# the geometries of tests/test_kernels.py: (heap, min_block) x (C, B)
BUDDY_SMALL = ((1 << 14, 32), (1 << 16, 64), (1 << 18, 4096))
BUDDY_SMALL_CB = ((1, 8), (4, 16))
INT_STEP_OPS = 4      # integer operations per step of a tree walk

FL_SOURCE = "src/repro_torch/kernels/csrc/freelist.cu"
FL_REPLACES = "src/repro/kernels/freelist.py:139"
FL_KERNEL = "freelist_kernel"
FL_OPS = 8            # chained ops of the main path

FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:102"
FA_KERNEL = "flash_attention_kernel"
FA_TOL = {"float32": 3e-5, "bfloat16": 2.5e-2}
FA_STEP = 2.0 ** -6    # two bf16 rounding steps, relative to |want|
FA_FLOOR = 2.0 ** -14  # of max |want|: room for another fp32 summation order
FA_SCALE = 0.2         # the sweep's input scale (the reference's tests)
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak (data sheet)
# B, S, T, H, KVH, hd, causal, window
FA_SWEEP = ((2, 192, 192, 4, 2, 64, True, 0),
            (1, 1000, 1000, 4, 1, 128, True, 128),
            (2, 192, 1000, 6, 6, 256, False, 0),
            (1, 1000, 192, 8, 2, 256, True, 64),
            (1, 1000, 1000, 4, 4, 64, False, 300),
            (2, 192, 192, 8, 1, 128, True, 0))
# (kernels-record name, label, case) of the main path's calls
FA_FULL = (("flash_attention", "granite-3-8b prefill",
            (8, 512, 512, 32, 8, 128, True, 0)),
           ("flash_attention_8192", "long context",
            (1, 8192, 8192, 32, 8, 128, True, 0)))


def session_tape(rng, rounds, cores, threads, reset_every=None):
    """A [R, C, T] tape of ops, sizes and slot refs: each thread frees or
    reallocates only slots it produced earlier and has not released. With
    `reset_every`, every such round (the 8th, 16th, ... for 8) is an
    EPOCH_RESET round on every thread of every core, after which no ref
    reaches a slot produced before it; the other rounds take their ops
    and sizes from the same draws."""
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
        if reset_every and r % reset_every == reset_every - 1:
            op[r] = OP_EPOCH_RESET
            live = [[[] for _ in range(threads)] for _ in range(cores)]
            continue
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


def slot_file(tape, device, cores=None):
    """An [R, C, T] tape (op, size, ref[, raw]) on the device, its first
    `cores` cores (all by default), its refs resolved by a SlotFile."""
    import torch
    from repro_torch.workloads.replay import SlotFile
    op, size, ref, *raw = (torch.from_numpy(a[:, :cores].copy()).to(device)
                           for a in tape)
    return SlotFile(op, size, ref, raw[0] if raw else torch.full_like(ref, -1))


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


def phase_kernel_vs_plain(cfg, state, tape, rounds, device,
                          batch_refill=True):
    """Kernel and plain version on the same inputs, round by round, both
    with `batch_refill`; the carried state advances through heap.step.
    Returns (max |difference|, core-rounds per backend branch: skip,
    run-carve, serial)."""
    import torch
    from repro_torch.core import heap
    from repro_torch.kernels import heap_step
    sess = slot_file(tape, device)
    worst = 0
    branches = [0, 0, 0]
    for r in range(rounds):
        req = sess.request(r)
        leaves = state_args(state)
        plain = heap_step.protocol_round(*req, *leaves, **geometry(cfg),
                                         batch_refill=batch_refill)
        kern = heap_step.fused_heap_step(*req, *(x.clone() for x in leaves),
                                         **geometry(cfg),
                                         batch_refill=batch_refill)
        branch = round_branches(cfg, req, plain, leaves[0])
        for b in range(3):
            branches[b] += int((branch == b).sum())
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
    return worst, branches


def round_branches(cfg, req, rec, longest):
    """int32[C]: the backend branch each core's round takes (0 skip, 1
    run-carve, 2 serial walk), by the ported helpers, from the round's
    records (which threads need the backend, which bypass) and the
    pre-round trees."""
    from repro_torch.kernels import heap_step
    bypass = rec.m_bypass.bool()
    need = rec.m_refill.bool() | bypass
    return heap_step.backend_branch(need, bypass, req.size, longest,
                                    heap_bytes=cfg.pm.heap_bytes,
                                    block_bytes=cfg.pm.block_bytes)[0]


def shares(branches):
    n = sum(branches) or 1
    return ", ".join(f"{k} {100 * v / n:.2f} % ({v})" for k, v in
                     zip(("skip", "run-carve", "serial"), branches))


def phase_tapes(device, batch_refill=True, reports=None):
    """The committed tapes through kind fused, the batched refill set by
    the environment as a user sets it; returns kernel launches, and fills
    `reports` (if given) with each tape's fused report."""
    import os
    from repro_torch.kernels import heap_step
    from repro_torch.workloads import replay, trace
    before = heap_step.fused_heap_step.launches
    total_rounds = 0
    env = os.environ.get("PIM_MALLOC_BATCH_REFILL")
    os.environ["PIM_MALLOC_BATCH_REFILL"] = "1" if batch_refill else "0"
    try:
        for name in TAPES:
            tape = trace.Trace.load(str(ROOT / "benchmarks" / "tapes" /
                                        f"{name}.json"))
            _, _, rep = replay.replay(tape, "fused", device=device)
            if reports is not None:
                reports[name] = rep
            errs = replay.check_trace(tape, results={"fused": rep})
            if errs:
                raise AssertionError(f"tape {name}: " + "; ".join(errs))
            total_rounds += tape.rounds
            print(f"tape {name} (batch_refill {batch_refill}): "
                  f"{tape.rounds} rounds, ok={rep['ok_ops']}/{rep['ops']}, "
                  f"digest_full {rep['digest_full'][:16]}... == "
                  f"expect[pallas], residual 0")
    finally:
        if env is None:
            del os.environ["PIM_MALLOC_BATCH_REFILL"]
        else:
            os.environ["PIM_MALLOC_BATCH_REFILL"] = env
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
    """Times of the kernel over the recorded rounds, with the batched
    refill on and off, each pass from a fresh copy of the initial state
    (the kernel works in place).

    Pass 1 (untimed, also the warm-up) keeps every round's records. Then
    passes launch back to back with a CUDA event between launches and keep
    no output, so the caching allocator recycles the records' memory
    instead of allocating (a device allocation stalls the host inside the
    timed window): on, off, off, on. Then one pass of each setting under
    torch.profiler for the kernel's own device time, without the host's
    enqueue gaps, averaged over the launches the trace recorded. Returns
    ({batch_refill: (event ms per round over its two passes, per-round
    event ms of both passes, profiler device ms per launch or None,
    recorded launches)}, pass 1's records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import heap_step

    def run(keep, refill, events=None):
        leaves = [x.clone() for x in state_args(fresh)]
        torch.cuda.synchronize()
        recs = []
        for r, req in enumerate(reqs):
            if events:
                events[r].record()
            out = heap_step.fused_heap_step(*req, *leaves, **geometry(cfg),
                                            batch_refill=refill)
            if keep:
                recs.append(out)  # records are fresh tensors every launch
        if events:
            events[-1].record()
        torch.cuda.synchronize()
        return recs

    recs = run(keep=True, refill=True)
    run(keep=False, refill=False)
    passes = {True: [], False: []}
    for refill in (True, False, False, True):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(reqs) + 1)]
        run(keep=False, refill=refill, events=events)
        passes[refill].append(
            (events[0].elapsed_time(events[-1]) / len(reqs),
             [events[r].elapsed_time(events[r + 1])
              for r in range(len(reqs))]))
    out = {}
    for refill in (True, False):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(keep=False, refill=refill)
        dev_us, seen = kernel_events(prof)
        out[refill] = (sum(p[0] for p in passes[refill]) / 2,
                       [ms for p in passes[refill] for ms in p[1]],
                       dev_us / 1e3 / seen if seen else None, seen)
    return out, recs


def kernel_events(prof, name="heap_step_kernel"):
    """(device µs, event count) of the kernel `name` in a profiler trace."""
    us, n = 0.0, 0
    for e in prof.key_averages():
        if name in e.key and device_us(e) > 0:
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


def paper_cfg(kind, **kw):
    """The paper's allocator (Table 3) behind heap kind `kind` (`kw`: more
    `SystemConfig` fields, e.g. ``arena_inner``)."""
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import system as sysm
    from repro_torch.core.pim_malloc import PimMallocConfig
    return sysm.SystemConfig(
        kind=kind, heap_bytes=CONFIG.heap_bytes,
        num_threads=CONFIG.num_threads,
        pm=PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                           num_threads=CONFIG.num_threads,
                           size_classes=CONFIG.size_classes,
                           block_bytes=CONFIG.block_bytes),
        straw=sysm.StrawmanConfig(heap_bytes=CONFIG.heap_bytes,
                                  num_threads=CONFIG.num_threads,
                                  min_block=CONFIG.min_block), **kw)


def run(seed, device, cores=CORES, rounds=ROUNDS):
    import numpy as np
    import torch
    from repro_torch.core import heap, telemetry
    from repro_torch.kernels import heap_step

    cfg = paper_cfg("fused")
    C, T, R = cores, cfg.num_threads, rounds
    tape = session_tape(np.random.default_rng(seed), R, C, T)
    result = {"cores": C, "threads": T, "rounds": R, "seed": seed}

    # ---- 3: kernel against plain version, full width ----------------------
    fresh = heap.init(cfg, num_cores=C, device=device)
    state_mib = sum(x.numel() * 4 for x in state_args(fresh)) / 2 ** 20
    worst, branches = 0, {}
    for refill in (True, False):
        t0 = time.perf_counter()
        w, branches[refill] = phase_kernel_vs_plain(
            cfg, clone_state(fresh), tape, CHECK_ROUNDS, device,
            batch_refill=refill)
        worst = max(worst, w)
        print(f"kernel == plain version, all 31 outputs, {CHECK_ROUNDS} "
              f"rounds at C={C} T={T} heap={cfg.heap_bytes >> 20} MiB "
              f"({state_mib:.0f} MiB of state), batch_refill {refill}: max "
              f"|diff| {w} [{time.perf_counter() - t0:.1f} s]")
    print(f"backend branch of the {C * CHECK_ROUNDS} core-rounds: "
          f"{shares(branches[True])}")

    # ---- 4: committed tapes through the kernel ----------------------------
    fused_reports = {}
    tape_launches = sum(phase_tapes(device, batch_refill=refill,
                                    reports=fused_reports if refill else None)
                        for refill in (True, False))
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

    timed, recs = time_kernel(cfg, fresh, reqs)
    kernel_ms, round_ms, device_ms, seen = timed[True]
    off_ms, _, off_device_ms, off_seen = timed[False]
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
    print(f"batch_refill off, same rounds, in turns with on: kernel "
          f"{off_ms:.4f} ms/round (CUDA events), device time "
          f"{off_device_ms} ms/launch over {off_seen} launches recorded "
          f"(on: {kernel_ms:.4f} / {device_ms})")
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
                  kernel_off_ms=off_ms, kernel_off_device_ms=off_device_ms,
                  kernel_off_device_events=off_seen,
                  check_branches={str(k): v for k, v in branches.items()},
                  plain_ms=plain_ms,
                  bytes_per_round=nbytes, ops_per_round=nops,
                  bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                  max_chain_steps=steps, state_mib=state_mib,
                  tape_launches=tape_launches, fused_reports=fused_reports)
    kernels = [{
        "name": "fused_heap_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]
    return result, kernels


# ---------------------------------------------------------------------------
# phase 5b: the scan-based design points
# ---------------------------------------------------------------------------
def phase_scan_tapes(device, fused_reports):
    """(a) The committed tapes through strawman, sw and hwsw, each held to
    its own expect block, and `check_trace` over all four kinds (phase 4's
    fused reports reused): lint clean, fused == hwsw in full, sw == hwsw
    on the semantic fields, residual 0. Returns the rounds replayed."""
    from repro_torch.workloads import replay, trace
    replayed = 0
    for name in TAPES:
        tape = trace.Trace.load(str(ROOT / "benchmarks" / "tapes" /
                                    f"{name}.json"))
        lint = trace.trace_lint(tape)
        if lint:
            raise AssertionError(f"tape {name}: " + "; ".join(lint))
        results = {k: replay.replay(tape, k, device=device)[2]
                   for k in SCAN_KINDS}
        results["fused"] = fused_reports[name]
        errs = replay.check_trace(tape, results=results)
        if errs:
            raise AssertionError(f"tape {name}: " + "; ".join(errs))
        replayed += tape.rounds * len(SCAN_KINDS)
        print(f"tape {name}: " + ", ".join(
            f"{k} ok={results[k]['ok_ops']}/{results[k]['ops']} "
            f"{results[k]['digest_full'][:12]}..." for k in SCAN_KINDS)
            + " == their expect blocks; fused == hwsw in full, sw == hwsw "
            "on ptr/ok/path/moved, lint clean, residual 0")
    return replayed


def scan_mismatches(r, resps, states):
    """Where the kinds of one session round disagree: hwsw against fused
    on every response field and state leaf, sw against hwsw on the
    semantic fields and the allocator state. Returns error strings."""
    from repro_torch.convert import leaves
    from repro_torch.workloads.trace import SEMANTIC_FIELDS
    errs = []
    pairs = (("hwsw", "fused", None, None),
             ("sw", "hwsw", SEMANTIC_FIELDS, lambda st: leaves(st.alloc)))
    for a, b, fields, state_leaves in pairs:
        if a in resps and b in resps:
            errs += pair_mismatches(r, a, b, resps[a], resps[b], states[a],
                                    states[b], fields, state_leaves)
    return errs


def pair_mismatches(r, a, b, resp_a, resp_b, st_a, st_b, fields=None,
                    state_leaves=None):
    """Where two runs of one round disagree: the response `fields` (all by
    default) and the leaves `state_leaves(state)` (every leaf by default),
    bit for bit, shapes included. Returns error strings naming run `a`
    against run `b`."""
    import torch
    from repro_torch.convert import leaves
    fields = resp_a._fields if fields is None else fields
    state_leaves = leaves if state_leaves is None else state_leaves
    errs = []
    for f in fields:
        x, y = getattr(resp_a, f), getattr(resp_b, f)
        if x.shape != y.shape or not torch.equal(x, y.to(x.device)):
            errs.append(f"round {r}: {a} != {b} on response {f}")
    la, lb = state_leaves(st_a), state_leaves(st_b)
    if len(la) != len(lb):
        errs.append(f"round {r}: {a} and {b} states differ in layout")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.shape != y.shape or not torch.equal(x, y.to(x.device)):
            errs.append(f"round {r}: {a} != {b} on state leaf {i} "
                        f"{tuple(x.shape)}")
    return errs


def check_residuals(kind, resid):
    """Raise unless every core's conservation residual is 0."""
    import numpy as np
    bad = int(np.count_nonzero(resid))
    if bad:
        raise AssertionError(f"{kind}: conservation residual nonzero on "
                             f"{bad} of {len(resid)} cores")


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def kind_run(cfg, tape, device, cores=None):
    """A lockstep run of heap kind `cfg` from a fresh state over the first
    `cores` cores (all by default) of an [R, C, T] tape (op, size, ref[,
    raw]): [its step, its state, the slot file resolving its refs]."""
    import functools
    from repro_torch.core import heap
    cores = tape[0].shape[1] if cores is None else cores
    return [functools.partial(heap.step, cfg),
            heap.init(cfg, num_cores=cores, device=device),
            slot_file(tape, device, cores)]


def heap_object_run(h, lead, tape, device):
    """A lockstep run of a `MultiCoreHeap` or `ShardedHeap` `h` whose
    state leaves lead with the axes `lead` ((C,) or (R, C)), over an
    [R, C, T] tape whose C is all of h's cores: its requests reshaped to
    `lead`, its responses and state leaves folded back onto one core axis
    (views)."""
    from repro_torch.convert import leaves
    from repro_torch.core.heap import AllocRequest

    def fold(x):
        return x.reshape((math.prod(lead),) + x.shape[len(lead):])

    def step(_, req):
        resp = h.step(AllocRequest(*(x.reshape(lead + (-1,)) for x in req)))
        return (tuple(fold(x) for x in leaves(h.state)),
                type(resp)(*(fold(x) for x in resp)))

    return [step, None, slot_file(tape, device)]


def lockstep(runs, rounds, device, check=None, times=None, served=None,
             what="lockstep"):
    """Step runs {name: [step, state, slot file]} (`step(state, req)` ->
    (state, response)) over `rounds` rounds in lockstep, each resolving
    its own slots; a run stops after `served[name]` rounds where given.
    Each step ends in a synchronise; with `times` its host-clock seconds
    go to `times[name]`. After every round `check(r, reqs, resps,
    states)`, over the runs that stepped, returns error strings, and the
    first round with any raises."""
    for r in range(rounds):
        reqs, resps = {}, {}
        for name, run in runs.items():
            if served is not None and r >= served[name]:
                continue
            step, state, sess = run
            reqs[name] = req = sess.request(r)
            sync(device)
            t0 = time.perf_counter()
            run[1], resps[name] = step(state, req)
            sync(device)
            if times is not None:
                times[name].append(time.perf_counter() - t0)
            sess.record(r, req, resps[name])
        errs = check(r, reqs, resps, {n: runs[n][1] for n in resps}) \
            if check is not None else []
        if errs:
            raise AssertionError(f"{what}: " + "; ".join(errs[:8]))


def profile_call(fn):
    """`fn()` under torch.profiler (device activity only: a scan-based
    round makes tens of thousands of launches): (its result, device busy
    ms or None, wall ms, device launches, the top kernels as (ms,
    launches, name))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0:
            busy += us
            launches += e.count
            top.append((us / 1e3, e.count, e.key[:60]))
    top.sort(reverse=True)
    return result, (busy / 1e3 if busy > 0 else None), 1e3 * wall, \
        launches, top[:5]


def profile_round(cfg, state, req):
    """One `heap.step` round under the profiler, continuing from `state`:
    (state, device busy ms or None, wall ms, device launches, the top
    kernels)."""
    from repro_torch.core import heap
    (state, _), busy, wall, launches, top = profile_call(
        lambda: heap.step(cfg, state, req))
    return state, busy, wall, launches, top


def profiled(cfg, state, req, device):
    """(state, (busy ms, wall ms, launches, top)) of one more round under
    the profiler on the card; the round runs unprofiled elsewhere."""
    from repro_torch.core import heap
    if device.type != "cuda":
        state, _ = heap.step(cfg, state, req)
        return state, (None, 0.0, 0, [])
    state, busy, wall, launches, top = profile_round(cfg, state, req)
    return state, (busy, wall, launches, top)


def print_times(label, times, prof, smi=None, ops=None,
                what="heap.step round", profiled_as="one more round"):
    """The host-clock round times of one kind (and its allocator ops/s
    over `ops` ops, where given) and its profiled round; returns them."""
    ms = [1e3 * t for t in times]
    mean = sum(ms) / len(ms)
    busy, wall, launches, top = prof
    busy_s = "not measured" if busy is None else \
        f"{busy:.4f} of {wall:.3f} ms ({100 * busy / wall:.1f} %)"
    rate = "" if ops is None else \
        f", {ops / sum(times):.4g} allocator ops/s"
    card = "" if smi is None else f" [{smi}]"
    print(f"{label}: {mean:.3f} ms per {what} (host clock, mean of "
          f"{len(ms)}, min {min(ms):.3f}, max {max(ms):.3f}){rate}; "
          f"{profiled_as} under the profiler: {launches} device launches, "
          f"device busy {busy_s}; top: " + "; ".join(
              f"{name} {t:.4f} ms x{c}" for t, c, name in top[:3]) + card)
    out = dict(ms_per_round=mean, round_ms=ms, profile_busy_ms=busy,
               profile_wall_ms=wall, launches_per_round=launches,
               profile_top=[list(t) for t in top])
    if ops is not None:
        out["ops_per_s"] = ops / sum(times)
    return out


def phase_scan(seed, device, fused_reports, cores=CORES,
               rounds=CHECK_ROUNDS, straw_rounds=STRAW_ROUNDS, smi=None):
    """Phase 5b: (a) the tapes through the scan-based kinds; (b) the first
    `rounds` rounds of phase 5's stream through hwsw, sw, strawman (its
    first `straw_rounds`) and fused from fresh states in lockstep, each
    kind resolving its own slots, held by `scan_mismatches`, then the
    residual of every core of every kind; (c) each kind's ms per
    `heap.step` round (host clock, each step ending in a synchronise),
    then one more round of the stream under the profiler for its device
    launches and busy share. Returns the result dict."""
    import numpy as np
    from repro_torch.core import telemetry
    from repro_torch.core.heap import AllocResponse
    from repro_torch.kernels import heap_step
    t_phase = time.perf_counter()
    replayed = phase_scan_tapes(device, fused_reports)
    t_tapes = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    kinds = SCAN_KINDS + ("fused",)
    cfgs = {k: paper_cfg(k) for k in kinds}
    T = cfgs["fused"].num_threads
    tape = session_tape(np.random.default_rng(seed), ROUNDS, cores, T)
    runs = {k: kind_run(cfgs[k], tape, device) for k in kinds}
    served = {k: min(rounds, straw_rounds) if k == "strawman" else rounds
              for k in kinds}
    times = {k: [] for k in kinds}
    t_setup = time.perf_counter() - t0
    launches_before = heap_step.fused_heap_step.launches
    t0 = time.perf_counter()
    lockstep(runs, rounds, device, times=times, served=served,
             check=lambda r, reqs, resps, states:
             scan_mismatches(r, resps, states), what="session")
    t_session = time.perf_counter() - t0
    fused_launches = heap_step.fused_heap_step.launches - launches_before
    if device.type == "cuda" and fused_launches != rounds:
        raise AssertionError(f"the session's fused rounds launched the "
                             f"heap kernel {fused_launches} times in "
                             f"{rounds} rounds")
    t0 = time.perf_counter()
    for k in kinds:
        check_residuals(k, telemetry.conservation_residuals(cfgs[k],
                                                            runs[k][1]))
    t_resid = time.perf_counter() - t0
    ops = {k: int((tape[0][:served[k]] != 0).sum()) for k in kinds}
    print(f"session: {rounds} rounds at C={cores} T={T} (strawman "
          f"{served['strawman']}): hwsw == fused on all "
          f"{len(AllocResponse._fields)} response fields and every state "
          f"leaf, sw == hwsw on ptr/ok/path/moved and the "
          f"allocator state, residual 0 on every core of {', '.join(kinds)}")
    out = {"tape_rounds": replayed, "rounds": rounds,
           "straw_rounds": served["strawman"], "kinds": {}}
    t0 = time.perf_counter()
    for k in kinds:
        # the next round of the stream, under the profiler
        runs[k][1], prof = profiled(cfgs[k], runs[k][1],
                                    runs[k][2].request(served[k]), device)
        out["kinds"][k] = print_times(k, times[k], prof, smi, ops=ops[k])
    t_profile = time.perf_counter() - t0
    del runs
    out.update(phase_s=time.perf_counter() - t_phase, tapes_s=t_tapes,
               setup_s=t_setup, session_s=t_session, residual_s=t_resid,
               profile_s=t_profile)
    print(f"phase 5b took {out['phase_s']:.1f} s: tapes {t_tapes:.1f}, "
          f"set-up {t_setup:.1f}, session {t_session:.1f}, residuals "
          f"{t_resid:.1f}, profiles {t_profile:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 5c: the region frontends, the sanitizer and the sharded tier
# ---------------------------------------------------------------------------
def lint_cores(tape, heap_bytes):
    """`trace_lint` on every core's [R, T] column of an [R, C, T] tape;
    returns the findings."""
    import numpy as np
    from repro_torch.workloads.trace import Trace, trace_lint
    op, size, ref = tape[:3]
    raw = tape[3] if len(tape) > 3 else np.full_like(ref, -1)
    errs = []
    for c in range(op.shape[1]):
        t = Trace(name=f"core{c}", heap_bytes=heap_bytes,
                  num_threads=op.shape[2], recorded_kind="hwsw",
                  description="", op=op[:, c], size=size[:, c],
                  ptr_ref=ref[:, c], ptr_raw=raw[:, c])
        errs += [f"core {c}: {e}" for e in trace_lint(t)]
    return errs


def spill_backend(req, resp):
    """Inferred from the arena's responses, not read from the heap
    kernel: (core-rounds on which no thread needed the spill backend,
    the share the fused round skips; threads that needed it). A thread
    needs it when its alloc-class op was answered by a refill, a bypass
    or a failed backend walk (paths 1-3; the stream has no size above the
    heap)."""
    from repro_torch.core import heap
    alloc_class = (req.op == heap.OP_MALLOC) | (req.op == heap.OP_CALLOC) \
        | ((req.op == heap.OP_REALLOC) & (req.size > 0))
    need = alloc_class & (resp.path >= 1) & (resp.path <= 3)
    return int((~need.any(-1)).sum()), int(need.sum())


def region_tapes(device):
    """(a) The committed tapes through sanitizer, arena and tlregion, the
    region kinds over each spill backend: every report held to its kind's
    committed expect block (digests, ok ops, dropped frees, live and hwm
    bytes) and residual 0. Returns (rounds replayed, heap-kernel
    launches)."""
    from repro_torch.kernels import heap_step
    from repro_torch.workloads import replay, trace
    runs = [("sanitizer", "hwsw")] + [(k, i) for k in REGION_KINDS
                                      for i in INNERS]
    before = heap_step.fused_heap_step.launches
    replayed = 0
    for name in TAPES:
        tape = trace.Trace.load(str(ROOT / "benchmarks" / "tapes" /
                                    f"{name}.json"))
        digests = []
        for kind, inner in runs:
            rep = replay.replay(tape, kind, device=device,
                                arena_inner=inner)[2]
            errs = replay.check_trace(tape, results={kind: rep})
            if errs:
                raise AssertionError(f"tape {name} {kind} over {inner}: "
                                     + "; ".join(errs))
            replayed += tape.rounds
            digests.append(f"{kind}/{inner} {rep['digest_full'][:12]}...")
        print(f"tape {name}: " + ", ".join(digests) + " == their expect "
              "blocks (digests, ok ops, dropped frees, live and hwm "
              "bytes), residual 0")
    return replayed, heap_step.fused_heap_step.launches - before


def region_session(seed, device, smi, cores=CORES, rounds=CHECK_ROUNDS):
    """(b) Phase 5's stream with every RESET_EVERY-th round a reset on
    every core, through arena and tlregion over hwsw and over fused from
    fresh states in lockstep; over fused == over hwsw on every field and
    leaf every round; residual 0 on every core; the heap kernel's launches
    (counter set to 0 just before, read just after) and the skip share
    inferred from the responses; each run's round times and one profiled
    round. Returns the result."""
    import numpy as np
    from repro_torch.core import telemetry
    from repro_torch.kernels import heap_step
    names = [(k, i) for k in REGION_KINDS for i in INNERS]
    cfgs = {ki: paper_cfg(ki[0], arena_inner=ki[1]) for ki in names}
    T = cfgs[names[0]].num_threads
    heap_bytes = cfgs[names[0]].heap_bytes
    tape = session_tape(np.random.default_rng(seed), rounds + 1, cores, T,
                        reset_every=RESET_EVERY)
    lint = lint_cores(tape, heap_bytes)
    if lint:
        raise AssertionError("phase 5c stream: " + "; ".join(lint[:5]))
    runs = {ki: kind_run(cfgs[ki], tape, device) for ki in names}
    times = {ki: [] for ki in names}
    skipped = {k: 0 for k in REGION_KINDS}
    spills = {k: 0 for k in REGION_KINDS}

    def check(r, reqs, resps, states):
        errs = []
        for k in REGION_KINDS:
            f, h = (k, "fused"), (k, "hwsw")
            sk, sp = spill_backend(reqs[f], resps[f])
            skipped[k] += sk
            spills[k] += sp
            errs += pair_mismatches(r, f"{k}/fused", f"{k}/hwsw", resps[f],
                                    resps[h], states[f], states[h])
        return errs

    heap_step.fused_heap_step.launches = 0
    lockstep(runs, rounds, device, check, times, what="arena session")
    launches = heap_step.fused_heap_step.launches
    if device.type == "cuda" and launches != 2 * rounds:
        raise AssertionError(f"the arena kinds' fused spills launched the "
                             f"heap kernel {launches} times in {rounds} "
                             f"rounds of two kinds")
    for ki in names:
        check_residuals(f"{ki[0]} over {ki[1]}",
                        telemetry.conservation_residuals(cfgs[ki],
                                                         runs[ki][1]))
    resets = int((tape[0][:rounds] == OP_EPOCH_RESET).any(-1).any(-1).sum())
    epochs = {k: runs[(k, "fused")][1].epoch.unique().tolist()
              for k in REGION_KINDS}
    print(f"arena session: {rounds} rounds at C={cores} T={T} "
          f"({resets} reset rounds on every core; lint clean), arena and "
          f"tlregion over fused == over hwsw on all 9 response fields and "
          f"every state leaf (cls_map, bump, epoch {epochs}, the LRU "
          f"state, the telemetry) every round, residual 0 on every core; "
          f"the heap kernel launched {launches} times for the spills "
          f"({', '.join(f'{k} {v}' for k, v in spills.items())} spilled "
          f"threads reached its backend); inferred from the responses "
          f"(paths 1-3 of alloc-class ops), no thread needed its backend "
          f"on " + ", ".join(
              f"{k} {100 * skipped[k] / (cores * rounds):.2f} % "
              f"({skipped[k]} of {cores * rounds})" for k in REGION_KINDS)
          + " of the core-rounds")
    out = {"rounds": rounds, "cores": cores, "launches": launches,
           "skipped_core_rounds": skipped, "spilled_threads": spills,
           "runs": {}}
    for ki in names:
        runs[ki][1], prof = profiled(cfgs[ki], runs[ki][1],
                                     runs[ki][2].request(rounds), device)
        out["runs"][f"{ki[0]}/{ki[1]}"] = print_times(
            f"{ki[0]} over {ki[1]}", times[ki], prof, smi)
    del runs
    return out


# the reports a misuse stream predicts: the tags, then the quarantine's
MISUSE_KEYS = ("double_free", "use_after_free", "realloc_after_free",
               "wild_ops", "epoch_stale", "epoch_resets")
RING_KEYS = ("quarantined", "evicted")
SMALL_BYTES = 2048   # the largest size class: its frees stay thread-local


def misuse_tape(rng, rounds, cores, threads, heap_bytes, reset_round,
                p_misuse=0.06, p_move=0.05):
    """Phase 5's traffic with misuse injected at known (round, core,
    thread) slots: (op, size, ref, raw) int32 [R, C, T], the expected
    report counts {key: int64 [C]} of MISUSE_KEYS and RING_KEYS, and the
    injections by target {name: int64 [C]}.

    Injected, each into a slot that would carry a session op: a second
    free of a slot freed in the previous round (double_free, the block
    still quarantined); a realloc of such a slot (realloc_after_free); a
    free of a slot retired by a moving realloc in the previous round
    (use_after_free; the moves are forced: a small block grows to 8 KiB,
    a bigger one shrinks to 16 B); a free of a slot whose block left the
    quarantine in the previous round (evicted_free: its shadow is FREE
    again, so it is tagged wild); a free of an unmapped in-heap,
    out-of-heap or misaligned pointer (wild_ops); after the reset round
    (every thread of every core), a free of a slot live before it
    (epoch_stale). A slot is the target of one injection at most.

    The generator keeps its own model of each core's quarantine ring:
    every session free enters in thread order (assuming every session
    alloc is served, which the caller checks), and past capacity the
    oldest leaves. Only blocks of a malloc of at most SMALL_BYTES are
    targets once evicted: their release goes to the evicting thread's own
    freelist, so no other thread can take the block in that round."""
    import collections
    import numpy as np
    from repro_torch.core.sanitizer import quarantine_slots
    shape = (rounds, cores, threads)
    kind = rng.choice(5, size=shape, p=[0.40, 0.30, 0.15, 0.10, 0.05])
    lo, hi = math.log(16), math.log(16 * 1024)
    sizes = np.exp(rng.uniform(lo, hi, size=shape)).astype(np.int32)
    op = np.zeros(shape, np.int32)
    size = np.zeros(shape, np.int32)
    ref = np.full(shape, -1, np.int32)
    raw = np.full(shape, -1, np.int32)
    want = {k: np.zeros(cores, np.int64) for k in MISUSE_KEYS + RING_KEYS}
    targets = {k: np.zeros(cores, np.int64) for k in (
        "double_free", "realloc_after_free", "use_after_free",
        "evicted_free", "wild_ops", "epoch_stale")}
    tag_of = {"evicted_free": "wild_ops"}
    cap = quarantine_slots(threads)
    ring = [collections.deque() for _ in range(cores)]
    small = [set() for _ in range(cores)]  # slots of mallocs <= SMALL_BYTES
    hit = [set() for _ in range(cores)]    # slots already targeted
    live = [[{} for _ in range(threads)] for _ in range(cores)]
    freed = [[] for _ in range(cores)]   # freed in the previous round
    moved = [[] for _ in range(cores)]   # retired by a move, previous round
    evicted = [[] for _ in range(cores)]  # left the ring, previous round
    stale = [[] for _ in range(cores)]   # live at the reset
    wild = (heap_bytes - 16, heap_bytes + 64, 24)
    for r in range(rounds):
        if r == reset_round:
            op[r] = OP_EPOCH_RESET
            want["epoch_resets"] += 1
            stale = [[s for own in live[c] for s in own]
                     for c in range(cores)]
            live = [[{} for _ in range(threads)] for _ in range(cores)]
            freed = [[] for _ in range(cores)]
            moved = [[] for _ in range(cores)]
            evicted = [[] for _ in range(cores)]
            continue
        now_freed = [[] for _ in range(cores)]
        now_moved = [[] for _ in range(cores)]
        now_evicted = [[] for _ in range(cores)]
        for c in range(cores):
            for t in range(threads):
                slot = r * threads + t
                own = live[c][t]
                u = rng.random()
                if u < p_misuse:
                    pools = {"double_free": freed[c],
                             "realloc_after_free": freed[c],
                             "use_after_free": moved[c],
                             "evicted_free": evicted[c],
                             "epoch_stale": stale[c]}
                    options = ["wild_ops"] + [m for m, p in pools.items()
                                              if p]
                    m = options[rng.integers(len(options))]
                    targets[m][c] += 1
                    want[tag_of.get(m, m)][c] += 1
                    op[r, c, t] = 2
                    if m == "wild_ops":
                        raw[r, c, t] = wild[rng.integers(len(wild))]
                    else:
                        pool = pools[m]
                        ref[r, c, t] = pool.pop(rng.integers(len(pool)))
                        hit[c].add(int(ref[r, c, t]))
                        if m == "realloc_after_free":
                            op[r, c, t], size[r, c, t] = 3, 64
                    continue
                if u < p_misuse + p_move and own:
                    old = list(own)[rng.integers(len(own))]
                    new_size = 8192 if own.pop(old) <= 2048 else 16
                    op[r, c, t], size[r, c, t] = 3, new_size
                    ref[r, c, t] = old
                    own[slot] = new_size
                    now_moved[c].append(old)
                    continue
                k = kind[r, c, t]
                if k in (1, 2) and not own:
                    k = 0
                if k == 0:
                    op[r, c, t], size[r, c, t] = 1, sizes[r, c, t]
                    own[slot] = int(sizes[r, c, t])
                    if sizes[r, c, t] <= SMALL_BYTES:
                        small[c].add(slot)
                elif k == 1:
                    old = list(own)[rng.integers(len(own))]
                    own.pop(old)
                    op[r, c, t], ref[r, c, t] = 2, old
                    now_freed[c].append(old)
                    want["quarantined"][c] += 1
                    if len(ring[c]) >= cap:
                        out = ring[c].popleft()
                        want["evicted"][c] += 1
                        if out in small[c] and out not in hit[c]:
                            now_evicted[c].append(out)
                    ring[c].append(old)
                elif k == 2:
                    old = list(own)[rng.integers(len(own))]
                    own.pop(old)
                    op[r, c, t], size[r, c, t] = 3, sizes[r, c, t]
                    ref[r, c, t] = old
                    own[slot] = int(sizes[r, c, t])
                elif k == 3:
                    op[r, c, t], size[r, c, t] = 4, sizes[r, c, t]
                    own[slot] = int(sizes[r, c, t])
        freed, moved, evicted = now_freed, now_moved, now_evicted
    return (op, size, ref, raw), want, targets


class QuarantineModel:
    """The quarantine ring on the host: every legitimate free of a round
    (a free-class op with a pointer, answered ok) enters in thread order,
    and past capacity the oldest leaves. `check` holds the state's ring
    (oldest first from q_head), its length and the eviction count to it:
    the ring evicts in FIFO order."""

    def __init__(self, cores, capacity):
        import collections
        self.rings = [collections.deque() for _ in range(cores)]
        self.evicted = [0] * cores
        self.capacity = capacity

    def update(self, req, resp):
        import numpy as np
        op, size, ptr = (x.cpu().numpy() for x in req)
        ok = resp.ok.cpu().numpy()
        legit = ((op == 2) | ((op == 3) & (size <= 0))) & (ptr >= 0) & ok
        for c, t in zip(*np.nonzero(legit)):
            ring = self.rings[c]
            if len(ring) >= self.capacity:
                ring.popleft()
                self.evicted[c] += 1
            ring.append(int(ptr[c, t]))

    def check(self, state):
        import numpy as np
        q_ptr = state.q_ptr.cpu().numpy()
        head = state.q_head.cpu().numpy()
        q_len = state.q_len.cpu().numpy()
        evicted = state.reports.evicted.cpu().numpy()
        errs = []
        for c, ring in enumerate(self.rings):
            got = np.roll(q_ptr[c], -int(head[c]))[:int(q_len[c])].tolist()
            if got != list(ring) or int(evicted[c]) != self.evicted[c]:
                errs.append(f"core {c}: quarantine {got[:4]}... (evicted "
                            f"{int(evicted[c])}) != FIFO model "
                            f"{list(ring)[:4]}... ({self.evicted[c]})")
        return errs


def san_mismatches(reports, want):
    """Where the sanitizer's per-core report counters differ from the
    expected counts {key: [C]}; returns error strings."""
    import numpy as np
    errs = []
    for k in want:
        got = getattr(reports, k).cpu().numpy()
        bad = np.flatnonzero(got != want[k])
        if len(bad):
            c = int(bad[0])
            errs.append(f"{k}: {len(bad)} cores differ from the injected "
                        f"counts (core {c}: {int(got[c])} != "
                        f"{int(want[k][c])})")
    return errs


def run_stream(cfg, tape, device, rounds, times=None, model=None):
    """Step a fresh `cfg` state over `rounds` rounds of an [R, C, T] tape
    (op, size, ref[, raw]) on `device`, timing each round into `times`
    and feeding `model` if given; returns (state, the slot file)."""
    runs = {"run": kind_run(cfg, tape, device)}

    def feed(r, reqs, resps, states):
        if model is not None:
            model.update(reqs["run"], resps["run"])
        return []

    lockstep(runs, rounds, device, feed,
             None if times is None else {"run": times})
    return runs["run"][1], runs["run"][2]


def check_devices(cfg, tape, dev_a, dev_b, rounds, cores):
    """The first `cores` cores of an [R, C, T] tape on two devices in
    lockstep, each resolving its own slots; raises where they differ in
    any response field or state leaf of any round."""
    a, b = str(dev_a), str(dev_b)
    runs = {d: kind_run(cfg, tape, torch_dev, cores)
            for d, torch_dev in ((a, dev_a), (b, dev_b))}
    lockstep(runs, rounds, dev_a, lambda r, reqs, resps, states:
             pair_mismatches(r, a, b, resps[a], resps[b], states[a],
                             states[b]), what=f"{cfg.kind} {a} != {b}")


def sanitizer_phase(seed, device, smi, cores=CORES, rounds=CHECK_ROUNDS,
                    misuse_rounds=MISUSE_ROUNDS, small=SMALL_CORES):
    """(c) The sanitizer: phase 5's stream without resets (every tag 0,
    residual 0, round times and one profiled round), then the misuse
    stream of `misuse_rounds` at `cores`, reset 3/4 of the way (the
    reports == the generator's counts on every core, the quarantine's
    parked and evicted counts included; FIFO eviction; residual 0) and
    its first `small` cores on the card == on the CPU, every field and
    leaf every round. Returns the result."""
    import numpy as np
    import torch
    from repro_torch.core import sanitizer, telemetry
    cfg = paper_cfg("sanitizer")
    T = cfg.num_threads
    clean = session_tape(np.random.default_rng(seed), rounds + 1, cores, T)
    times = []
    model = QuarantineModel(cores, sanitizer.quarantine_slots(T))
    state, sess = run_stream(cfg, clean, device, rounds, times=times,
                             model=model)
    # every tag of every round adds to one of the cumulative counters
    counts = {k: int(getattr(state.reports, k).sum())
              for k in sanitizer.SanReports._fields}
    bad = sum(counts[k] for k in MISUSE_KEYS)
    if bad or int(state.tags.abs().sum()):
        raise AssertionError(f"sanitizer tagged a clean stream: {counts}")
    errs = model.check(state)
    if errs:
        raise AssertionError("sanitizer clean stream: " + "; ".join(errs[:6]))
    check_residuals("sanitizer", telemetry.conservation_residuals(cfg,
                                                                  state))
    state, prof = profiled(cfg, state, sess.request(rounds), device)
    print(f"sanitizer, clean stream ({rounds} rounds at C={cores}): every "
          f"tag 0, {counts['quarantined']} frees quarantined, "
          f"{counts['evicted']} evicted in FIFO order on every core, "
          f"residual 0 on every core")
    out = {"clean": print_times("sanitizer", times, prof, smi)}
    del state, sess

    reset_round = misuse_rounds * 3 // 4
    tape, want, targets = misuse_tape(np.random.default_rng(seed + 1),
                                      misuse_rounds, cores, T,
                                      cfg.heap_bytes, reset_round)
    model = QuarantineModel(cores, sanitizer.quarantine_slots(T))
    state, _ = run_stream(cfg, tape, device, misuse_rounds, model=model)
    # the expected counts assume every session alloc was served: a failed
    # one would leave a slot NULL (fails also counts tagged reallocs)
    inner_fails = int((state.alloc.stats.fails
                       - state.reports.realloc_after_free).sum())
    if inner_fails:
        raise AssertionError(f"sanitizer misuse stream: {inner_fails} "
                             f"session allocs failed")
    errs = san_mismatches(state.reports, want) + model.check(state)
    if errs:
        raise AssertionError("sanitizer misuse stream: "
                             + "; ".join(errs[:6]))
    check_residuals("sanitizer (misuse)",
                    telemetry.conservation_residuals(cfg, state))
    injected = {k: int(v.sum()) for k, v in targets.items()}
    ring = {k: int(want[k].sum()) for k in RING_KEYS}
    ring["evicting_cores"] = int((want["evicted"] > 0).sum())
    print(f"sanitizer, misuse stream ({misuse_rounds} rounds at C={cores}, "
          f"reset at round {reset_round}): reports == the generator's "
          f"counts on every core (injected {injected}; evicted_free counts "
          f"as wild_ops), quarantine FIFO on every core ("
          f"{ring['quarantined']} parked, {ring['evicted']} evicted, on "
          f"{ring['evicting_cores']} of {cores} cores), residual 0")
    out.update(injected=injected, ring=ring)
    del state
    if device.type == "cuda":
        check_devices(cfg, tape, device, torch.device("cpu"), misuse_rounds,
                      small)
        print(f"sanitizer misuse stream at C={small}: card == CPU on every "
              f"response field and state leaf of every round")
    return out


def sharded_phase(seed, device, cores=CORES, ranks=SHARD_RANKS,
                  rounds=SHARD_ROUNDS):
    """(d) `ShardedHeap(R=ranks, C=cores / ranks)` against
    `MultiCoreHeap(C=cores)` on hwsw and fused over `rounds` rounds of
    phase 5's stream, each resolving its own slots: equal per (rank, core)
    on every response field and state leaf every round; then
    `fleet_pressure` of the sharded state. Returns the result."""
    import numpy as np
    from repro_torch.core import heap, telemetry
    per = cores // ranks
    tape = session_tape(np.random.default_rng(seed), rounds, cores,
                        paper_cfg("hwsw").num_threads)
    out = {}
    for kind in ("hwsw", "fused"):
        cfg = paper_cfg(kind)
        sh = heap.ShardedHeap(cfg, num_ranks=ranks, num_cores=per,
                              device=device)
        mc = heap.MultiCoreHeap(cfg, num_cores=cores, device=device)
        runs = {"sharded": heap_object_run(sh, (ranks, per), tape, device),
                "multicore": heap_object_run(mc, (cores,), tape, device)}
        lockstep(runs, rounds, device, lambda r, reqs, resps, states:
                 pair_mismatches(r, "sharded", "multicore",
                                 resps["sharded"], resps["multicore"],
                                 states["sharded"], states["multicore"]),
                 what=kind)
        fp = telemetry.fleet_pressure(sh.state)
        div = telemetry.hwm_divergence(fp["rank_hwm"])
        out[kind] = {"rank_live": fp["rank_live"].tolist(),
                     "rank_hwm": fp["rank_hwm"].tolist(),
                     "divergence": div}
        print(f"sharded {kind}: ShardedHeap(R={ranks}, C={per}) == "
              f"MultiCoreHeap(C={cores}) per (rank, core) on every field and "
              f"leaf over {rounds} rounds; fleet_pressure rank_hwm "
              f"{fp['rank_hwm'].tolist()} B, divergence ratio "
              f"{div['ratio']:.3f} (trigger {div['trigger']})")
        del sh, mc, runs
    return out


def phase_regions(seed, device, smi, cores=CORES, rounds=CHECK_ROUNDS):
    """Phase 5c: (a) the tapes through sanitizer, arena and tlregion;
    (b) the arena session with resets over both spill backends; (c) the
    sanitizer's clean and misuse streams; (d) the sharded tier; (e) each
    new kind's round times, profiled round and the phase's peak device
    memory. Returns the result dict."""
    import torch
    cuda = device.type == "cuda"
    if cuda:
        torch.zeros(1, device=device)  # the allocator keeps stats from here
        torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    replayed, tape_launches = region_tapes(device)
    out = {"tape_rounds": replayed, "tape_launches": tape_launches,
           "tapes_s": time.perf_counter() - t0}
    print(f"tapes: {replayed} rounds replayed, the heap kernel launched "
          f"{tape_launches} times by the fused spills "
          f"[{out['tapes_s']:.1f} s]")
    t0 = time.perf_counter()
    out["arena"] = region_session(seed, device, smi, cores, rounds)
    out["arena_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sanitizer"] = sanitizer_phase(seed, device, smi, cores, rounds)
    out["sanitizer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sharded"] = sharded_phase(seed, device, cores)
    out["sharded_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if cuda else None
    peak = "not measured" if out["peak_gib"] is None else \
        f"{out['peak_gib']:.2f} GiB"
    print(f"phase 5c took {out['phase_s']:.1f} s: tapes "
          f"{out['tapes_s']:.1f}, arena {out['arena_s']:.1f}, sanitizer "
          f"{out['sanitizer_s']:.1f}, sharded {out['sharded_s']:.1f}; peak "
          f"device memory {peak} [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 5d: the workload generators and the decode-serving engine
# ---------------------------------------------------------------------------
def fresh_launches():
    """Set the heap kernel's launch counter to 0; returns a reader of the
    launches since."""
    from repro_torch.kernels import heap_step
    heap_step.fused_heap_step.launches = 0
    return lambda: heap_step.fused_heap_step.launches


def check_launches(device, what, got, want):
    if device.type == "cuda" and got != want:
        raise AssertionError(f"{what}: the heap kernel launched {got} "
                             f"times, expected {want}")


def tape_text(tape):
    """A tape as `Trace.save` writes it."""
    return json.dumps(tape.to_json(), indent=1) + "\n"


def record_pair(name, device, smoke=True):
    """Scenario `name` recorded on hwsw and then on fused: (hwsw tape,
    fused tape, the fused recording's heap kernel launches), after
    checking the two tapes equal apart from `recorded_kind`."""
    from repro_torch.workloads.scenarios import SCENARIOS
    a = SCENARIOS[name](smoke=smoke, kind="hwsw", device=device)
    launched = fresh_launches()
    b = SCENARIOS[name](smoke=smoke, kind="fused", device=device)
    launches = launched()
    # decode_serve's tape is the planner's alone: no heap round recorded
    check_launches(device, f"{name}: the fused recording", launches,
                   0 if name == "decode_serve" else a.rounds)
    if dict(a.to_json(), recorded_kind="fused") != b.to_json():
        raise AssertionError(f"{name}: the fused recording's tape != the "
                             "hwsw recording's")
    return a, b, launches


def wl_tapes(device):
    """(a) The four scenarios re-recorded at the reference's smoke sizes on
    hwsw, the seven kinds' expect blocks attached: byte-equal to the
    committed tapes (compared in memory); recorded again on fused: the
    same tape. Returns {name: per-tape numbers}."""
    from repro_torch.workloads import replay
    out = {}
    for name in TAPES:
        t0 = time.perf_counter()
        tape, _, rec_launches = record_pair(name, device)
        launched = fresh_launches()
        replay.attach_expectations(tape, device=device)
        attach_launches = launched()
        check_launches(device, f"{name}: attach_expectations",
                       attach_launches, tape.rounds)
        want = (ROOT / "benchmarks" / "tapes" / f"{name}.json").read_text()
        if tape_text(tape) != want:
            raise AssertionError(f"tape {name}: the port's recording is not "
                                 "byte-equal to the committed tape")
        out[name] = dict(rounds=tape.rounds, bytes=len(want),
                         fused_record_launches=rec_launches,
                         attach_launches=attach_launches,
                         s=time.perf_counter() - t0)
        print(f"tape {name}: re-recorded on hwsw, {tape.rounds} rounds, the "
              f"seven expect blocks attached: byte-equal to the committed "
              f"tape ({len(want)} B); recorded on fused: the same tape, "
              f"heap kernel launched {rec_launches} times by the recording "
              f"and {attach_launches} by the expect blocks' fused replay "
              f"[{out[name]['s']:.1f} s]")
    return out


def wl_full(device):
    """(b) The scenarios at the reference's ``record --full`` sizes on
    fused and on hwsw: equal apart from `recorded_kind`, lint clean, and
    `check_trace` over the two kinds' replays: fused == hwsw in full,
    residual 0. Returns {name: per-tape numbers}."""
    from repro_torch.workloads import replay, trace
    out = {}
    for name in TAPES:
        t0 = time.perf_counter()
        a, _, rec_launches = record_pair(name, device, smoke=False)
        lint = trace.trace_lint(a)
        if lint:
            raise AssertionError(f"full {name}: " + "; ".join(lint[:4]))
        launched = fresh_launches()
        results = replay.attach_expectations(a, ("hwsw", "fused"), device)
        replay_launches = launched()
        check_launches(device, f"full {name}: the fused replay",
                       replay_launches, a.rounds)
        # each kind's block from its own replay: what check_trace adds is
        # the parity pair and the residual
        errs = replay.check_trace(a, results=results)
        if errs:
            raise AssertionError(f"full {name}: " + "; ".join(errs))
        out[name] = dict(rounds=a.rounds, ops=a.ops,
                         fused_record_launches=rec_launches,
                         replay_launches=replay_launches,
                         s=time.perf_counter() - t0)
        print(f"full {name}: {a.rounds} rounds, {a.ops} ops, recorded on "
              f"fused == on hwsw, lint clean, replays fused == hwsw in full "
              f"({results['fused']['digest_full'][:12]}...), residual 0; "
              f"heap kernel launched {rec_launches} times by the recording, "
              f"{replay_launches} by the replay [{out[name]['s']:.1f} s]")
    return out


def wl_graph(device, gcfg=None):
    """(c) `compare_all` at the paper's partition (`GraphConfig()`) on every
    kind: the fused row == the hwsw row. Returns the rows and numbers."""
    from repro_torch.graphupd import workload as gw
    gcfg = gcfg or gw.GraphConfig()
    T = gcfg.num_threads
    rounds = -(-gcfg.n_edges_pre // T) + -(-gcfg.n_edges_new // T)
    t0 = time.perf_counter()
    launched = fresh_launches()
    rows = gw.compare_all(gcfg, device=device)
    launches = launched()
    secs = time.perf_counter() - t0
    check_launches(device, "compare_all", launches, rounds)
    if rows["fused"] != rows["hwsw"]:
        raise AssertionError(f"compare_all: fused {rows['fused']} != hwsw "
                             f"{rows['hwsw']}")
    print(f"compare_all ({gcfg.n_nodes} nodes, {gcfg.n_edges_pre} + "
          f"{gcfg.n_edges_new} edges, {gcfg.heap_bytes >> 20} MiB heap, "
          f"{rounds} rounds a kind): fused == hwsw; us/edge " + ", ".join(
              f"{k} {v['us_per_edge']:.4g}" for k, v in rows.items())
          + f" (modeled); heap kernel launched {launches} times "
          f"[{secs:.1f} s]")
    return dict(rows=rows, rounds=rounds, launches=launches, s=secs)


def decode_engines(shape, traffic, device, cfg_of):
    """A DecodeServe of kind hwsw and one of kind fused over one [R, C, T]
    fleet, `cfg_of(kind)` their `SystemConfig`s."""
    from repro_torch.launch.serve_decode import DecodeServe
    R, C, _ = shape
    return {k: DecodeServe(cfg_of(k), R, C, traffic=traffic, device=device)
            for k in ("hwsw", "fused")}


def decode_lockstep(engines, plan, device, profile_at=None):
    """Run `plan` through the hwsw and fused engines' `run_segment` one
    round at a time, in lockstep: after every round the responses, and at
    the end the fleet states, must agree bit for bit. Round `profile_at`
    runs under the profiler on the card (its time is left out of the
    host-clock times). Returns {kind: (state, stacked responses, round
    seconds, profile or None, the profiled round or None)}."""
    import torch
    from repro_torch.core import heap
    from repro_torch.core.heap import AllocResponse
    grids = (plan.op, plan.size, plan.ptr_ref, plan.ptr_raw)
    runs = {k: dict(state=heap.sharded_init(e.cfg, e.num_ranks, e.num_cores,
                                            device=device),
                    slots=e.new_slots(plan.rounds), resps=[], times=[],
                    prof=None, profiled=None) for k, e in engines.items()}
    for r in range(plan.rounds):
        seg = tuple(g[r:r + 1] for g in grids)
        for k, e in engines.items():
            run = runs[k]

            def one():
                return e.run_segment(run["state"], run["slots"], r, seg)

            if r == profile_at and device.type == "cuda":
                (run["state"], run["slots"], resp), *run["prof"] = \
                    profile_call(one)
                run["profiled"] = r
            else:
                sync(device)
                t0 = time.perf_counter()
                run["state"], run["slots"], resp = one()
                sync(device)
                run["times"].append(time.perf_counter() - t0)
            run["resps"].append(resp)
        errs = pair_mismatches(r, "fused", "hwsw", runs["fused"]["resps"][-1],
                               runs["hwsw"]["resps"][-1], (), ())
        if errs:
            raise AssertionError("decode session: " + "; ".join(errs[:4]))
    errs = pair_mismatches("end", "fused", "hwsw", resp, resp,
                           runs["fused"]["state"], runs["hwsw"]["state"],
                           fields=())
    if errs:
        raise AssertionError("decode session: " + "; ".join(errs[:4]))
    return {k: (run["state"], AllocResponse(
        *(torch.cat(f) for f in zip(*run["resps"]))), run["times"],
        run["prof"], run["profiled"]) for k, run in runs.items()}


def decode_reports(engines, plan, ran):
    """Each kind's report; fused's == hwsw's and the residual 0."""
    reps = {k: engines[k].report(plan, resps, st)
            for k, (st, resps, *_) in ran.items()}
    if reps["fused"] != reps["hwsw"]:
        bad = [f for f in reps["hwsw"] if reps["fused"][f] != reps["hwsw"][f]]
        raise AssertionError(f"decode reports: fused != hwsw on {bad}")
    for k, rep in reps.items():
        if rep["conservation_residual"] != 0:
            raise AssertionError(f"decode {k}: conservation residual "
                                 f"{rep['conservation_residual']}")
    return reps


# benchmarks/fig_decode.py at its full size: R, C, T, the heap, the traffic
FIG_DECODE = ((2, 4, 16), 1 << 20, dict(
    seed=29, rounds=96, session_rate=6.0, num_tenants=32, queue_cap=32,
    max_context=576))


def wl_decode_small(device, small=FIG_DECODE):
    """(d) DecodeServe at the reference's full fig_decode size on fused and
    hwsw in lockstep (bit for bit, residual 0); each report == the CPU's
    on every field; the hottest tenant's core slice replays bit for bit
    through `replay.replay`."""
    import torch
    from repro_torch.core import system as sysm
    from repro_torch.launch.serve_decode import DecodeTraffic
    from repro_torch.workloads import replay
    t0 = time.perf_counter()
    shape, heap_bytes, traffic = small
    tc = DecodeTraffic(**traffic)

    def cfg_of(kind):
        return sysm.SystemConfig(kind=kind, heap_bytes=heap_bytes,
                                 num_threads=shape[2])

    engines = decode_engines(shape, tc, device, cfg_of)
    plan = engines["fused"].plan()
    launched = fresh_launches()
    ran = decode_lockstep(engines, plan, device)
    launches = launched()
    check_launches(device, "decode session (d)", launches, plan.rounds)
    reps = decode_reports(engines, plan, ran)
    for k, e in decode_engines(shape, tc, torch.device("cpu"),
                               cfg_of).items():
        _, rep = e.serve(plan)
        if rep != reps[k]:
            bad = [f for f in rep if rep[f] != reps[k][f]]
            raise AssertionError(f"decode {k}: the card's report != the "
                                 f"CPU's on {bad}")
    rank, core = plan.tenant_home[0]
    tape = engines["fused"].trace(plan, rank, core)
    launched = fresh_launches()
    got, _, _ = replay.replay(tape, "fused", device=device)
    replay_launches = launched()
    check_launches(device, "decode trace replay", replay_launches,
                   tape.rounds)
    served = ran["fused"][1]
    for f, x in zip(got._fields, got):
        if not torch.equal(x, getattr(served, f)[:, rank, core]):
            raise AssertionError(f"decode trace r{rank}c{core}: replay != "
                                 f"the session on {f}")
    rep = reps["fused"]
    secs = time.perf_counter() - t0
    print(f"decode (d) R,C,T={shape}, {plan.rounds} rounds, rate "
          f"{tc.session_rate}: fused == hwsw bit for bit, residual 0, each "
          f"report == the CPU's; heap kernel launched {launches} times; "
          f"core r{rank}c{core}'s slice ({tape.ops} ops) replays bit for "
          f"bit ({replay_launches} launches); {rep['decode_tokens']} decode "
          f"tokens, tokens_per_sec {rep['tokens_per_sec']:.6g}, us_per_op "
          f"{rep['us_per_op']:.6g} (modeled) [{secs:.1f} s]")
    return dict(launches=launches, replay_launches=replay_launches,
                report=rep, trace_core=[rank, core], trace_ops=tape.ops,
                s=secs)


# the paper's fleet: phase 5c's sharded tier (R=4 ranks of 128 cores, T=16)
FLEET = ((SHARD_RANKS, CORES // SHARD_RANKS, 16), dict(
    seed=29, rounds=96, num_tenants=2048, queue_cap=2048, max_context=576))
# the highest of 6, 12, ..., 384 sessions a round at which the planner
# drops at most 1 % of the offered sessions on FLEET (PERF.md §4)
FLEET_RATE = 24.0


def wl_decode_fleet(device, smi, fleet=FLEET, rate=FLEET_RATE,
                    cfg_of=paper_cfg):
    """(e) DecodeServe on the paper's fleet (R=4, C=128, T=16, the paper's
    32 MiB heaps) at `rate`, fused and hwsw in lockstep, bit for bit,
    residual 0; host-clock ms per round per kind, one profiled round's
    launches and busy share, the planner's host seconds, the heap kernel's
    launches, the modeled tokens_per_sec and us_per_op."""
    from repro_torch.launch.serve_decode import DecodeTraffic
    t_phase = time.perf_counter()
    shape, traffic = fleet
    tc = DecodeTraffic(session_rate=rate, **traffic)
    engines = decode_engines(shape, tc, device, cfg_of)
    t0 = time.perf_counter()
    plan = engines["fused"].plan()
    plan_s = time.perf_counter() - t0
    launched = fresh_launches()
    t0 = time.perf_counter()
    ran = decode_lockstep(engines, plan, device, profile_at=plan.rounds // 2)
    session_s = time.perf_counter() - t0
    launches = launched()
    check_launches(device, "decode session (e)", launches, plan.rounds)
    t0 = time.perf_counter()
    rep = decode_reports(engines, plan, ran)["fused"]
    report_s = time.perf_counter() - t0
    out = dict(rate=rate, plan_s=plan_s, session_s=session_s,
               report_s=report_s, launches=launches, offered=plan.offered,
               dropped=plan.dropped, dispatched=plan.dispatched,
               tenants_homed=len(plan.tenant_home),
               tokens_per_sec=rep["tokens_per_sec"],
               us_per_op=rep["us_per_op"], kinds={})
    R, C, T = shape
    print(f"decode (e) R={R} C={C} T={T}, {plan.rounds} rounds, rate {rate}: "
          f"{plan.offered} sessions offered, {plan.dropped} dropped, "
          f"{plan.dispatched} ops for {len(plan.tenant_home)} tenants; "
          f"planner {plan_s:.3f} s of host; fused == hwsw bit for bit, "
          f"residual 0; heap kernel launched {launches} times; "
          f"tokens_per_sec {rep['tokens_per_sec']:.6g}, us_per_op "
          f"{rep['us_per_op']:.6g} (modeled); session {session_s:.1f} s, "
          f"report {report_s:.1f} s")
    for k, (_, _, times, prof, at) in ran.items():
        timed = [r for r in range(plan.rounds) if r != at]
        out["kinds"][k] = print_times(
            f"decode (e) {k}", times, prof or (None, 0.0, 0, []), smi,
            ops=int((plan.op[timed] != 0).sum()), what="engine round",
            profiled_as="no round" if at is None else f"round {at}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_workloads(device, smi, graph=None, full=True, small=FIG_DECODE,
                    fleet=FLEET, fleet_cfg=paper_cfg):
    """Phase 5d: (a) the tapes re-recorded byte for byte; (b) the
    full-scale recordings with parity (skipped with `full` False); (c)
    `compare_all` at the paper's partition (or `graph`); (d) DecodeServe at
    fig_decode's size; (e) DecodeServe on the paper's fleet. Each path
    sets the heap kernel's launch counter to 0 just before it and reads it
    just after. Returns the result dict."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("tapes", lambda: wl_tapes(device)),
                    ("full", lambda: wl_full(device) if full else None),
                    ("graph", lambda: wl_graph(device, graph)),
                    ("decode_small", lambda: wl_decode_small(device, small)),
                    ("decode_fleet", lambda: wl_decode_fleet(
                        device, smi, fleet, cfg_of=fleet_cfg))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[f"{key}_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 5d took {out['phase_s']:.1f} s: " + ", ".join(
        f"{k} {out[f'{k}_s']:.1f}" for k in ("tapes", "full", "graph",
                                              "decode_small",
                                              "decode_fleet")) + f" [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phases 6-7: the paged-attention kernel and the serving path
# ---------------------------------------------------------------------------
def paged_case(rng, H, KVH, D, page, pages, lens, dtype, device):
    """Inputs of one paged-attention call: a permuted page table over a
    pool of B * pages + 3 pages, with -1 entries past the end of sequence 1
    and one inside the valid range of the last sequence (reads page 0)."""
    import numpy as np
    import torch
    B = len(lens)
    N = B * pages + 3

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    pt = rng.permutation(N)[:B * pages].reshape(B, pages).astype(np.int32)
    if B > 1:
        pt[1, 1:] = -1
    pt[-1, 1] = -1
    return (f(B, H, D), f(N, page, KVH, D), f(N, page, KVH, D),
            torch.from_numpy(pt).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def assert_close(got, want, tol, what):
    """max |got - want|; raises beyond atol = rtol = tol."""
    import torch
    g, w = got.float(), want.float()
    diff = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel != plain version beyond "
                             f"{tol} (max |diff| {diff})")
    return diff


def pa_reading(got, want, tol):
    """(max |got - want|, the largest share of atol = rtol = tol any
    element uses; above 1 fails, as `assert_close`)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), float((d / (tol + tol * w.abs())).max())


def phase_paged_vs_plain(seed, device):
    """The kernel against its plain version over the sweep and the long
    case; returns {dtype name: max |diff|}."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(seed)
    worst, long_diff = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for case in PA_CASES + (PA_LONG,):
            H, KVH, D, page, pages, lens = case
            args = paged_case(rng, H, KVH, D, page, pages, lens, dt, device)
            got = pa.paged_attention(*args)
            want = pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            d = assert_close(got, want, PA_TOL[name],
                             f"{name} H={H} KVH={KVH} D={D} page={page}")
            if lens[0] == 0 and bool(got[0].any()):
                raise AssertionError("seq_len 0 did not give zeros")
            worst[name] = max(worst.get(name, 0.0), d)
            if case == PA_LONG:
                long_diff[name] = d
    H, KVH, D, page, pages, lens = PA_LONG
    pps, splits = pa.split_plan(len(lens) * KVH, pages,
                                pa.sm_count(device))
    print(f"paged attention, long sequence (B={len(lens)}, H={H}, "
          f"KVH={KVH}, D={D}, {lens[0]} tokens in {pages} pages of {page}: "
          f"{splits} splits of {pps} page(s)) == plain version: max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in long_diff.items()))
    q, k, v, _, _ = paged_case(rng, 2, 2, 128, 128, 2, (256, 256),
                               torch.float32, device)
    q2 = torch.cat([q[:1], q[:1]])
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=device)
    sl = torch.tensor([256, 256], dtype=torch.int32, device=device)
    out = pa.paged_attention(q2, k, v, pt, sl)
    out_sw = pa.paged_attention(q2, k, v, pt.flip(0).contiguous(), sl)
    if not torch.allclose(out[0], out_sw[1], atol=1e-6, rtol=0) or \
            torch.allclose(out[0], out[1]):
        raise AssertionError("the kernel does not follow the page table")
    return worst


def event_ms(fn, n, warm=3):
    """CUDA-event ms per call over n back-to-back calls after `warm`
    warm-up calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_calls(fn, n=PA_CALLS):
    """(CUDA-event ms per call over n back-to-back calls after warm-up,
    profiler device ms per call of every kernel the calls launched, the
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = event_ms(fn, n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = sum(device_us(e) for e in prof.key_averages()
              if device_us(e) > 0 and e.device_type.name == "CUDA")
    return ms, (dev / n / 1e3 if dev else None), prof


def pa_call_ms(prof):
    """Device ms per paged-attention call in a trace: (split + merge, the
    split kernel's, the merge's, split launches seen), each kernel averaged
    over the launches the trace recorded; None where it recorded none (the
    merge's 0.0 where no call had more than one split)."""
    s_us, s_n = kernel_events(prof, PA_KERNEL)
    m_us, m_n = kernel_events(prof, PA_MERGE)
    split = s_us / 1e3 / s_n if s_n else None
    merge = m_us / 1e3 / m_n if m_n else 0.0
    return (None if split is None else split + merge), split, merge, s_n


def pa_bound(q, k_pages, seq_lens, page_table):
    """(bytes, fp32 operations) one call needs for these inputs: the K and
    V rows of the valid tokens, q and the output, the page table and the
    lengths, each once; q.k and p.v products plus the softmax's exp, max
    and sum per score."""
    B, H, D = q.shape
    KVH = k_pages.shape[2]
    elt = q.element_size()
    tokens = int(seq_lens.clamp(min=0).sum())
    nbytes = (2 * tokens * KVH * D * elt + 2 * B * H * D * elt
              + 4 * page_table.numel() + 4 * B)
    ops = 4 * tokens * H * D + 5 * tokens * H
    return nbytes, ops


def phase_serve(seed, device):
    """Phase 7; returns (result dict, the paged-attention kernels entry)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import heap_step
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kvcache import paged
    from repro_torch.launch import serve as srv
    from repro_torch.models import layers, registry, transformer

    cfg = configs.get(SERVE_ARCH)
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = registry.init(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in params["blocks"].values()) + sum(
        x.numel() for k, x in params.items() if k != "blocks")

    # ---- the main path, counters reset just before -------------------------
    heap_step.fused_heap_step.launches = 0
    pa.paged_attention.launches = 0
    res = srv.serve(cfg, batch=B, prompt_len=S, decode_steps=steps,
                    impl="kernel", seed=seed, device=device, params=params)
    torch.cuda.synchronize()
    pa_launches = pa.paged_attention.launches
    heap_launches = heap_step.fused_heap_step.launches
    # the pool's one core counts every thread that reached the backend (a
    # refill or a bypass); a round with none takes the skip branch
    backend_ops = {k: st["front_misses"] + st["bypass"] for k, st in
                   (("prefill", res.prefill_stats), ("all", res.stats))}
    print(f"serve: threads that reached the heap's backend in the "
          f"{res.pool_rounds} pool rounds: {backend_ops['all']} "
          f"({backend_ops['prefill']} in the {B} prefill rounds); "
          + ("every pool round took the skip branch"
             if backend_ops["all"] == 0 else
             f"at most {min(backend_ops['all'], res.pool_rounds)} rounds "
             f"took the run-carve or the serial walk"))
    if pa_launches != cfg.n_layers * steps:
        raise AssertionError(f"serve launched the paged-attention kernel "
                             f"{pa_launches} times, want {cfg.n_layers} x "
                             f"{steps}")
    # the pool serves on the reference's default kind, sw: plain PyTorch
    # rounds, no heap kernel
    if heap_launches != 0 or res.pool_kind != "sw" or res.pool_rounds == 0:
        raise AssertionError(f"serve's pool ({res.pool_kind}, "
                             f"{res.pool_rounds} rounds) launched the heap "
                             f"kernel {heap_launches} times")
    st = res.stats
    if st["fails"] != 0 or st["front_hits"] <= 0:
        raise AssertionError(f"pool stats {st}")
    if not res.logits_finite:
        raise AssertionError("non-finite logits in some step")
    if res.tokens.shape != (B, steps + 1) or \
            int(res.tokens.max()) >= cfg.vocab or int(res.tokens.min()) < 0:
        raise AssertionError(f"tokens {tuple(res.tokens.shape)} outside "
                             f"[0, {cfg.vocab})")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    pf_s, dec_s = res.timings["prefill_s"], res.timings["decode_s"]
    print(f"serve {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params in {cfg.dtype} "
          f"(init {init_s:.2f} s), {B} x {S} prompt tokens, {steps} decode "
          f"steps, page {cfg.page_size}; paged-attention launches "
          f"{pa_launches}; pool kind {res.pool_kind}, heap-step launches "
          f"{heap_launches} in {res.pool_rounds} pool rounds; pool {st}; "
          f"all logits finite; peak device memory {peak_gib:.2f} GiB")
    pool_ms = 1e3 * res.timings["pool_s"]
    print(f"serve timings: prefill {1e3 * pf_s:.2f} ms; decode "
          f"{1e3 * dec_s / steps:.3f} ms/step, {B * steps / dec_s:.2f} "
          f"tokens/s; waiting on the per-step length read-back "
          f"{1e3 * res.timings['sync_s'] / steps:.3f} ms/step; the "
          f"{res.pool_rounds} pool rounds {pool_ms:.2f} ms "
          f"({pool_ms / res.pool_rounds:.3f} ms each; the {B} prefill "
          f"extents come before the prefill's clock, the decode pages "
          f"inside the decode's)")

    # ---- the last step's layer-0 attention, kernel vs plain ----------------
    cache, p = res.cache, res.params
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pt, seq_lens = cache["page_table"], cache["seq_lens"]
    P, page = pt.shape[1], cfg.page_size
    pos = seq_lens - 1
    x = p["embed"][res.tokens[:, -2]].to(layers.torch_dtype(cfg.dtype))
    h = layers.rms_norm(x[:, None], p["blocks"]["ln1"][0])
    cos, sin = layers.rope_tables(pos[:, None], hd, cfg.rope_theta)
    q = layers.apply_rope(layers.qk_proj(h, p["blocks"]["wq"][0], H, hd),
                          cos, sin)[:, 0].contiguous()
    kp = cache["k_pages"][0].view(B * P, page, KVH, hd)
    vp = cache["v_pages"][0].view(B * P, page, KVH, hd)
    ptg = paged.global_page_table(pt, P)
    args = (q, kp, vp, ptg, seq_lens)
    got, want = pa.paged_attention(*args), pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    serve_err = assert_close(got, want, PA_TOL["bfloat16"],
                             "layer-0 attention of the last decode step")

    # ---- timings at these inputs (not on the path) -------------------------
    kern_ms, _, kprof = time_calls(lambda: pa.paged_attention(*args))
    kern_dev_ms, split_ms, merge_ms, k_seen = pa_call_ms(kprof)
    plain_ms, plain_dev_ms, _ = time_calls(
        lambda: pa.paged_attention_plain(*args), n=20)
    Stot = P * page
    bidx = torch.arange(B, device=device)[:, None]
    ptl = pt.long().clamp(0, P - 1)
    mask = (torch.arange(Stot, device=device)[None, :]
            < seq_lens[:, None])[:, None, None, :]

    def gather():
        kg = cache["k_pages"][0][bidx, ptl].reshape(B, Stot, KVH, hd)
        vg = cache["v_pages"][0][bidx, ptl].reshape(B, Stot, KVH, hd)
        return kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()

    kg, vg = gather()

    def sdpa(kg, vg):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kg, vg, attn_mask=mask, enable_gqa=True)[:, :, 0]

    # a yardstick, not a check: in bf16 it may round the scores and p to
    # bf16, where the kernel and the plain version keep them in fp32
    lib_err = float((sdpa(kg, vg).float() - want.float()).abs().max())
    lib_ms, lib_dev_ms, _ = time_calls(lambda: sdpa(kg, vg))
    libg_ms, libg_dev_ms, _ = time_calls(lambda: sdpa(*gather()))
    nbytes, nops = pa_bound(q, kp, seq_lens, ptg)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / FP32_OPS_PER_S
    dev = "not measured" if kern_dev_ms is None else \
        f"{kern_dev_ms:.5f} ms device time/call (split {split_ms:.5f} + " \
        f"merge {merge_ms}) over the {k_seen} calls the profiler recorded"
    print(f"paged attention at the last step's layer-0 inputs (B={B}, "
          f"H={H}, KVH={KVH}, D={hd}, {int(seq_lens[0])} tokens): kernel "
          f"{kern_ms:.5f} ms/call (CUDA events, back to back), {dev}; "
          f"plain version {plain_ms:.4f} ms/call; "
          f"scaled_dot_product_attention {lib_ms:.5f} ms/call over gathered "
          f"K/V (device {lib_dev_ms}), {libg_ms:.5f} ms with the gather "
          f"(device {libg_dev_ms}); bound {max(bytes_ms, ops_ms):.6f} ms "
          f"({nbytes} B, {nops} fp32 ops); kernel == plain max |diff| "
          f"{serve_err}, yardstick vs plain max |diff| {lib_err}")

    # ---- device busy share over a few more decode steps --------------------
    dcfg = dataclasses.replace(cfg, attend_impl="kernel")
    toks = res.tokens[:, -1:]
    cache, logits = transformer.decode(dcfg, p, cache, {"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE):
            toks = torch.argmax(logits, dim=-1)[:, None]
            cache, logits = transformer.decode(dcfg, p, cache,
                                               {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0 and e.device_type.name == "CUDA":
            busy += us
            launches += e.count
            top.append((us / SERVE_PROFILE / 1e3, e.count, e.key[:60]))
    top.sort(reverse=True)
    step_pa_ms, step_split_ms, step_merge_ms, step_pa_n = pa_call_ms(prof)
    step_pa_total_ms = sum(kernel_events(prof, k)[0] for k in
                           (PA_KERNEL, PA_MERGE)) / 1e3 / SERVE_PROFILE
    wall_ms = 1e3 * wall / SERVE_PROFILE
    busy_ms = busy / SERVE_PROFILE / 1e3 if busy else None
    if busy_ms is None:
        print("profiler: no device time recorded; busy share not measured")
    else:
        print(f"profiler over {SERVE_PROFILE} decode steps: device busy "
              f"{busy_ms:.3f} of {wall_ms:.3f} ms/step "
              f"({100 * busy_ms / wall_ms:.1f} %), "
              f"{launches / SERVE_PROFILE:.0f} device launches/step, "
              f"paged attention {step_pa_total_ms:.4f} ms/step, "
              f"{step_pa_ms} ms device time/call in situ "
              f"(split {step_split_ms} + merge {step_merge_ms}; "
              f"{step_pa_n} of {cfg.n_layers * SERVE_PROFILE} calls "
              f"recorded); top: " + "; ".join(
                  f"{k} {ms:.3f} ms/step x{c}" for ms, c, k in top[:6]))
    result = dict(
        arch=cfg.name, n_params=n_params, init_s=init_s, batch=B,
        prompt=S, decode_steps=steps, pool_rounds=res.pool_rounds,
        pool_backend_ops=backend_ops["all"], pool_kind=res.pool_kind,
        pool_ms=pool_ms, pool_stats=st, pa_launches=pa_launches,
        heap_launches=heap_launches,
        peak_gib=peak_gib, prefill_ms=1e3 * pf_s,
        decode_ms_per_step=1e3 * dec_s / steps,
        tokens_per_s=B * steps / dec_s,
        sync_ms_per_step=1e3 * res.timings["sync_s"] / steps,
        pa_ms=kern_ms, pa_device_ms=kern_dev_ms, pa_device_events=k_seen,
        pa_split_device_ms=split_ms, pa_merge_device_ms=merge_ms,
        pa_plain_ms=plain_ms, pa_plain_device_ms=plain_dev_ms,
        sdpa_ms=lib_ms, sdpa_device_ms=lib_dev_ms, sdpa_gather_ms=libg_ms,
        sdpa_gather_device_ms=libg_dev_ms, pa_bytes=nbytes, pa_ops=nops,
        pa_bytes_ms=bytes_ms, pa_ops_ms=ops_ms, pa_serve_err=serve_err,
        step_busy_ms=busy_ms, step_wall_ms=wall_ms,
        step_launches=launches / SERVE_PROFILE,
        step_pa_device_ms=step_pa_total_ms, step_pa_call_device_ms=step_pa_ms,
        step_pa_split_device_ms=step_split_ms,
        step_pa_merge_device_ms=step_merge_ms, step_pa_events=step_pa_n,
        step_top=[list(t) for t in top[:8]])
    entry = {
        "name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
        "replaces": PA_REPLACES, "launches": pa_launches,
        "max_abs_err": serve_err, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": lib_ms}
    return result, entry


# ---------------------------------------------------------------------------
# phases 8-10: the kernels reached through kernels.ops
# ---------------------------------------------------------------------------
def device_ms(prof, name):
    """(device ms per launch of kernel `name` in a trace, launches seen)."""
    us, seen = kernel_events(prof, name)
    return (us / 1e3 / seen if seen else None), seen


def buddy_sizes(rng, cores, batch):
    """[C, B] request sizes: log-uniform over 4 KiB - 1 MiB, with a share
    BUDDY_ODD each of 0, negative and (2^30, 2^31) sizes."""
    import numpy as np
    shape = (cores, batch)
    sizes = np.exp(rng.uniform(math.log(4096), math.log(1 << 20), shape))
    sizes = sizes.astype(np.int64)
    u = rng.random(shape)
    sizes[u < BUDDY_ODD] = 0
    neg = (u >= BUDDY_ODD) & (u < 2 * BUDDY_ODD)
    sizes[neg] = -rng.integers(1, 1 << 20, int(neg.sum()))
    wide = (u >= 2 * BUDDY_ODD) & (u < 3 * BUDDY_ODD)
    sizes[wide] = rng.integers(2 ** 30 + 1, 2 ** 31, int(wide.sum()))
    return sizes.astype(np.int32)


def served_bytes(sizes, offs, min_block):
    """Per-core bytes of the blocks served: next_pow2 with the int32 wrap
    (a size above 2^30 is served as min_block), at least min_block."""
    import numpy as np
    s = sizes.astype(np.int64)
    p2 = np.where(s > 2 ** 30, min_block,
                  1 << np.ceil(np.log2(np.maximum(s, 1))).astype(np.int64))
    r = np.maximum(p2, min_block)
    return np.where(offs >= 0, r, 0).sum(-1), r


def phase_buddy(seed, device, cores=CORES, batches=BUDDY_BATCHES,
                batch=BUDDY_BATCH):
    """Phase 8; returns (result dict, the kernels entry)."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import buddy
    from repro_torch.kernels import buddy_traverse as bt
    from repro_torch.kernels import ops

    # ---- the small geometries of tests/test_kernels.py (not counted) -----
    rng = np.random.default_rng(seed + 8)
    for heap, mb in BUDDY_SMALL:
        for c, b in BUDDY_SMALL_CB + ((1, 40),):
            cfg = buddy.BuddyConfig(heap_bytes=heap, min_block=mb)
            tree = buddy.init(cfg, device=device).longest.repeat(c, 1)
            sizes = torch.from_numpy(rng.choice(
                [mb, 2 * mb, 7 * mb, heap // 8, 0, -1],
                (c, b)).astype(np.int32)).to(device)
            got = ops.buddy_alloc_batch(tree, sizes, heap_bytes=heap,
                                        min_block=mb)
            want = bt.buddy_alloc_batch_plain(tree, sizes, heap_bytes=heap,
                                              min_block=mb)
            torch.cuda.synchronize()
            for name, a, w in zip(("offsets", "tree"), got, want):
                if not torch.equal(a, w):
                    raise AssertionError(f"buddy kernel != plain version, "
                                         f"heap {heap}, min_block {mb}, "
                                         f"C={c}, B={b}: {name}")

    # ---- the main path: chained batches at the allocator's width ---------
    heap, mb = CONFIG.heap_bytes, CONFIG.block_bytes
    cfg = buddy.BuddyConfig(heap_bytes=heap, min_block=mb)
    kw = dict(heap_bytes=heap, min_block=mb)
    tree0 = buddy.init(cfg, device=device).longest.repeat(cores, 1)
    host_sizes = [buddy_sizes(rng, cores, batch) for _ in range(batches)]
    sizes = [torch.from_numpy(x).to(device) for x in host_sizes]
    torch.cuda.synchronize()
    bt.buddy_alloc_batch_kernel.launches = 0
    trees, offs = [tree0], []
    for s in sizes:
        o, tr = ops.buddy_alloc_batch(trees[-1], s, **kw)
        offs.append(o)
        trees.append(tr)
    torch.cuda.synchronize()
    launches = bt.buddy_alloc_batch_kernel.launches
    if launches != batches:
        raise AssertionError(f"buddy main path launched the kernel "
                             f"{launches} times for {batches} batches")
    served_total = np.zeros(cores, np.int64)
    served, failed, steps = [], [], 0
    for k in range(batches):
        w_offs, w_tree = bt.buddy_alloc_batch_plain(trees[k], sizes[k], **kw)
        torch.cuda.synchronize()
        if not torch.equal(offs[k], w_offs) or \
                not torch.equal(trees[k + 1], w_tree):
            raise AssertionError(f"buddy kernel != plain version in batch "
                                 f"{k}")
        o = offs[k].cpu().numpy()
        if np.any(o[host_sizes[k] <= 0] != -1):
            raise AssertionError("a size <= 0 was served")
        got_bytes, r = served_bytes(host_sizes[k], o, mb)
        served_total += got_bytes
        served.append(int((o >= 0).sum()))
        failed.append(int((o < 0).sum()))
        depth_left = np.log2(np.maximum(heap // r, 1))  # levels below root
        steps += int(np.where(o >= 0, 2 * depth_left, 0).sum())
        if np.any((o >= 0) & ((o % np.minimum(r, heap)) != 0)):
            raise AssertionError("a block is not aligned to its size")
    free = buddy.free_bytes(cfg, buddy.BuddyState(trees[-1])).cpu().numpy()
    if np.any(free != heap - served_total):
        raise AssertionError("free bytes != heap - blocks served")
    if failed[-1] == 0:
        raise AssertionError("the trees never filled")
    print(f"buddy batch: {batches} x {batch} requests on each of {cores} "
          f"cores ({heap >> 20} MiB heaps, {mb} B blocks, "
          f"{cfg.n_nodes}-node trees, {4 * cfg.n_nodes * cores >> 20} MiB "
          f"of trees): kernel launched {launches} times, == plain version "
          f"bit for bit in every batch and at the small geometries; served "
          f"{served} / failed {failed} per batch; free bytes == heap - "
          f"served on every core (min {int(free.min())} B)")

    # ---- timings (not on the path) -----------------------------------------
    def run_kernel():
        tr = tree0
        for s in sizes:
            _, tr = ops.buddy_alloc_batch(tr, s, **kw)

    def run_plain():
        tr = tree0
        for s in sizes:
            _, tr = bt.buddy_alloc_batch_plain(tr, s, **kw)

    kern_ms, _, prof = time_calls(run_kernel, n=20)
    kern_ms /= batches
    dev_ms, seen = device_ms(prof, BUDDY_KERNEL)
    plain_ms = event_ms(run_plain, 1, warm=1) / batches
    nbytes = 2 * 4 * cores * cfg.n_nodes + 2 * 4 * cores * batch
    nops = INT_STEP_OPS * steps / batches
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / INT_OPS_PER_S
    # one request per core: the copy in and out and one walk (not counted)
    one = sizes[0][:, :1].contiguous()
    b1_ms, _, prof1 = time_calls(
        lambda: ops.buddy_alloc_batch(tree0, one, **kw), n=20)
    b1_dev_ms, b1_seen = device_ms(prof1, BUDDY_KERNEL)
    print(f"buddy kernel {kern_ms:.5f} ms/launch (CUDA events, back to "
          f"back), device time {dev_ms} ms/launch over {seen} launches "
          f"recorded; plain version {plain_ms:.3f} ms/launch; bound "
          f"{max(bytes_ms, ops_ms):.6f} ms ({nbytes} B; {nops:.0f} int ops "
          f"over {steps / batches:.0f} walk steps a launch, at most "
          f"{batch * 2 * cfg.depth} a core); no single PyTorch call "
          f"computes it; at B=1 (copy in, one walk, copy out) "
          f"{b1_ms:.5f} ms/launch (CUDA events), device time {b1_dev_ms} "
          f"ms/launch over {b1_seen} launches recorded")
    result = dict(cores=cores, batches=batches, batch=batch,
                  n_nodes=cfg.n_nodes, served=served, failed=failed,
                  launches=launches, kernel_ms=kern_ms,
                  kernel_device_ms=dev_ms, kernel_device_events=seen,
                  plain_ms=plain_ms, bytes=nbytes, int_ops=nops,
                  walk_steps=steps, bytes_ms=bytes_ms, ops_ms=ops_ms,
                  b1_ms=b1_ms, b1_device_ms=b1_dev_ms,
                  b1_device_events=b1_seen)
    entry = {
        "name": "buddy_alloc_batch", "route": "cuda", "source": BUDDY_SOURCE,
        "replaces": BUDDY_REPLACES, "launches": launches, "max_abs_err": 0,
        "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}
    return result, entry


def phase_freelist(seed, device, caches=None, n_ops=FL_OPS):
    """Phase 9; returns (result dict, the kernels entry)."""
    import torch
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core.pim_malloc import PimMallocConfig
    from repro_torch.kernels import freelist as fl
    from repro_torch.kernels import ops

    pm = PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                         num_threads=CONFIG.num_threads,
                         size_classes=CONFIG.size_classes,
                         block_bytes=CONFIG.block_bytes)
    T = caches or CONFIG.num_threads * CORES
    NC, CAP = pm.nc, pm.cap
    g = torch.Generator(device=device)
    g.manual_seed(seed + 9)
    i32 = dict(dtype=torch.int32, device=device, generator=g)
    stacks = torch.randint(0, CONFIG.heap_bytes, (T, NC, CAP), **i32)
    counts = torch.randint(0, CAP + 1, (T, NC), **i32)
    counts[:, 0], counts[:, -1] = 0, CAP  # pop-empty, push-full classes
    reqs = [(torch.randint(-1, 2, (T,), **i32),
             torch.randint(-1, NC + 1, (T,), **i32),
             torch.randint(0, CONFIG.heap_bytes, (T,), **i32))
            for _ in range(n_ops)]
    torch.cuda.synchronize()
    fl.freelist_op_kernel.launches = 0
    states, outs = [(stacks, counts)], []
    for op, cls, ptr in reqs:
        st, ct = states[-1]
        p, c2, s2 = ops.freelist_op(st, ct, op, cls, ptr)
        outs.append(p)
        states.append((s2, c2))
    torch.cuda.synchronize()
    launches = fl.freelist_op_kernel.launches
    if launches != n_ops:
        raise AssertionError(f"freelist main path launched the kernel "
                             f"{launches} times for {n_ops} ops")
    pops = pushes = 0
    for k, (op, cls, ptr) in enumerate(reqs):
        want = fl.freelist_op_plain(*states[k], op, cls, ptr)
        torch.cuda.synchronize()
        got = (outs[k], states[k + 1][1], states[k + 1][0])
        for name, a, w in zip(("ptr_out", "counts", "stacks"), got, want):
            if not torch.equal(a, w):
                raise AssertionError(f"freelist kernel != plain version in "
                                     f"op {k}: {name}")
        pops += int((outs[k] >= 0).sum())
        pushes += int(((op == 1) & (states[k + 1][1].sum(1) >
                                    states[k][1].sum(1))).sum())
    mib = stacks.numel() * 4 >> 20
    print(f"freelist op: {n_ops} chained ops on {T} thread caches x {NC} "
          f"classes x CAP {CAP} ({mib} MiB of stacks): kernel launched "
          f"{launches} times, == plain version bit for bit in every op; "
          f"{pops} pops served, {pushes} pushes landed")

    args = (stacks, counts) + reqs[0]
    kern_ms, _, prof = time_calls(lambda: ops.freelist_op(*args), n=20)
    dev_ms, seen = device_ms(prof, FL_KERNEL)
    plain_ms = event_ms(lambda: fl.freelist_op_plain(*args), 3,
                        warm=1)
    nbytes = 2 * 4 * stacks.numel() + 2 * 4 * counts.numel() + 4 * 4 * T
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 20 * T / INT_OPS_PER_S
    print(f"freelist kernel {kern_ms:.5f} ms/launch (CUDA events, back to "
          f"back), device time {dev_ms} ms/launch over {seen} launches "
          f"recorded; plain version {plain_ms:.4f} ms/launch; bound "
          f"{max(bytes_ms, ops_ms):.6f} ms ({nbytes} B); no single PyTorch "
          f"call computes it")
    result = dict(caches=T, classes=NC, cap=CAP, ops=n_ops,
                  launches=launches, pops=pops, pushes=pushes,
                  kernel_ms=kern_ms, kernel_device_ms=dev_ms,
                  kernel_device_events=seen, plain_ms=plain_ms, bytes=nbytes,
                  bytes_ms=bytes_ms)
    entry = {
        "name": "freelist_op", "route": "cuda", "source": FL_SOURCE,
        "replaces": FL_REPLACES, "launches": launches, "max_abs_err": 0,
        "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}
    return result, entry


def flash_inputs(g, B, S, T, H, KVH, hd, dtype, device, scale=1.0):
    import torch
    return [(torch.randn((B, n, h, hd), generator=g, device=device) * scale)
            .to(dtype) for n, h in ((S, H), (T, KVH), (T, KVH))]


def flash_work(B, S, T, H, KVH, hd, causal, window, elt):
    """(bytes, operations) one call needs: q, k, v read and the output
    written once; 4 * hd operations (q.k and p.v) per visible pair."""
    import numpy as np
    i = np.arange(S)[:, None]
    j = np.arange(T)[None, :]
    vis = np.ones((S, T), bool) if not causal else i >= j
    if window:
        vis &= i - j < window
    pairs = int(vis.sum())
    nbytes = elt * (2 * B * S * H * hd + 2 * B * T * KVH * hd)
    return nbytes, 4 * hd * B * H * pairs


def flash_reading(got, want):
    """(max |got - want|, the largest share of its limit any element
    uses). fp32: atol = rtol = 3e-5. bf16: atol = rtol = 2.5e-2, and also
    |diff| <= FA_STEP |want| + FA_FLOOR max|want|: both sides round
    nearly the same fp32 value to bf16, so a sound kernel differs by at
    most one rounding step (<= 2^-7 |want|); the limit allows two. A share
    above 1 fails."""
    import torch
    if got.dtype != want.dtype:
        raise ValueError(f"{got.dtype} against {want.dtype}")
    g, w = got.float(), want.float()
    d, a = (g - w).abs(), w.abs()
    tol = FA_TOL[str(got.dtype).split(".")[1]]
    share = d / (tol + tol * a)
    if got.dtype == torch.bfloat16:
        floor = FA_FLOOR * float(a.max())
        share = share.maximum(d / (FA_STEP * a + floor))
    return float(d.max()), float(share.max())


def flash_check(got, want, what):
    """flash_reading, raising where an element passes its limit."""
    diff, share = flash_reading(got, want)
    if not share <= 1.0:
        raise AssertionError(f"{what}: kernel != plain version (max |diff| "
                             f"{diff}, {share:.3g} of the limit)")
    return diff, share


def phase_flash(seed, device, full=FA_FULL, sweep=FA_SWEEP):
    """Phase 10; returns (result dict, one kernels entry per full shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    g = torch.Generator(device=device)
    g.manual_seed(seed + 10)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for case in sweep:
            B, S, T, H, KVH, hd, causal, window = case
            q, k, v = flash_inputs(g, B, S, T, H, KVH, hd, dt, device,
                                   scale=FA_SCALE)
            got = ops.flash_attention_op(q, k, v, causal=causal,
                                         window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            d = assert_close(got, want, FA_TOL[name], f"flash {name} {case}")
            worst[name] = max(worst.get(name, 0.0), d)
    print("flash attention kernel == plain version over the sweep: max "
          "|diff| " + ", ".join(f"{k} {v:.3g} (tol {FA_TOL[k]})"
                                for k, v in worst.items()))

    # ---- the main path at full width, one shape at a time ------------------
    shapes, entries = [], []
    for key, label, case in full:
        B, S, T, H, KVH, hd, causal, window = case
        kw = dict(causal=causal, window=window)
        q, k, v = flash_inputs(g, *case[:6], torch.bfloat16, device)
        torch.cuda.synchronize()
        fa.flash_attention_kernel.launches = 0
        routes = fa.flash_attention_kernel.route_launches
        routes.update(dict.fromkeys(routes, 0))
        out = ops.flash_attention_op(q, k, v, **kw)
        torch.cuda.synchronize()
        launches = fa.flash_attention_kernel.launches
        main_routes = dict(routes)
        if launches != 1 or main_routes["bf16_tensor_cores"] != 1:
            raise AssertionError(f"flash {label}: the main path launched the "
                                 f"kernel {launches} times for one call, "
                                 f"by route {main_routes}")
        if out.shape != q.shape or out.dtype != q.dtype or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash {label}: misshapen or non-finite")
        want = fa.flash_attention_plain(q, k, v, **kw)
        d, share = flash_check(out, want, f"flash {label} bf16")
        q32, k32, v32 = (x.float() for x in (q, k, v))
        routes.update(dict.fromkeys(routes, 0))
        d32, share32 = flash_check(ops.flash_attention_op(q32, k32, v32, **kw),
                                   fa.flash_attention_plain(q32, k32, v32,
                                                            **kw),
                                   f"flash {label} fp32")
        fp32_routes = dict(routes)
        if fp32_routes["fp32_cuda_cores"] != 1:
            raise AssertionError(f"flash {label}: fp32 went by route "
                                 f"{fp32_routes}")
        del q32, k32, v32
        # the profiler tends to lose a trace's first few launches
        n = 20 if S <= 1024 else 8
        kern_ms, _, prof = time_calls(
            lambda: ops.flash_attention_op(q, k, v, **kw), n=n)
        dev_ms, seen = device_ms(prof, FA_KERNEL)
        plain_ms = event_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            2, warm=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_err = float((sdpa().transpose(1, 2).float()
                         - want.float()).abs().max())
        lib_ms, lib_dev_ms, _ = time_calls(sdpa, n=n)
        nbytes, nops = flash_work(*case, elt=q.element_size())
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / BF16_OPS_PER_S
        print(f"flash {label} (B={B}, S=T={S}, H={H}, KVH={KVH}, hd={hd}, "
              f"causal, bf16): kernel launched {launches} time (by route: "
              f"main path {main_routes}; the fp32 check {fp32_routes}), "
              f"== plain "
              f"version: bf16 max |diff| {d} ({share:.3g} of the limit), "
              f"fp32 max |diff| {d32} ({share32:.3g} of 3e-5); kernel "
              f"{kern_ms:.4f} ms/call (CUDA events), device time {dev_ms} ms "
              f"over {seen} launches recorded; plain version {plain_ms:.4f} "
              f"ms/call; scaled_dot_product_attention {lib_ms:.5f} ms/call "
              f"(device {lib_dev_ms}); bound {max(bytes_ms, ops_ms):.6f} ms "
              f"({nbytes} B, {nops} ops); yardstick vs plain max |diff| "
              f"{lib_err}")
        shapes.append(dict(label=label, case=list(case), launches=launches,
                           routes=main_routes, fp32_check_routes=fp32_routes,
                           kernel_ms=kern_ms, kernel_device_ms=dev_ms,
                           kernel_device_events=seen, plain_ms=plain_ms,
                           sdpa_ms=lib_ms, sdpa_device_ms=lib_dev_ms,
                           bytes=nbytes, ops=nops, bytes_ms=bytes_ms,
                           ops_ms=ops_ms, err=d, limit_share=share,
                           err_fp32=d32, limit_share_fp32=share32,
                           sdpa_err=lib_err))
        entries.append({
            "name": key, "route": "cuda", "source": FA_SOURCE,
            "replaces": FA_REPLACES, "launches": launches,
            "max_abs_err": max(d, d32, *worst.values()),
            "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms})
    return dict(sweep_err=worst, shapes=shapes), entries


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

    # ---- 2: build the kernels from source, in parallel ---------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all(verbose=True)
    for name in secs:
        _build.load(name)
    print("built " + ", ".join(f"{name}.cu in {s:.2f} s"
                                for name, s in secs.items())
          + f" for sm_90a ({time.perf_counter() - t0:.2f} s in all)")

    result, kernels = run(args.seed, device)

    # ---- 5b: the scan-based design points ----------------------------------
    scan_result = phase_scan(args.seed, device,
                             result.pop("fused_reports"), smi=smi)

    # ---- 5c: region frontends, sanitizer, sharded tier ---------------------
    region_result = phase_regions(args.seed, device, smi)

    # ---- 5d: the workload generators and the decode-serving engine --------
    workload_result = phase_workloads(device, smi)

    # ---- 6: paged attention, kernel against plain version -----------------
    t0 = time.perf_counter()
    worst = phase_paged_vs_plain(args.seed, device)
    print(f"paged attention kernel == plain version over the sweep: max "
          f"|diff| " + ", ".join(f"{k} {v:.3g} (tol {PA_TOL[k]})"
                                 for k, v in worst.items())
          + f" [{time.perf_counter() - t0:.1f} s]")

    # ---- 7: the serving path at full width ---------------------------------
    serve_result, pa_entry = phase_serve(args.seed, device)
    pa_entry["max_abs_err"] = max(pa_entry["max_abs_err"], *worst.values())
    kernels.append(pa_entry)

    # ---- 8-10: the kernels reached through kernels.ops ----------------------
    t0 = time.perf_counter()
    buddy_result, entry = phase_buddy(args.seed, device)
    kernels.append(entry)
    fl_result, entry = phase_freelist(args.seed, device)
    kernels.append(entry)
    fa_result, entries = phase_flash(args.seed, device)
    kernels += entries
    print(f"phases 8-10 took {time.perf_counter() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, scan=scan_result, regions=region_result,
                           workloads=workload_result, serve=serve_result,
                           build_s=secs,
                           paged_vs_plain=worst, buddy=buddy_result,
                           freelist=fl_result, flash=fa_result, gpu=smi,
                           kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
