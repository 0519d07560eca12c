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
     sizes on ``hwsw`` with the seven kinds' expect blocks attached (from
     phases 4, 5b and 5c's replays of the committed tapes), each
     serialised byte-equal to its committed tape (in memory: nothing is
     written), and recorded again on ``fused``: the same requests (one
     kernel launch per recorded round); (b) the four scenarios at the
     reference's ``record --full`` sizes on fused and on hwsw: equal tapes apart from
     ``recorded_kind``, lint clean, their replays fused == hwsw in full
     with residual 0; (c) `graphupd.compare_all` at fig16's
     smoke partition (96 nodes, 320 + 160 edges, 2 MiB heap; the paper's
     partition runs in phase 14 (c), through examples/graph_update_torch.py)
     on every kind, the fused row == the hwsw row; (d) DecodeServe at
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
 5e. the closed-loop and elastic serving tiers on the paper's fleet (R=4,
     C=128, T=16, 32 MiB heaps, 96 rounds, 2048 tenants, queue 4096, seed
     17), the heap kernel's launch counter set to 0 just before each path
     and read just after: (a) FleetServe at 128 arrivals a round
     (``least_loaded``) over 48 rounds on fused and hwsw in lockstep,
     bit for bit, the
     reports equal on every field, residual 0, no drops, the kernel once
     a round; ms per round per kind (host clock), one profiled round's
     launches and busy share, the planner's host seconds; (b) the same at
     512 arrivals a round on fused: drops, no dropped expiry free,
     residual 0; (c) elastic chaos (one dominant tenant, ``chunked``,
     2 kills, 2 stalls and a dropped round from seed 9, fig_elastic's
     migration rule) on fused and hwsw: equal reports and responses, at
     least one migration, killed cores dark, no dropped expiry free,
     residual 0, the kernel once a round; the fused session snapshotted
     at round 48 into a temporary directory outside the checkout,
     restored into a fresh engine on the card and finished == the
     uninterrupted run (the snapshot's bytes, save and restore seconds);
     (d) benchmarks/fig_elastic.py's storm snapshotted on the card and
     finished on the CPU == finished on the card, and `serve_session` at
     benchmarks/fig_serve.py's full size on sw and fused: card == CPU;
  6. the paged-attention kernels (split and merge) against their plain
     version on the card (fp32 to 2e-5, bf16 to 2e-2, atol = rtol): MHA,
     GQA and MQA at head_dim 32 and 128 with seq_len 0, 1, a page boundary
     and full, -1 entries and permuted page tables, granite-3-8b's decode
     shape (B=8, H=32, KVH=8, D=128, page 128, P=6), head_dim 160, the
     served families' decode shapes (H=KVH=16 at D=128, H=8 over one KV
     head at D=256, H=KVH=12 at D=64), and a long sequence (B=1,
     granite's heads, 8192 tokens in 64 pages of 128) that crosses many
     splits;
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
     fail deliberately broken kernels;
 11. the training path (no kernel of its own: the five kernels' launch
     counters are set to 0 before the timed steps and must read 0 after):
     (a) granite-3-8b at full width, one layer in fp32 at B=1, S=256:
     the loss and every gradient on the card against the CPU (loss to
     1e-5 relative, each gradient leaf to 1e-3 of its max |g|), and the
     same check failing a broken `rms_norm` (its ``1 +`` dropped); (b) 8
     of its 40 layers in bf16 (remat, attn_4d, gqa_expand, fp32 moments),
     4 x 4096 tokens a step in 2 microbatches, the trainer's AdamW and
     TokenStream: the memory plan from `param_specs` / `opt_state_specs`
     beside the measured peak, a warm-up step that changes every leaf, 4
     timed steps (host clock ending in a synchronise), tokens/s, one
     profiled step's launches, busy share and device time by kernel
     class, MFU against 989.4 TFLOP/s; then, with flat attention weights,
     one batch repeated 4 times from the init, its loss falling at every
     step; (c) the trainer's recovery drill through `launch.train.main`
     on the card (the reduced config in bf16, 12 steps, a checkpoint
     every 3, a failure at step 7): 1 recovery, steps 0-11, the final
     state == an uninterrupted run's bit for bit, and a checkpoint
     written on the card restored on the CPU == on the card;
 12. the moe, vlm and audio families served (olmoe-1b-7b, qwen2-moe-a2.7b,
     paligemma-3b, whisper-small; weights from ``--seed``, each model
     freed before the next): (a) each at full width, 2 layers (whisper's
     encoder too) in fp32, B=2, 128 text tokens (paligemma after its 256
     patches), prefill + 4 decode steps on the card (the paged-attention
     kernel) and on the CPU (its plain version), the CPU fed the card's
     greedy tokens: every step's logits within 1e-3 of max |logit| over
     the real vocabulary, and for the MoEs layer 0's expert ids of every
     forward, where a (token, k) that differs is printed with its
     probability gap and must be a near-tie (<= 1e-4); (b) each at full
     width and depth in bf16 through `launch.serve.serve(impl="kernel")`,
     8 requests of 512 text tokens (paligemma: 256 patches + 256; whisper:
     256 decoder tokens over 1536 encoder frames), 64 greedy decode steps,
     the counters set to 0 just before and read just after: every step's
     logits finite, paged attention launched layers x 64 times, the heap
     kernel 0 times, the pool's page allocations and stats, prefill s,
     decode ms/step and tokens/s, peak memory, and a few more decode steps
     under the profiler (launches, busy share); (c) paged attention at
     each model's last decode step's layer-0 inputs against its plain
     version (bf16 to 2e-2) with its device time per call, the plain
     version's, SDPA's over gathered K/V and the bound;
 13. the recurrent families (mamba2-130m: SSD; recurrentgemma-9b: RG-LRU
     + local attention), which launch none of the five kernels (weights
     from ``--seed``, each model freed before the next), in the order (b),
     (c), (a), so that the examples phase 14 starts after (c) overlap
     only (a), which is not timed: (a) each at full
     width in fp32 (mamba2's 24 layers, recurrentgemma's first group of
     3), 8 x 256 prompt tokens (two SSD chunks) and 8 greedy decode steps
     on the card and on the CPU, the CPU fed the card's tokens: every
     step's logits and every cached state (``ssm_state``, ``conv_state``,
     ``rg_state``, ``win_k``, ``win_v``) within 1e-3 of its max, the CPU's
     greedy tokens == the card's, the same limit failing a prefill with
     `rms_norm`'s ``1 +`` dropped; the loss and its gradients at B=1,
     S=256 as phase 11 (a) holds them (recurrentgemma's with flat
     attention weights; with its attn_4d ones they are printed); (b)
     each at full width and depth in bf16, 8 requests of 512 prompt
     tokens and 64 greedy decode steps, the five counters set to 0 just
     before and read (0) just after:
     recurrentgemma through `launch.serve.serve` (the pool's rounds and
     the threads that reached its backend), mamba2 through
     `ssm.prefill` / `ssm.decode` (serve refuses ssm, as the reference
     does); prefill s, decode ms/step, tokens/s, peak memory, every
     step's logits finite, and 4 more steps under the profiler (launches,
     busy share); (c) each trained through `launch.train.build` +
     `make_train_step` in bf16 with remat at full width, 4 x 4096 tokens a
     step (mamba2 all 24 layers in 2 microbatches; recurrentgemma 5 of 38
     layers, one group and the 2-layer tail, in 4): the state plan beside
     the peak, a warm-up step, 4 timed steps (the counters read 0),
     tokens/s, MFU, one profiled step's launches, busy share and device
     time by kernel class; then one batch repeated 4 times from the init
     (recurrentgemma with flat attention weights, as in phase 11), its
     loss falling at every step;
 14. the moe, vlm and audio families trained (no kernel of their own: the
     five counters read 0 over the timed steps), and the port's examples:
     (a) each at full width in fp32 (the MoEs 1 layer, paligemma and
     whisper 2, whisper's encoder too), B=1, 256 text tokens (paligemma
     after its 256 patches): the loss and every gradient on the card
     against the CPU as phase 11 (a) holds them, the MoEs with flat
     attention weights (read with their attn_4d ones too), the router's
     expert choices that differ between the two counted (each must be a
     near-tie; the gradients are held where none differs), and the same
     limits failing a broken layer (the MoEs' gate renormalisation summed
     over the wrong axis, the others' `rms_norm` without ``1 +``); (b)
     each trained as phase 13 (c) trains, at 4 x 4096 text tokens
     (paligemma after its 256 patches, whisper over its 1536 frames):
     olmoe-1b-7b 4 of 16 layers and qwen2-moe-a2.7b 2 of 24 in 2
     microbatches, paligemma-3b all 18 in 4, whisper-small all 12 in 2;
     MFU by `train_flops`, which counts a MoE token's routed experts at
     top_k of them and each block at the positions it runs over (held
     below 100 %); (c) the six examples (examples/*_torch.py) at their
     default sizes (graph_update at the paper's partition), each in a
     subprocess with ``--device cuda``: exit 0, the heap-step kernel
     launched by quickstart, graph_update (every kind; its fused row ==
     its hwsw row), serve_decode and serve_fleet (kind ``fused``), the
     paged-attention kernel by serve_paged, train_lm's recovery drill;
     quickstart's and graph_update's lines == their ``--device cpu``
     runs' but the launch count. The eight runs start after phase 13's
     timed steps and overlap its (a), phase 15 (which runs between phases
     13 and 14) and this (a), none of which times the card; (b) runs
     last, alone;
 15. the analysis tooling, the kernel counters read before and after:
     (a) `repro_torch.analysis.pimcheck --all-kinds --tapes --fixtures
     --device cuda`: exit 0, the seven kinds at the three tiers (C=1,
     C=2, R=2 x C=2; one mixed round each, recorded on the card) with 0
     findings and 0 suppressed, ``fused``'s recordings one
     ``repro_torch::heap_step`` node a round (checked through its plain
     version's ops), each seeded-bug fixture flagged by its pass, the
     four committed tapes lint-clean; and with the write-race pass left
     out, exit 1 on exactly the fixture planted for it; (b) the dry-run's
     one-device program (`launch.dryrun.program`) of phase 11 (b)'s cell
     on fake CUDA tensors: its argument bytes == the parameters, AdamW's
     m, v and count and the batch of phase 11's specs, byte for byte; its
     peak estimate between phase 11's state plan and phase 11's measured
     peak of this run; its FLOPs within 5 % of `train_flops` less what the
     checkpointed step does not run (`recompute_skipped`); a decode step
     at phase 7's shape records 40 paged-attention nodes and launches
     nothing; (c) the `dryrun --all` grid's decode cells (long_500k,
     decode_32k) until GRID_BUDGET_S is spent, one line each (its prefill
     and train cells take minutes each: tools/dryrun_grid.py); (d) the
     per-device SPMD program (`launch.dryrun.spmd_program`) of
     granite-3-8b at full width (2 layers) on fake ``"cuda"`` worlds:
     train_4k (256 x 4096, 8 microbatches) on 16 x 16 and 2 x 16 x 16,
     decode_32k on 16 x 16, and olmoe-1b-7b's train_4k on 16 x 16 (1
     layer: its routed experts on the mesh): each device's argument
     bytes == the rules' state (and for the decode, the whole weights the port's
     serving program holds) plus its rows, all-gathers over ``"data"`` in
     the train schedules and the combine's all-reduces over ``"model"``
     in the decode's, its FLOPs exactly the one-device program's share
     for granite's train cells (between that share and the whole for
     the others), the collective term at NVLINK_BW; per device its
     FLOPs, bytes, peak, collective bytes by op and by axis, the three
     terms and the bottleneck; no kernel launched;
 16. the heap fleet and sequence-parallel decode across processes
     (`repro_torch.launch.mesh.spawn`; ``nccl`` where there is a card for
     every process, ``gloo`` otherwise, its collectives staged through
     the host; the backend and process counts printed; the kernels are
     built before the processes start, and a process that fails fails
     the phase): (a) phase 5e (a)'s steady FleetServe session on fused
     over a rank mesh of 4 processes, one rank each == the same session
     with ``mesh=False`` in this process, bit for bit: every process's
     report, the gathered responses (every field) and the state leaves
     of the ranks it holds (sha256 digests); each process's heap-step
     launches (one a round), its ms a round and the share spent in the
     response gather; then ShardedHeap(R=8, C=16) (2 ranks a process) and
     ShardedHeap(R=2, C=64) (processes 2 and 3 hold none) == mesh=False
     over 4 malloc / realloc / free rounds; (b) phase 5e (c)'s chaos
     session snapshotted at round 48 on the mesh (process 0 writes the
     one set of files) and finished with ``mesh=False`` here, and
     snapshotted here and finished on the mesh: each == the uninterrupted
     run, the heap step once a round on every process; (c) granite-3-8b
     at full width (40 layers, bf16, flat attention weights made on each
     process from ``--seed``) through `launch.serve.serve(mesh=)` on a
     (data=1, model=2) mesh of 2 processes, 8 x 512 prompt tokens, 16
     greedy decode steps, each process holding half of each sequence's
     pages: paged attention launched 0 times there; against the same
     greedy decode on one device (paged-attention kernel; its top-2 gaps
     read from its logits), the mesh's decode fed the one-device tokens
     picks the same token at every step but where the one-device gap is
     below SEQPAR_BF16_GAP of max |logit| (each printed), and the
     free-running decode (and `serve` on one device) first differs only
     at such a step; ms a step and
     the all-reduces' share; a 2-layer slice in fp32 with the config's
     weights within SEQPAR_FP32_TOL of max |logit|, tokens equal;
 17. training on a (data=2, model=2) mesh of processes (`phase_mesh_train`:
     (a) the sharded step at full width against one device, (b)
     compressed_psum, (c) the trainer and a restore onto new meshes);
     (d) each process records its step 2 (`analysis.trace_utils.record`)
     and the dry-run of the same cell on a fake (2, 2) ``"cuda"`` world
     must run process 0's collectives exactly: every op, result shape,
     mesh axis, count and byte; the host-staged group's own byte count
     (`HostStagedGroup.moved_bytes`) is printed beside it.

In the ``kernels`` record, each kernel's ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are per launch: averaged over the launches
of its main path for the heap step (phase 5) and phases 8-9, for one call
at each shape of phase 10 (one entry per shape), at the last decode
step's layer-0 inputs for paged attention (phase 7: granite-3-8b's
shape; phase 12: one entry per new head shape, ``paged_attention_moe``
counting the launches of both MoEs, ``paged_attention_paligemma``,
``paged_attention_whisper``).

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the port's sources beside the script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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
    (32, 8, 160, 128, 6, (1, 128, 129, 768)),
    # the served families' decode shapes (phase 12): the MoEs' (G=1),
    # paligemma's (MQA, G=8, D=256) and whisper's (G=1, D=64)
    (16, 16, 128, 128, 6, (1, 128, 129, 576, 768)),
    (8, 1, 256, 128, 6, (1, 128, 129, 576, 768, 0)),
    (12, 12, 64, 128, 4, (1, 128, 320, 512)))
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
def phase_scan_tapes(device, tape_reports):
    """(a) The committed tapes through strawman, sw and hwsw, each held to
    its own expect block, and `check_trace` over all four kinds (phase 4's
    fused reports reused, ``tape_reports[tape]["fused"]``): lint clean,
    fused == hwsw in full, sw == hwsw on the semantic fields, residual 0.
    Adds each scan kind's report to `tape_reports`. Returns the rounds
    replayed."""
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
        results["fused"] = tape_reports[name]["fused"]
        tape_reports[name].update(results)
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


def profile_call(fn, top=5):
    """`fn()` under torch.profiler (device activity only: a scan-based
    round makes tens of thousands of launches): (its result, device busy
    ms or None, wall ms, device launches, the `top` kernels (all with
    None) as (ms, launches, name))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches, kernels = 0.0, 0, []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0:
            busy += us
            launches += e.count
            kernels.append((us / 1e3, e.count, e.key[:60]))
    kernels.sort(reverse=True)
    return result, (busy / 1e3 if busy > 0 else None), 1e3 * wall, \
        launches, kernels[:top]


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


def phase_scan(seed, device, tape_reports, cores=CORES,
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
    replayed = phase_scan_tapes(device, tape_reports)
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


def region_tapes(device, tape_reports=None):
    """(a) The committed tapes through sanitizer, arena and tlregion, the
    region kinds over each spill backend: every report held to its kind's
    committed expect block (digests, ok ops, dropped frees, live and hwm
    bytes) and residual 0; each kind's report over hwsw added to
    `tape_reports` (if given). Returns (rounds replayed, heap-kernel
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
            if tape_reports is not None and inner == "hwsw":
                tape_reports[name][kind] = rep
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


def phase_regions(seed, device, smi, cores=CORES, rounds=CHECK_ROUNDS,
                  tape_reports=None):
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
    replayed, tape_launches = region_tapes(device, tape_reports)
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


def wl_tapes(device, tape_reports):
    """(a) The four scenarios re-recorded at the reference's smoke sizes on
    hwsw, the seven kinds' expect blocks attached: byte-equal to the
    committed tapes (compared in memory); recorded again on fused: the
    same tape. The blocks come from `tape_reports` (phases 4, 5b and 5c's
    replays of the committed tapes, {tape: {kind: report}}: the same
    requests, so the same reports, if the recording is right). Returns
    {name: per-tape numbers}."""
    from repro_torch.workloads import replay
    out = {}
    for name in TAPES:
        t0 = time.perf_counter()
        tape, _, rec_launches = record_pair(name, device)
        tape.expect = replay.expect_blocks(tape_reports[name])
        want = (ROOT / "benchmarks" / "tapes" / f"{name}.json").read_text()
        if tape_text(tape) != want:
            raise AssertionError(f"tape {name}: the port's recording is not "
                                 "byte-equal to the committed tape")
        out[name] = dict(rounds=tape.rounds, bytes=len(want),
                         fused_record_launches=rec_launches,
                         s=time.perf_counter() - t0)
        print(f"tape {name}: re-recorded on hwsw, {tape.rounds} rounds, the "
              f"seven expect blocks attached (from phases 4-5c's replays): "
              f"byte-equal to the committed tape ({len(want)} B); recorded "
              f"on fused: the same "
              f"tape, heap kernel launched {rec_launches} times by the "
              f"recording [{out[name]['s']:.1f} s]")
    return out


def wl_full(device):
    """(b) The four scenarios at the reference's ``record
    --full`` sizes on fused and on hwsw: equal apart from
    `recorded_kind`, lint clean, and `check_trace` over the two kinds'
    replays: fused == hwsw in full, residual 0. Returns {name: per-tape
    numbers}."""
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
    """(c) `compare_all` at `gcfg` (the paper's partition, `GraphConfig()`,
    by default) on every kind: the fused row == the hwsw row. Returns the
    rows and numbers."""
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


def engine_lockstep(engines, plan, device, profile_at=None,
                    what="decode session"):
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
            raise AssertionError(f"{what}: " + "; ".join(errs[:4]))
    errs = pair_mismatches("end", "fused", "hwsw", resp, resp,
                           runs["fused"]["state"], runs["hwsw"]["state"],
                           fields=())
    if errs:
        raise AssertionError(f"{what}: " + "; ".join(errs[:4]))
    return {k: (run["state"], AllocResponse(
        *(torch.cat(f) for f in zip(*run["resps"]))), run["times"],
        run["prof"], run["profiled"]) for k, run in runs.items()}


def engine_reports(engines, plan, ran, what="decode"):
    """Each kind's report; fused's == hwsw's and the residual 0."""
    reps = {k: engines[k].report(plan, resps, st)
            for k, (st, resps, *_) in ran.items()}
    check_reports(reps, what)
    return reps


def check_reports(reps, what):
    """fused's report == hwsw's on every field, the residual 0 on every
    core (the reports sum |residual| over the cores)."""
    if reps["fused"] != reps["hwsw"]:
        bad = [f for f in reps["hwsw"] if reps["fused"][f] != reps["hwsw"][f]]
        raise AssertionError(f"{what} reports: fused != hwsw on {bad}")
    for k, rep in reps.items():
        if rep["conservation_residual"] != 0:
            raise AssertionError(f"{what} {k}: conservation residual "
                                 f"{rep['conservation_residual']}")


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
    ran = engine_lockstep(engines, plan, device)
    launches = launched()
    check_launches(device, "decode session (d)", launches, plan.rounds)
    reps = engine_reports(engines, plan, ran)
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
# (c)'s partition: fig16's smoke one (the paper's, 384 nodes and 4000 +
# 2000 edges, runs in phase 14 (c) through examples/graph_update_torch.py,
# on the card and on the CPU)
WL_GRAPH = dict(n_nodes=96, n_edges_pre=320, n_edges_new=160)


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
    ran = engine_lockstep(engines, plan, device, profile_at=plan.rounds // 2)
    session_s = time.perf_counter() - t0
    launches = launched()
    check_launches(device, "decode session (e)", launches, plan.rounds)
    t0 = time.perf_counter()
    rep = engine_reports(engines, plan, ran)["fused"]
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


def phase_workloads(device, smi, tape_reports, graph=None, full=True,
                    small=FIG_DECODE, fleet=FLEET, fleet_cfg=paper_cfg):
    """Phase 5d: (a) the tapes re-recorded byte for byte against
    `tape_reports` (`wl_tapes`); (b) the
    full-scale recordings with parity (skipped with `full` False); (c)
    `compare_all` at the paper's partition (or `graph`); (d) DecodeServe at
    fig_decode's size; (e) DecodeServe on the paper's fleet. Each path
    sets the heap kernel's launch counter to 0 just before it and reads it
    just after. Returns the result dict."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("tapes", lambda: wl_tapes(device, tape_reports)),
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
# phase 5e: the closed-loop and elastic serving tiers
# ---------------------------------------------------------------------------
# the paper's fleet (phase 5d (e)'s R=4 x C=128, T=16) under FleetServe
# traffic: 2048 tenants, an admission queue of 4096, seed 17. Sticky homes
# cap dispatch near 155 ops a round, so 128 arrivals a round is the steady
# state (no drops) and 512 the overload that backpressure answers
SERVE_FLEET = ((SHARD_RANKS, CORES // SHARD_RANKS, 16), dict(
    seed=17, rounds=96, num_tenants=2048, queue_cap=4096))
SERVE_RATE = 128.0
STEADY_ROUNDS = 48   # (a)'s session: the steady state, half of the plan's
OVERLOAD_RATE = 512.0
# the chaos session at the same fleet: one dominant tenant (zipf 2.2) homed
# chunked onto rank 0, 2 kills, 2 stalls and a dropped round from seed 9,
# fig_elastic's migration rule, a snapshot at round 48
CHAOS_ZIPF = 2.2
CHAOS_FAULTS = dict(seed=9, kills=2, stalls=2, drops=1)
CHAOS_MIGRATION = dict(ratio=1.3, min_bytes=2048, drain="interval",
                       check_rounds=8, max_moves=2)
SNAP_ROUND = 48
# benchmarks/fig_elastic.py's storm (R, C, T, heap, kind, traffic) with a
# snapshot at round 32, and benchmarks/fig_serve.py at its full size
STORM = ((2, 2, 8), 1 << 20, "hwsw", dict(
    seed=9, rounds=64, arrival_rate=14.0, num_tenants=8, zipf_a=2.2,
    queue_cap=24, max_lifetime=24))
STORM_SNAP = 32
FIG_SERVE = ((2, 4, 16), 1 << 19, dict(
    seed=17, rounds=96, arrival_rate=64.0, num_tenants=32, queue_cap=64))


def fs_steady(device, smi, fleet=SERVE_FLEET, rate=SERVE_RATE,
              cfg_of=paper_cfg):
    """(a) FleetServe at `rate` arrivals a round on fused and hwsw in
    lockstep: bit for bit, the reports equal on every field, residual 0,
    no drops, the heap kernel once a round; host-clock ms per round, one
    profiled round's launches and busy share, the planner's host
    seconds."""
    from repro_torch.launch.serve_fleet import FleetServe, TrafficConfig
    shape, traffic = fleet
    traffic = dict(traffic, rounds=min(traffic["rounds"], STEADY_ROUNDS))
    tc = TrafficConfig(arrival_rate=rate, **traffic)
    engines = {k: FleetServe(cfg_of(k), shape[0], shape[1], traffic=tc,
                             placement="least_loaded", device=device)
               for k in ("hwsw", "fused")}
    t0 = time.perf_counter()
    plan = engines["fused"].plan()
    plan_s = time.perf_counter() - t0
    launched = fresh_launches()
    t0 = time.perf_counter()
    ran = engine_lockstep(engines, plan, device, profile_at=plan.rounds // 2,
                          what="fleet serve (a)")
    session_s = time.perf_counter() - t0
    launches = launched()
    check_launches(device, "fleet serve (a)", launches, plan.rounds)
    rep = engine_reports(engines, plan, ran, "fleet serve (a)")["fused"]
    if plan.dropped:
        raise AssertionError(f"fleet serve (a): {plan.dropped} of "
                             f"{plan.offered} arrivals dropped at rate {rate}")
    R, C, T = shape
    print(f"fleet serve (a) R={R} C={C} T={T}, {plan.rounds} rounds, rate "
          f"{rate}: {plan.offered} offered, 0 dropped, {plan.dispatched} ops "
          f"for {len(plan.tenant_home)} tenants, queue peak "
          f"{rep['queue_depth_max']}; planner {plan_s:.3f} s of host; fused "
          f"== hwsw bit for bit, reports equal, residual 0; heap kernel "
          f"launched {launches} times; e2e p99 {rep['e2e_p99_cyc']:.6g} cyc, "
          f"us_per_op {rep['us_per_op']:.6g} (modeled); session "
          f"{session_s:.1f} s")
    out = dict(rate=rate, plan_s=plan_s, session_s=session_s,
               launches=launches, offered=plan.offered,
               dispatched=plan.dispatched,
               tenants_homed=len(plan.tenant_home),
               queue_depth_max=rep["queue_depth_max"],
               e2e_p99_cyc=rep["e2e_p99_cyc"], us_per_op=rep["us_per_op"],
               kinds={})
    for k, (_, _, times, prof, at) in ran.items():
        timed = [r for r in range(plan.rounds) if r != at]
        out["kinds"][k] = print_times(
            f"fleet serve (a) {k}", times, prof or (None, 0.0, 0, []), smi,
            ops=int((plan.op[timed] != 0).sum()), what="engine round",
            profiled_as="no round" if at is None else f"round {at}")
    return out


def fs_overload(device, fleet=SERVE_FLEET, rate=OVERLOAD_RATE,
                cfg_of=paper_cfg):
    """(b) The same session at `rate` arrivals a round on fused alone: the
    admission queue drops (drop_rate > 0), no expiry free is dropped,
    residual 0, the heap kernel once a round."""
    from repro_torch.launch.serve_fleet import FleetServe, TrafficConfig
    shape, traffic = fleet
    eng = FleetServe(cfg_of("fused"), shape[0], shape[1],
                     traffic=TrafficConfig(arrival_rate=rate, **traffic),
                     placement="least_loaded", device=device)
    t0 = time.perf_counter()
    plan = eng.plan()
    plan_s = time.perf_counter() - t0
    launched = fresh_launches()
    t0 = time.perf_counter()
    state, resps = eng.run(plan)
    sync(device)
    run_s = time.perf_counter() - t0
    launches = launched()
    check_launches(device, "fleet serve (b)", launches, plan.rounds)
    rep = eng.report(plan, resps, state)
    if not (rep["drop_rate"] > 0 and rep["dropped_frees"] == 0
            and rep["conservation_residual"] == 0):
        raise AssertionError(
            f"fleet serve (b): drop_rate {rep['drop_rate']}, dropped_frees "
            f"{rep['dropped_frees']}, residual "
            f"{rep['conservation_residual']}")
    print(f"fleet serve (b) overload, rate {rate}: {rep['offered']} offered, "
          f"{rep['dropped']} dropped (drop_rate {rep['drop_rate']:.4f}), "
          f"{rep['dispatched']} dispatched, 0 dropped frees, residual 0; "
          f"heap kernel launched {launches} times; planner {plan_s:.3f} s of "
          f"host, session {1e3 * run_s / plan.rounds:.3f} ms a round")
    return dict(rate=rate, plan_s=plan_s, run_s=run_s, launches=launches,
                offered=rep["offered"], dropped=rep["dropped"],
                drop_rate=rep["drop_rate"], dispatched=rep["dispatched"])


def chaos_errors(plan, rep):
    """The elastic tier's guarantees on one chaos session, as error
    strings: a migration happened, a killed core dispatches nothing from
    its kill round on, no expiry free is dropped, residual 0."""
    from repro_torch.core.heap import OP_NOOP
    errs = []
    if not rep["migrations"]:
        errs.append("no migration")
    for ev in rep["kills"]:
        (rk, ck), r = ev["core"], ev["round"]
        if (plan.op[r:, rk, ck] != OP_NOOP).any():
            errs.append(f"killed core ({rk}, {ck}) dispatched after round "
                        f"{r}")
    if len(rep["kills"]) != sum(e["kind"] == "kill" for e in rep["faults"]):
        errs.append("a scheduled kill did not happen")
    if rep["dropped_frees"] or rep["conservation_residual"]:
        errs.append(f"dropped_frees {rep['dropped_frees']}, residual "
                    f"{rep['conservation_residual']}")
    return errs


def elastic_engine(cfg, shape, traffic, device, faults=None, migration=None,
                   placement="chunked"):
    from repro_torch.launch import elastic
    return elastic.ElasticFleetServe(
        cfg, shape[0], shape[1], traffic=traffic, placement=placement,
        device=device, faults=faults,
        migration=elastic.MigrationConfig(**migration) if migration else None)


def timed_session(eng, device, snap_round=None, snap_dir=None):
    """Run `eng`'s session to its end, snapshotting into `snap_dir` at
    `snap_round` on the way: ((plan, report), host seconds of the rounds,
    snapshot save seconds)."""
    eng.start()
    save_s = 0.0
    sync(device)
    t0 = time.perf_counter()
    if snap_round is not None:
        eng.run_until(snap_round)
        sync(device)
        ts = time.perf_counter()
        eng.snapshot(snap_dir)
        save_s = time.perf_counter() - ts
    eng.run_until(eng.traffic.rounds)
    sync(device)
    run_s = time.perf_counter() - t0 - save_s
    return eng.finish(), run_s, save_s


def fs_chaos(device, smi, fleet=SERVE_FLEET, rate=SERVE_RATE,
             cfg_of=paper_cfg, snap_round=SNAP_ROUND):
    """(c) Elastic chaos on the fleet: fused and hwsw sessions equal on
    every report field and response bit, the tier's guarantees
    (`chaos_errors`), the heap kernel once a round; the fused session
    snapshotted at `snap_round` (into a temporary directory outside the
    checkout, deleted after), restored into a fresh engine on the card
    and finished: its report == the uninterrupted run's."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import elastic
    from repro_torch.launch.serve_fleet import TrafficConfig
    shape, traffic = fleet
    tc = TrafficConfig(arrival_rate=rate, zipf_a=CHAOS_ZIPF, **traffic)
    faults = elastic.FaultPlan.generate(rounds=tc.rounds, shape=shape,
                                        **CHAOS_FAULTS)
    snap = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        eng = {k: elastic_engine(cfg_of(k), shape, tc, device, faults,
                                 CHAOS_MIGRATION) for k in ("fused", "hwsw")}
        launched = fresh_launches()
        (plan, rep), fused_s, save_s = timed_session(
            eng["fused"], device, snap_round, snap)
        launches = launched()
        check_launches(device, "chaos (c) fused", launches, tc.rounds)
        (plan_h, rep_h), hwsw_s, _ = timed_session(eng["hwsw"], device)
        check_reports({"fused": rep, "hwsw": rep_h}, "chaos (c)")
        a, b = eng["fused"]._stacked(), eng["hwsw"]._stacked()
        bad = [f for f in a._fields if not torch.equal(getattr(a, f),
                                                       getattr(b, f))]
        if bad or not np.array_equal(plan.op, plan_h.op):
            raise AssertionError(f"chaos (c): fused != hwsw on {bad or 'op'}")
        errs = chaos_errors(plan, rep)
        if errs:
            raise AssertionError("chaos (c): " + "; ".join(errs))
        nbytes = sum(f.stat().st_size for f in Path(snap).rglob("*")
                     if f.is_file())
        restored = elastic_engine(cfg_of("fused"), shape, tc, device)
        launched = fresh_launches()
        sync(device)
        t0 = time.perf_counter()
        restored.restore(snap)
        sync(device)
        restore_s = time.perf_counter() - t0
        _, rep_r = restored.finish()
        check_launches(device, "chaos (c) restored", launched(),
                       tc.rounds - snap_round)
        if rep_r != rep:
            bad = [f for f in rep if rep_r.get(f) != rep[f]]
            raise AssertionError(f"chaos (c): the restored session's report "
                                 f"!= the uninterrupted run's on {bad}")
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    R, C, T = shape
    print(f"chaos (c) R={R} C={C} T={T}, zipf {CHAOS_ZIPF}, chunked, rate "
          f"{rate}, faults {faults.to_json()}: {rep['offered']} offered, "
          f"{rep['dropped']} dropped, {rep['dispatched']} dispatched, "
          f"{len(rep['migrations'])} migrations "
          f"({rep['migration_ops_dispatched']} migration ops), kills "
          f"{[ev['core'] for ev in rep['kills']]} dark after their kill, 0 "
          f"dropped frees, residual 0; fused == hwsw bit for bit; heap "
          f"kernel launched {launches} times; fused "
          f"{1e3 * fused_s / tc.rounds:.3f} ms a round, hwsw "
          f"{1e3 * hwsw_s / tc.rounds:.3f} (host clock, "
          f"decision rounds included); snapshot at round {snap_round}: "
          f"{nbytes} B, saved in {save_s:.2f} s, restored on the card in "
          f"{restore_s:.2f} s and finished == the uninterrupted run [{smi}]")
    return dict(rate=rate, launches=launches, offered=rep["offered"],
                dropped=rep["dropped"], dispatched=rep["dispatched"],
                migrations=len(rep["migrations"]),
                migration_ops=rep["migration_ops_dispatched"],
                kills=[ev["core"] for ev in rep["kills"]],
                fused_ms_per_round=1e3 * fused_s / tc.rounds,
                hwsw_ms_per_round=1e3 * hwsw_s / tc.rounds,
                snapshot_bytes=nbytes, save_s=save_s, restore_s=restore_s)


def fs_devices(device, storm=STORM, snap_round=STORM_SNAP, small=FIG_SERVE):
    """(d) Card <-> CPU: fig_elastic's storm (migration on) snapshotted at
    `snap_round` on `device`, restored and finished on the CPU == the run
    finished on `device`; `serve_session` at fig_serve's full size on sw
    and fused: the same report on `device` as on the CPU."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import system as sysm
    from repro_torch.launch.serve_fleet import TrafficConfig, serve_session
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    shape, heap_bytes, kind, traffic = storm
    cfg = sysm.SystemConfig(kind=kind, heap_bytes=heap_bytes,
                            num_threads=shape[2])
    tc = TrafficConfig(**traffic)
    snap = tempfile.mkdtemp(prefix="chip_smoke_storm_")
    try:
        (_, rep), _, _ = timed_session(
            elastic_engine(cfg, shape, tc, device,
                           migration=CHAOS_MIGRATION), device,
            snap_round, snap)
        host = elastic_engine(cfg, shape, tc, cpu).restore(snap)
        _, rep_cpu = host.finish()
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    if rep_cpu != rep or not rep["migrations"]:
        bad = [f for f in rep if rep_cpu.get(f) != rep[f]]
        raise AssertionError(f"storm: finished on the CPU != on the card on "
                             f"{bad} (migrations {len(rep['migrations'])})")
    shape_s, heap_s, traffic_s = small
    reps = {}
    for k in ("sw", "fused"):
        cfg = sysm.SystemConfig(kind=k, heap_bytes=heap_s,
                                num_threads=shape_s[2])
        got = [serve_session(cfg, shape_s[0], shape_s[1],
                             traffic=TrafficConfig(**traffic_s),
                             placement="least_loaded", device=dev)
               for dev in (device, cpu)]
        if got[0] != got[1] or got[0]["conservation_residual"]:
            bad = [f for f in got[1] if got[0].get(f) != got[1][f]]
            raise AssertionError(f"fig_serve {k}: the card's report != the "
                                 f"CPU's on {bad}")
        reps[k] = got[0]
    secs = time.perf_counter() - t0
    print(f"card <-> CPU (d): the storm (R,C,T={shape}, {kind}, "
          f"{tc.rounds} rounds, {len(rep['migrations'])} migrations) "
          f"snapshotted at round {snap_round} on the card, finished on the "
          f"CPU == on the card (e2e p99 {rep['e2e_p99_cyc']:.6g} cyc, "
          f"modeled); fig_serve's full size (R,C,T={shape_s}, "
          f"{traffic_s['rounds']} rounds, rate {traffic_s['arrival_rate']}) "
          f"on sw and fused: card == CPU "
          f"(us_per_op {reps['sw']['us_per_op']:.6g}, modeled) [{secs:.1f} s]")
    return dict(storm_migrations=len(rep["migrations"]),
                storm_p99_cyc=rep["e2e_p99_cyc"],
                serve_us_per_op={k: r["us_per_op"] for k, r in reps.items()},
                s=secs)


def phase_fleet_serve(device, smi, fleet=SERVE_FLEET, cfg_of=paper_cfg,
                      storm=STORM, small=FIG_SERVE):
    """Phase 5e: (a) FleetServe steady, (b) overload, (c) elastic chaos
    with a snapshot and a restore, on the paper's fleet (or `fleet`); (d)
    card <-> CPU at fig_elastic's and fig_serve's sizes. Each path sets
    the heap kernel's launch counter to 0 just before it and reads it
    just after. Returns the result dict."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("steady", lambda: fs_steady(device, smi, fleet,
                                                 cfg_of=cfg_of)),
                    ("overload", lambda: fs_overload(device, fleet,
                                                     cfg_of=cfg_of)),
                    ("chaos", lambda: fs_chaos(device, smi, fleet,
                                               cfg_of=cfg_of)),
                    ("devices", lambda: fs_devices(device, storm,
                                                   small=small))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[f"{key}_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 5e took {out['phase_s']:.1f} s: " + ", ".join(
        f"{k} {out[f'{k}_s']:.1f}" for k in ("steady", "overload", "chaos",
                                              "devices")) + f" [{smi}]")
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


def pa_work(B, H, KVH, D, tokens, table_entries, elt):
    """(bytes, fp32 operations) of one call over `tokens` valid tokens in
    all: the K and V rows of those tokens, q and the output, the page
    table's `table_entries` and the B lengths, each once; q.k and p.v
    products plus the softmax's exp, max and sum per score."""
    nbytes = (2 * tokens * KVH * D * elt + 2 * B * H * D * elt
              + 4 * table_entries + 4 * B)
    ops = 4 * tokens * H * D + 5 * tokens * H
    return nbytes, ops


def pa_bound(q, k_pages, seq_lens, page_table):
    """`pa_work` of one call on these inputs."""
    B, H, D = q.shape
    return pa_work(B, H, k_pages.shape[2], D,
                   int(seq_lens.clamp(min=0).sum()), page_table.numel(),
                   q.element_size())


def layer0_attention_inputs(cfg, res):
    """The paged-attention call of the last decode step's layer 0 of a
    `serve` result, rebuilt from its cache: (q, the K and V pools as the
    kernel takes them, the global page table, seq_lens). Layer 0's input
    is the token's embedding in every served family; the audio family's
    decoder layers are under ``dec``."""
    from repro_torch.kvcache import paged
    from repro_torch.models import layers
    cache, p = res.cache, res.params
    blocks = p["dec"] if cfg.family == "audio" else p["blocks"]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pt, seq_lens = cache["page_table"], cache["seq_lens"]
    B, P = pt.shape
    page = cfg.page_size
    x = p["embed"][res.tokens[:, -2]].to(layers.torch_dtype(cfg.dtype))
    h = layers.rms_norm(x[:, None], blocks["ln1"][0])
    cos, sin = layers.rope_tables((seq_lens - 1)[:, None], hd,
                                  cfg.rope_theta)
    q = layers.apply_rope(layers.qk_proj(h, blocks["wq"][0], H, hd),
                          cos, sin)[:, 0].contiguous()
    kp = cache["k_pages"][0].view(B * P, page, KVH, hd)
    vp = cache["v_pages"][0].view(B * P, page, KVH, hd)
    return q, kp, vp, paged.global_page_table(pt, P), seq_lens


def pa_at_last_step(cfg, res, device):
    """Paged attention at the last decode step's layer-0 inputs of a
    `serve` result (not on the path): the kernel against its plain
    version (bf16 to PA_TOL), its CUDA-event and device time per call,
    the plain version's, `scaled_dot_product_attention(enable_gqa=True)`
    over gathered K/V as a yardstick (with and without the gather), and
    the bound; printed, and returned as a dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    args = layer0_attention_inputs(cfg, res)
    q, kp, vp, ptg, seq_lens = args
    got, want = pa.paged_attention(*args), pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    err = assert_close(got, want, PA_TOL[str(q.dtype).split(".")[1]],
                       f"{cfg.name}: layer-0 attention of the last decode "
                       f"step")
    kern_ms, _, kprof = time_calls(lambda: pa.paged_attention(*args))
    kern_dev_ms, split_ms, merge_ms, k_seen = pa_call_ms(kprof)
    plain_ms, plain_dev_ms, _ = time_calls(
        lambda: pa.paged_attention_plain(*args), n=20)
    B, H, hd = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    P = ptg.shape[1]
    Stot = P * page
    pool_k = res.cache["k_pages"][0]
    pool_v = res.cache["v_pages"][0]
    bidx = torch.arange(B, device=device)[:, None]
    ptl = res.cache["page_table"].long().clamp(0, P - 1)
    mask = (torch.arange(Stot, device=device)[None, :]
            < seq_lens[:, None])[:, None, None, :]

    def gather():
        kg = pool_k[bidx, ptl].reshape(B, Stot, KVH, hd)
        vg = pool_v[bidx, ptl].reshape(B, Stot, KVH, hd)
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
    splits = pa.split_plan(B * KVH, P, pa.sm_count(device))[1]
    print(f"{cfg.name}: paged attention at the last step's layer-0 inputs "
          f"(B={B}, H={H}, KVH={KVH}, D={hd}, {int(seq_lens[0])} tokens, "
          f"page {page}, {P} pages, {splits} split(s)): kernel "
          f"{kern_ms:.5f} ms/call (CUDA events, back to back), {dev}; "
          f"plain version {plain_ms:.4f} ms/call; "
          f"scaled_dot_product_attention {lib_ms:.5f} ms/call over gathered "
          f"K/V (device {lib_dev_ms}), {libg_ms:.5f} ms with the gather "
          f"(device {libg_dev_ms}); bound {max(bytes_ms, ops_ms):.6f} ms "
          f"({nbytes} B, {nops} fp32 ops); kernel == plain max |diff| "
          f"{err}, yardstick vs plain max |diff| {lib_err}")
    return dict(err=err, ms=kern_ms, device_ms=kern_dev_ms,
                split_ms=split_ms, merge_ms=merge_ms, seen=k_seen,
                plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                sdpa_ms=lib_ms, sdpa_device_ms=lib_dev_ms,
                sdpa_gather_ms=libg_ms, sdpa_gather_device_ms=libg_dev_ms,
                sdpa_err=lib_err, bytes=nbytes, ops=nops, bytes_ms=bytes_ms,
                ops_ms=ops_ms, shape=[B, H, KVH, hd, page, P],
                tokens=int(seq_lens.sum()))


def profile_decode(cfg, mod, params, cache, toks, n=SERVE_PROFILE):
    """`n` more greedy decode steps of family module `mod` (after one
    warm-up step) under the profiler: device busy ms and wall ms per step,
    device launches per step, the paged-attention kernels' device ms per
    step and per call in situ, and the top kernels; printed, and returned
    as a dict (busy None where the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dcfg = dataclasses.replace(cfg, attend_impl="kernel")
    cache, logits = mod.decode(dcfg, params, cache, {"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            toks = torch.argmax(logits, dim=-1)[:, None]
            cache, logits = mod.decode(dcfg, params, cache, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, launches, top = 0.0, 0, []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0 and e.device_type.name == "CUDA":
            busy += us
            launches += e.count
            top.append((us / n / 1e3, e.count, e.key[:60]))
    top.sort(reverse=True)
    call_ms, split_ms, merge_ms, seen = pa_call_ms(prof)
    pa_ms = sum(kernel_events(prof, k)[0] for k in
                (PA_KERNEL, PA_MERGE)) / 1e3 / n
    wall_ms = 1e3 * wall / n
    busy_ms = busy / n / 1e3 if busy else None
    if busy_ms is None:
        print("profiler: no device time recorded; busy share not measured")
    else:
        print(f"{cfg.name}: profiler over {n} decode steps: device busy "
              f"{busy_ms:.3f} of {wall_ms:.3f} ms/step "
              f"({100 * busy_ms / wall_ms:.1f} %), "
              f"{launches / n:.0f} device launches/step, "
              f"paged attention {pa_ms:.4f} ms/step, "
              f"{call_ms} ms device time/call in situ "
              f"(split {split_ms} + merge {merge_ms}; "
              f"{seen} of {cfg.n_layers * n} calls "
              f"recorded); top: " + "; ".join(
                  f"{k} {ms:.3f} ms/step x{c}" for ms, c, k in top[:6]))
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=launches / n,
                pa_ms=pa_ms, pa_call_ms=call_ms, pa_split_ms=split_ms,
                pa_merge_ms=merge_ms, pa_events=seen,
                top=[list(t) for t in top[:8]])


def phase_serve(seed, device):
    """Phase 7; returns (result dict, the paged-attention kernels entry)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import heap_step
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry, transformer

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
    r = pa_at_last_step(cfg, res, device)
    serve_err, kern_ms, kern_dev_ms = r["err"], r["ms"], r["device_ms"]
    split_ms, merge_ms, k_seen = r["split_ms"], r["merge_ms"], r["seen"]
    plain_ms, plain_dev_ms = r["plain_ms"], r["plain_device_ms"]
    lib_ms, lib_dev_ms = r["sdpa_ms"], r["sdpa_device_ms"]
    libg_ms, libg_dev_ms = r["sdpa_gather_ms"], r["sdpa_gather_device_ms"]
    nbytes, nops = r["bytes"], r["ops"]
    bytes_ms, ops_ms = r["bytes_ms"], r["ops_ms"]

    # ---- device busy share over a few more decode steps --------------------
    d = profile_decode(cfg, transformer, p, cache, res.tokens[:, -1:])
    busy_ms, wall_ms, launches = d["busy_ms"], d["wall_ms"], d["launches"]
    step_pa_total_ms, step_pa_ms = d["pa_ms"], d["pa_call_ms"]
    step_split_ms, step_merge_ms = d["pa_split_ms"], d["pa_merge_ms"]
    step_pa_n, top = d["pa_events"], d["top"]
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
        step_launches=launches,
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


# ---------------------------------------------------------------------------
# phase 11: the training path (no kernel of its own)
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 8      # of granite-3-8b's 40: the depth the card holds
TRAIN_SEQ = 4096      # train_4k's sequence length
TRAIN_BATCH = 4       # global batch (train_4k: 256)
TRAIN_MICRO = 2       # microbatches a step
TRAIN_STEPS = 2       # timed steps, after one warm-up step (4 before
#                       phase 17: its ~100 s came from here)
TRAIN_REPEAT = 4      # steps on one repeated batch: the loss must fall
CHECK_SEQ = 256       # (a): one full-width fp32 layer, B=1
TRAIN_LOSS_TOL = 1e-5   # (a): |loss card - loss CPU| / |loss CPU|
TRAIN_GRAD_TOL = 1e-3   # (a): per leaf max |g card - g CPU| / max |g CPU|
MFU_PEAK = 989.4e12     # dense bf16 tensor-core peak, H100 SXM at 700 W
DRILL = ["--arch", SERVE_ARCH, "--reduced", "--steps", "12", "--ckpt-every",
         "3", "--dtype", "bfloat16"]
DRILL_FAIL = 7


def kernel_counters():
    """{name: the launch counter's function} of the five kernels."""
    from repro_torch.kernels import buddy_traverse, flash_attention, \
        freelist, heap_step, paged_attention
    return {"heap_step": heap_step.fused_heap_step,
            "buddy_alloc_batch": buddy_traverse.buddy_alloc_batch_kernel,
            "freelist_op": freelist.freelist_op_kernel,
            "paged_attention": paged_attention.paged_attention,
            "flash_attention": flash_attention.flash_attention_kernel}


def tree_bytes(tree):
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def grad_reading(got, want):
    """((loss, grads) against (loss, grads) of the same inputs): (the
    loss's relative difference, (leaf, share) of the largest per-leaf max
    |diff| / max |g|, {leaf: share} of the leaves past TRAIN_GRAD_TOL)."""
    (lg, gg), (lw, gw) = got, want
    loss_rel = abs(float(lg) - float(lw)) / abs(float(lw))
    gg, gw = named_leaves(gg), named_leaves(gw)
    shares = {}
    for name, b in gw.items():
        d = float((gg[name].detach().cpu().float() - b.float()).abs().max())
        shares[name] = d / max(float(b.float().abs().max()), 1e-30)
    bad = {k: v for k, v in shares.items() if not v <= TRAIN_GRAD_TOL}
    worst = max(shares, key=shares.get)
    return loss_rel, (worst, shares[worst]), bad


def named_leaves(tree, pre=""):
    """{path: leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(named_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def train_card_vs_cpu(seed, device):
    """Phase 11 (a): one full-width layer in fp32 at B=1, S=CHECK_SEQ:
    loss and every gradient on the card against the CPU; then the same
    check must fail a broken rms_norm (its ``1 +`` dropped) on the
    card."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import layers, registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import tree_map
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), n_layers=1,
                              dtype="float32")
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    params = registry.init(cfg, seed=seed, device=cpu)
    batch = registry.make_train_batch(
        cfg, ShapeConfig("check", CHECK_SEQ, 1, "train"), seed=seed,
        device=cpu)
    grad_fn = steps.make_grad_fn(cfg)
    (l_cpu, _), g_cpu = grad_fn(params, batch)
    cpu_s = time.perf_counter() - t0
    dparams = tree_map(lambda p: p.to(device), params)
    dbatch = {k: v.to(device) for k, v in batch.items()}
    (l_dev, _), g_dev = grad_fn(dparams, dbatch)
    loss_rel, worst, bad = grad_reading((l_dev, g_dev), (l_cpu, g_cpu))
    if not loss_rel <= TRAIN_LOSS_TOL or bad:
        raise AssertionError(f"train (a): card != CPU: loss rel "
                             f"{loss_rel}, leaves past {TRAIN_GRAD_TOL}: "
                             f"{bad}")
    del g_dev

    real = layers.rms_norm

    def broken(x, scale, eps=1e-6):   # the mutant: `1 +` dropped
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * scale.float()).to(x.dtype)

    layers.rms_norm = broken
    try:
        (l_mut, _), g_mut = grad_fn(dparams, dbatch)
    finally:
        layers.rms_norm = real
    mut_rel, mut_worst, mut_bad = grad_reading((l_mut, g_mut),
                                               (l_cpu, g_cpu))
    if mut_rel <= TRAIN_LOSS_TOL and not mut_bad:
        raise AssertionError("train (a): the check passes a broken "
                             "rms_norm")
    print(f"train (a) {cfg.name}: 1 full-width layer in fp32, B=1, S="
          f"{CHECK_SEQ}: card == CPU: loss {float(l_dev)} vs "
          f"{float(l_cpu)} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_TOL}), "
          f"gradients max |diff| / max |g| at most {worst[1]:.3g} ("
          f"{worst[0]}) over {len(named_leaves(g_cpu))} leaves (tol "
          f"{TRAIN_GRAD_TOL}); the CPU side {cpu_s:.1f} s; the check fails "
          f"rms_norm without `1 +`: loss rel {mut_rel:.3g}, "
          f"{len(mut_bad)} leaves past the tolerance (worst "
          f"{mut_worst[1]:.3g}, {mut_worst[0]})")
    return dict(loss_card=float(l_dev), loss_cpu=float(l_cpu),
                loss_rel=loss_rel, grad_worst=worst[1],
                grad_worst_leaf=worst[0], cpu_s=cpu_s,
                mutant_loss_rel=mut_rel, mutant_leaves_failed=len(mut_bad),
                mutant_worst=mut_worst[1])


def train_flops(cfg, tokens, B, S):
    """(FLOPs of one step, matmul parameters a token runs through): 6 per
    matmul parameter and token it multiplies (forward and backward) + 2
    (remat's recomputed forward), plus (3 + 1) times the forward's
    sequence products.

    The matmul parameters are every stacked weight matrix of every block
    tree (``blocks``, the hybrid's ``rec1`` / ``rec2`` / ``attn`` /
    ``tail``, the audio's ``enc`` / ``dec``), but the norms and the causal
    convs' taps; and the head, which is the embedding where it is tied;
    not the embedding's lookup. Each counts at the positions it runs over:

      * dense, ssm, hybrid: the B S tokens;
      * moe: the routed experts' three products at top_k / padded experts
        of their stacked weights (a token runs top_k real experts; the
        dummies and the capacity's padded slots are not counted), the
        router and the shared experts whole;
      * vlm: the blocks over the B (S + P) positions of the patch prefix
        and the text, the head over the B S text tokens;
      * audio: the encoder over B F frames, the decoder's cross-attention
        K / V over the same B F encoder positions, the rest of the decoder
        and the head over B S.

    The sequence products: the attention's two, 4 B S T H hd on each
    attention layer (T = S, full S^2 causal or not; the hybrid's local
    attention T = min(S, window); the vlm S = T = S + P; the audio's
    encoder S = T = F, its decoder's self-attention S = T = S and its
    cross-attention T = F); the SSD's four on each ssm layer, 2 B S' (l n
    + l H P + 2 H P n) over S' = S padded to chunks of l."""
    from repro_torch.models import registry
    spec = registry.param_specs(cfg)
    head = spec.get("head", spec["embed"])
    mats = {k: t for k, t in named_leaves(
        {k: v for k, v in spec.items() if isinstance(v, dict)}).items()
        if t.dim() >= 3 and not k.split("/")[-1].startswith("conv")}
    P = cfg.n_patches if cfg.family == "vlm" else 0
    F = cfg.enc_frames if cfg.family == "audio" else 0

    def active(name, t):     # the parameters a position runs through
        if cfg.family == "moe" and name.split("/")[-1] in ("we1", "we2",
                                                           "we3"):
            return t.numel() * cfg.top_k // cfg.padded_experts
        return t.numel()

    def positions(name):
        if name.startswith("enc/") or name in ("dec/xwk", "dec/xwv"):
            return B * F
        return B * (S + P)

    n_mm = head.numel() + sum(active(k, t) for k, t in mats.items())
    mm = head.numel() * tokens + sum(active(k, t) * positions(k)
                                     for k, t in mats.items())
    H, hd = cfg.n_heads, cfg.head_dim
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        H, P_, N, l = (d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                       cfg.ssm_state, cfg.ssm_chunk)
        seq = cfg.n_layers * 2 * B * (-(-S // l) * l) * (
            l * N + l * H * P_ + 2 * H * P_ * N)
    elif cfg.family == "hybrid":
        seq = cfg.n_layers // 3 * 4 * B * S * min(S, cfg.window) * H * hd
    elif cfg.family == "audio":
        seq = 4 * B * H * hd * (cfg.enc_layers * F * F
                                + cfg.n_layers * (S * S + S * F))
    else:
        seq = cfg.n_layers * 4 * B * (S + P) ** 2 * H * hd
    return (6 + 2) * mm + (3 + 1) * seq, n_mm


# kernel classes of a training step, by name (cuBLAS runs the bf16 GEMMs
# as "nvjet" kernels on Hopper)
TRAIN_CLASSES = (("fp32 GEMM", ("f32f32", "sgemm")),
                 ("bf16 GEMM", ("nvjet", "bf16")),
                 ("softmax", ("softmax",)), ("reduce", ("reduce",)),
                 ("elementwise", ("elementwise",)))


def kernel_classes(kernels):
    """{class: (ms, launches)} of `profile_call`'s kernels by
    TRAIN_CLASSES: a kernel goes to the first class whose name holds any
    of its keys, the rest to "other"."""
    classes = {name: [0.0, 0] for name, _ in TRAIN_CLASSES + (("other", ()),)}
    for ms, n, key in kernels:
        key = key.lower()
        name = next((c for c, keys in TRAIN_CLASSES
                     if any(k in key for k in keys)), "other")
        classes[name][0] += ms
        classes[name][1] += n
    return {k: tuple(v) for k, v in classes.items()}


def train_setup(cfg, seed, device, total_steps, n_micro=TRAIN_MICRO):
    """(params, opt_state, run(params, opt, i)) for `cfg` on the card:
    the trainer's AdamW settings (lr 1e-3, warmup 10) and its TokenStream
    at TRAIN_BATCH x TRAIN_SEQ (with the stub frontends' embeddings, as
    `launch.train.build` streams them), `n_micro` microbatches a step."""
    from repro_torch.data.pipeline import StreamConfig, TokenStream, \
        to_device
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                total_steps=total_steps,
                                moment_dtype=cfg.opt_moment_dtype)
    params = registry.init(cfg, seed=seed, device=device)
    opt = adamw.init(opt_cfg, params)
    step = steps.make_train_step(cfg, opt_cfg, n_micro=n_micro)
    stream = TokenStream(StreamConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed, d_model=cfg.d_model,
        enc_frames=cfg.enc_frames if cfg.family == "audio" else 0,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0))

    def run(params, opt, i):
        return step(params, opt, to_device(stream.batch(i), device))

    return params, opt, run


def train_full(seed, device, smi):
    """Phase 11 (b): granite-3-8b at full width, TRAIN_LAYERS layers,
    bf16, through `make_train_step` on the trainer's TokenStream: a
    warm-up step that changes the parameters, TRAIN_STEPS timed steps and
    one profiled step; then, with flat attention weights, one batch
    repeated TRAIN_REPEAT times from the init: its loss falls at every
    step."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(configs.get(SERVE_ARCH),
                              n_layers=TRAIN_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    pspec = registry.param_specs(cfg)
    n_params = sum(t.numel() for t in tree_leaves(pspec))
    p_b = tree_bytes(pspec)
    ospec = steps.opt_state_specs(cfg, adamw.AdamWConfig(
        moment_dtype=cfg.opt_moment_dtype))
    mom_b = tree_bytes(ospec.m) + tree_bytes(ospec.v)
    acc_b = 4 * n_params if TRAIN_MICRO > 1 else 0
    plan_b = 2 * p_b + acc_b + mom_b     # params, grads, accumulator, m, v
    scores_b = 4 * (B // TRAIN_MICRO) * cfg.n_heads * S * S
    print(f"train (b) plan from param_specs / opt_state_specs: "
          f"{cfg.name}, {cfg.n_layers} of 40 layers at full width, "
          f"{n_params / 1e9:.4f} B params ({cfg.dtype}); params "
          f"{p_b / 1e9:.2f} GB + grads {p_b / 1e9:.2f} + fp32 accumulator "
          f"{acc_b / 1e9:.2f} + m, v {mom_b / 1e9:.2f} = {plan_b / 1e9:.2f} "
          f"GB; one layer's fp32 scores of a microbatch {scores_b / 1e9:.2f}"
          f" GB; B={B}, S={S}, n_micro={TRAIN_MICRO}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, opt, run = train_setup(cfg, seed, device, TRAIN_STEPS + 2)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the warm-up step: its update changes every leaf
    old = params
    t0 = time.perf_counter()
    params, opt, m = run(params, opt, 0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    new = named_leaves(params)
    changed = {k: int((a != new[k]).sum())
               for k, a in named_leaves(old).items()}
    del old, new
    if not all(changed.values()):
        raise AssertionError(f"train (b): the first update left leaves "
                             f"unchanged: {changed}")
    losses, gnorms = [float(m["loss"])], [float(m["grad_norm"])]

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    times = []
    for i in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = run(params, opt, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launched = {k: f.launches for k, f in counters.items()}
    if any(launched.values()):
        raise AssertionError(f"train (b): the training path launched a "
                             f"kernel: {launched}")
    (params, opt, m), busy, wall, launches, kernels = profile_call(
        lambda: run(params, opt, TRAIN_STEPS + 1), top=None)
    classes = kernel_classes(kernels)
    losses.append(float(m["loss"]))
    gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    del params, opt, m

    # one batch repeated from the init, with flat attention weights: under
    # attn_4d the reference's init takes the head count as the 3-D weights'
    # fan-in, so q and k are ~10x too large, the softmax saturates, and the
    # loss on a repeated batch does not fall at every step at any lr (on
    # the CPU at reduced width, 8 layers, fp32 and bf16, lr 3e-5 to 1e-3);
    # with flat weights it falls at each of them
    flat = dataclasses.replace(cfg, attn_4d=False)
    params, opt, run = train_setup(flat, seed, device, TRAIN_REPEAT)
    rep = []
    for _ in range(TRAIN_REPEAT):
        params, opt, m = run(params, opt, 0)
        rep.append(float(m["loss"]))
    del params, opt, m
    if not all(math.isfinite(x) for x in losses + gnorms + rep):
        raise AssertionError(f"train (b): non-finite loss or gradient "
                             f"norm: {losses}, {gnorms}, {rep}")
    if not all(a > b for a, b in zip(rep, rep[1:])):
        raise AssertionError(f"train (b): the loss on a repeated batch "
                             f"did not fall at every step: {rep}")
    step_s = sum(times) / len(times)
    tokens = B * S
    flops, n_mm = train_flops(cfg, tokens, B, S)
    mfu = flops / step_s / MFU_PEAK
    busy_s = "not measured" if busy is None else \
        f"{busy:.1f} of {wall:.1f} ms ({100 * busy / wall:.1f} %)"
    print(f"train (b) {cfg.name} x{cfg.n_layers} layers, bf16, remat, "
          f"attn_4d, gqa_expand, fp32 moments: init {init_s:.2f} s, "
          f"warm-up step {warm_s:.2f} s; step {1e3 * step_s:.1f} ms (host "
          f"clock ending in a synchronise, mean of {len(times)}: "
          + ", ".join(f"{1e3 * t:.1f}" for t in times) + f"), "
          f"{tokens / step_s:.0f} tokens/s; one profiled step: {launches} "
          f"device launches, busy {busy_s}; by kernel class: " + "; ".join(
              f"{name} {t:.1f} ms x{c}" for name, (t, c) in classes.items())
          + f"; losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in gnorms]}; batch 0 repeated from the "
          f"init (flat attention weights) {[round(x, 4) for x in rep]}; "
          f"the five kernels launched {sum(launched.values())} times; peak "
          f"device memory {peak / 1e9:.2f} GB against the plan's "
          f"{plan_b / 1e9:.2f} GB of state; MFU {100 * mfu:.2f} % of "
          f"{MFU_PEAK / 1e12} TFLOP/s ({flops / 1e12:.2f} TFLOP a step = 8 "
          f"x {n_mm / 1e9:.4f} B matmul params x {tokens} tokens + "
          f"attention (3 + 1) x 4 B S^2 H hd L) [{smi}]")
    return dict(arch=cfg.name, layers=cfg.n_layers, n_params=n_params,
                batch=B, seq=S, n_micro=TRAIN_MICRO, plan_bytes=plan_b,
                params_bytes=p_b, acc_bytes=acc_b, moment_bytes=mom_b,
                scores_bytes=scores_b, peak_bytes=peak, init_s=init_s,
                warmup_s=warm_s, step_s=times, step_mean_s=step_s,
                tokens_per_s=tokens / step_s, profile_busy_ms=busy,
                profile_wall_ms=wall, launches_per_step=launches,
                profile_classes=classes, losses=losses,
                grad_norms=gnorms, repeated_losses=rep, flops=flops,
                matmul_params=n_mm, mfu=mfu, kernel_launches=launched,
                leaves_changed=changed)


def train_drill(device):
    """Phase 11 (c): `launch.train.main` with DRILL's flags (the reduced
    config in bf16, on the card by default), once with ``--fail-at`` and
    once without: exactly one recovery, steps 0-11 done, the same final
    state bit for bit; a checkpoint written on the card restores on the
    CPU == the uninterrupted run's on the card."""
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (p1, o1), h1 = train.main(DRILL + ["--fail-at", str(DRILL_FAIL),
                                           "--ckpt-dir", f"{tmp}/drill"])
        (p2, o2), h2 = train.main(DRILL + ["--ckpt-dir", f"{tmp}/clean"])
        drill_s = time.perf_counter() - t0
        if h1["recoveries"] != 1 or h1["steps"] != list(range(12)) or \
                h2["recoveries"] != 0 or h2["steps"] != list(range(12)):
            raise AssertionError(f"train (c): histories {h1} / {h2}")
        a, b = ckpt._flatten((p1, o1)), ckpt._flatten((p2, o2))
        if p1["embed"].device.type != "cuda" or \
                p1["embed"].dtype != torch.bfloat16:
            raise AssertionError("train (c): the trainer did not train "
                                 "bf16 weights on the card")
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"train (c): the drill's final state != "
                                 f"the uninterrupted run's in {differ}")
        step = ckpt.latest_step(f"{tmp}/drill")
        cpu = ckpt.restore((p1, o1), step, f"{tmp}/drill",
                           device=torch.device("cpu"))
        card = ckpt.restore((p2, o2), step, f"{tmp}/clean")
        ca, cb = ckpt._flatten(cpu), ckpt._flatten(card)
        moved = [k for k in ca if ca[k].device.type != "cpu"
                 or ca[k].dtype != cb[k].dtype
                 or not torch.equal(ca[k], cb[k].cpu())]
        if moved:
            raise AssertionError(f"train (c): step {step} restored on the "
                                 f"CPU != on the card in {moved}")
    print(f"train (c) the recovery drill ({' '.join(DRILL)} --fail-at "
          f"{DRILL_FAIL}, on the card): {h1['recoveries']} recovery, steps "
          f"0-11 done; final params and optimizer state == the "
          f"uninterrupted run's bit for bit ({len(a)} leaves); its step-"
          f"{step} checkpoint restored on the CPU == the uninterrupted "
          f"run's on the card; {drill_s:.1f} s for both runs")
    return dict(recoveries=h1["recoveries"], steps=len(h1["steps"]),
                leaves=len(a), restored_step=step, seconds=drill_s)


def phase_train(seed, device, smi):
    """Phase 11; returns its result dict."""
    t0 = time.perf_counter()
    out = dict(card_vs_cpu=train_card_vs_cpu(seed, device),
               full=train_full(seed, device, smi),
               drill=train_drill(device))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the moe, vlm and audio families served
FAMILY_ARCHS = ("olmoe_1b_7b", "qwen2_moe_a2_7b", "paligemma_3b",
                "whisper_small")
FAM_CHECK_LAYERS = 2    # (a): full width, 2 layers (the encoder's too), fp32
FAM_CHECK_BATCH = 2
FAM_CHECK_PROMPT = 128  # text tokens (paligemma: after its 256 patches)
FAM_CHECK_STEPS = 4
FAM_LOGIT_TOL = 1e-3    # (a): max |card - CPU| / max |CPU| of a step's logits
FAM_TIE_GAP = 1e-4      # (a): a layer-0 expert the card and the CPU pick
                        # differently must be within this probability
FAM_BATCH = 8           # (b): requests
FAM_PROMPT = {"olmoe_1b_7b": 512, "qwen2_moe_a2_7b": 512,
              "paligemma_3b": 256,   # after its 256 patches
              "whisper_small": 256}  # decoder tokens (448 positions)
FAM_STEPS = 64
# the kernels line's entries at the new head shapes: (name, the archs whose
# serving runs launch the kernel at that shape; the first one's inputs are
# timed)
FAM_PA_ENTRIES = (("paged_attention_moe", ("olmoe_1b_7b", "qwen2_moe_a2_7b")),
                  ("paged_attention_paligemma", ("paligemma_3b",)),
                  ("paged_attention_whisper", ("whisper_small",)))


def tree_to(tree, device):
    """A copy of nested dicts of tensors on `device`."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def family_launches(cfg, steps):
    """Paged-attention launches of `steps` decode steps: one per decoder
    layer and step (prefill attends without the kernel)."""
    return cfg.n_layers * steps


def pa_entry(name, launches, err, reading):
    """The kernels-line entry of paged attention at one shape, from
    `pa_at_last_step`'s reading."""
    bytes_ms, ops_ms = reading["bytes_ms"], reading["ops_ms"]
    return {"name": name, "route": "cuda", "source": PA_SOURCE,
            "replaces": PA_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": reading["ms"],
            "plain_ms": reading["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": reading["sdpa_ms"]}


def expert_flips(idx_a, idx_b, probs):
    """The (token, k) at which two runs' top-k expert ids differ, each
    with the probability gap between the two experts under `probs` (one
    run's router probabilities, [tokens, E]): [(token, k, gap)]."""
    diff = (idx_a != idx_b).nonzero().tolist()
    return [(t, k, abs(float(probs[t, idx_a[t, k]])
                       - float(probs[t, idx_b[t, k]]))) for t, k in diff]


def family_run(cfg, params, tokens, front, steps, device, feed=None):
    """Prefill then `steps` decode steps through the family's module with
    ``attend_impl="kernel"`` on `device`, each step fed the column of
    `feed` ([B, steps] on the CPU), or greedy where `feed` is None: (every
    step's logits on the CPU, [(probs, ids)] of each forward's layer-0
    routing for a MoE, the tokens fed [B, steps])."""
    import torch
    from repro_torch.models import moe, registry
    mod = registry.get_module(cfg)
    dcfg = dataclasses.replace(cfg, attend_impl="kernel")
    B, S = tokens.shape
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache = mod.init_cache(cfg, B, prefix + S + steps + cfg.page_size,
                           device=device)
    routes, top_k = [], moe.top_k

    def record(x, k):
        vals, idx = top_k(x, k)
        routes.append((x.reshape(-1, x.shape[-1]).cpu(),
                       idx.reshape(-1, k).cpu()))
        return vals, idx

    moe.top_k = record
    try:
        batch = {"tokens": tokens.to(device),
                 **{k: v.to(device) for k, v in front.items()}}
        cache, logits = mod.prefill(dcfg, params, batch, cache)
        out, fed = [logits.cpu()], []
        for i in range(steps):
            fed.append(torch.argmax(out[-1], -1) if feed is None
                       else feed[:, i])
            cache, logits = mod.decode(dcfg, params, cache, {
                "tokens": fed[-1][:, None].to(device)})
            out.append(logits.cpu())
    finally:
        moe.top_k = top_k
    return out, routes[::cfg.n_layers], torch.stack(fed, 1)


def family_card_vs_cpu(name, seed, device):
    """Phase 12 (a): `name` at full width, FAM_CHECK_LAYERS layers, fp32,
    B=FAM_CHECK_BATCH, prefill + FAM_CHECK_STEPS decode steps on the card
    (the paged-attention kernel) and on the CPU (its plain version) from
    the same parameters and inputs, the CPU fed the card's greedy tokens:
    every step's logits within FAM_LOGIT_TOL of max |logit|; for a MoE,
    layer 0's expert ids of every forward, where any (token, k) that
    differs must be a near-tie (gap <= FAM_TIE_GAP)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import registry
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(name), n_layers=FAM_CHECK_LAYERS,
                              dtype="float32")
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, enc_layers=FAM_CHECK_LAYERS)
    B, S = FAM_CHECK_BATCH, FAM_CHECK_PROMPT
    S += (-(S + (cfg.n_patches if cfg.family == "vlm" else 0))
          % cfg.page_size)  # whole pages (so already at full width)
    params = registry.init(cfg, seed=seed, device=device)
    cpu_params = tree_to(params, "cpu")
    tokens = registry.make_prompts(cfg, B, S, seed=seed, device="cpu")
    front = registry.make_frontends(cfg, B, seed=seed, device="cpu")
    card, card_routes, feed = family_run(cfg, params, tokens, front,
                                         FAM_CHECK_STEPS, device)
    del params
    torch.cuda.empty_cache()
    # the CPU is fed the card's greedy tokens
    cpu, cpu_routes, _ = family_run(cfg, cpu_params, tokens, front,
                                    FAM_CHECK_STEPS, torch.device("cpu"),
                                    feed=feed)
    worst = 0.0
    for i, (g, w) in enumerate(zip(card, cpu)):
        # the vocabulary's padding columns hold -1e30 on both sides
        g, w = g[:, :cfg.vocab], w[:, :cfg.vocab]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} (a): non-finite logits at step {i}")
        share = float((g - w).abs().max()) / float(w.abs().max())
        if not share <= FAM_LOGIT_TOL:
            raise AssertionError(f"{name} (a) step {i}: card logits differ "
                                 f"from the CPU's by {share:.3g} of max "
                                 f"|logit| (limit {FAM_LOGIT_TOL})")
        worst = max(worst, share)
    flips, routed = [], 0
    for (_, ia), (pb, ib) in zip(card_routes, cpu_routes):
        routed += ia.numel()
        flips += expert_flips(ia, ib, pb)
    if cfg.family == "moe" and len(card_routes) != FAM_CHECK_STEPS + 1:
        raise AssertionError(f"{name} (a): {len(card_routes)} routed "
                             f"forwards recorded")
    for t, k, gap in flips:
        print(f"{name} (a): layer-0 expert differs at token {t}, k={k}: "
              f"probability gap {gap:.3g}")
    if any(gap > FAM_TIE_GAP for _, _, gap in flips):
        raise AssertionError(f"{name} (a): an expert choice differs by more "
                             f"than a near-tie ({FAM_TIE_GAP})")
    out = dict(logit_share=worst, routed=routed, flips=len(flips),
               gaps=[g for _, _, g in flips],
               seconds=time.perf_counter() - t0)
    print(f"{name} (a): {FAM_CHECK_LAYERS} layers at full width in fp32, "
          f"B={B} x {S} text tokens"
          + (f" after {cfg.n_patches} patches" if cfg.family == "vlm" else "")
          + f", {FAM_CHECK_STEPS} decode steps: card == CPU, max |diff| "
          f"{worst:.3g} of max |logit| (limit {FAM_LOGIT_TOL})"
          + (f"; layer-0 expert ids of {routed} (token, k): {len(flips)} "
             f"differ" if cfg.family == "moe" else "")
          + f" [{out['seconds']:.1f} s]")
    return out


def family_serve(name, seed, device):
    """Phase 12 (b) and (c): `name` at full width and depth in bf16,
    FAM_BATCH requests of FAM_PROMPT[name] text tokens and FAM_STEPS
    greedy decode steps through `launch.serve.serve` with the counters
    reset just before and read just after; then paged attention at the
    last step's layer-0 inputs against its plain version, and the device
    busy share of a few more decode steps. Returns (result, reading)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import heap_step
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    cfg = configs.get(name)
    B, S, steps = FAM_BATCH, FAM_PROMPT[name], FAM_STEPS
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = registry.init(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in named_leaves(params).values())
    pa.paged_attention.launches = 0
    heap_step.fused_heap_step.launches = 0
    res = srv.serve(cfg, batch=B, prompt_len=S, decode_steps=steps,
                    impl="kernel", seed=seed, device=device, params=params)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    heap_launches = heap_step.fused_heap_step.launches
    want = family_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{name}: serve launched the paged-attention "
                             f"kernel {launches} times, want {want}")
    if heap_launches != 0 or res.pool_kind != "sw":
        raise AssertionError(f"{name}: the {res.pool_kind} pool launched "
                             f"the heap kernel {heap_launches} times")
    st = res.stats
    if st["fails"] != 0 or st["front_hits"] <= 0:
        raise AssertionError(f"{name}: pool stats {st}")
    if not res.logits_finite:
        raise AssertionError(f"{name}: non-finite logits in some step")
    if res.tokens.shape != (B, steps + 1) or \
            int(res.tokens.max()) >= cfg.vocab or int(res.tokens.min()) < 0:
        raise AssertionError(f"{name}: tokens {tuple(res.tokens.shape)} "
                             f"outside [0, {cfg.vocab})")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    pf_s, dec_s = res.timings["prefill_s"], res.timings["decode_s"]
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    print(f"{name} (b): {cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers over {cfg.enc_frames} "
             f"frames" if cfg.family == "audio" else "")
          + f", d_model {cfg.d_model}, H={cfg.n_heads}, KVH="
          f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype} (init {init_s:.2f} "
          f"s); {B} x ({prefix} + {res.prompt.shape[1]}) prefill positions, "
          f"{steps} decode steps, page {cfg.page_size}; paged-attention "
          f"launches {launches} (= {cfg.n_layers} x {steps}); heap-step "
          f"launches 0 in {res.pool_rounds} pool rounds; {res.page_allocs} "
          f"decode-time page allocations; pool {st}; all logits finite; "
          f"peak device memory {peak_gib:.2f} GiB")
    print(f"{name} (b) timings: prefill {pf_s:.4f} s; decode "
          f"{1e3 * dec_s / steps:.3f} ms/step, {B * steps / dec_s:.2f} "
          f"tokens/s; waiting on the per-step length read-back "
          f"{1e3 * res.timings['sync_s'] / steps:.3f} ms/step")
    reading = pa_at_last_step(cfg, res, device)
    prof = profile_decode(cfg, registry.get_module(cfg), res.params,
                          res.cache, res.tokens[:, -1:])
    result = dict(arch=cfg.name, n_params=n_params, init_s=init_s, batch=B,
                  prompt=res.prompt.shape[1], prefix=prefix,
                  decode_steps=steps, pa_launches=launches,
                  pool_rounds=res.pool_rounds, page_allocs=res.page_allocs,
                  pool_stats=st, peak_gib=peak_gib, prefill_s=pf_s,
                  decode_ms_per_step=1e3 * dec_s / steps,
                  tokens_per_s=B * steps / dec_s,
                  sync_ms_per_step=1e3 * res.timings["sync_s"] / steps,
                  pa=reading, profile=prof)
    del params, res
    torch.cuda.empty_cache()
    return result, reading


def phase_families(seed, device):
    """Phase 12; returns (result dict, the kernels-line entries of the
    new head shapes)."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": {}, "serve": {}}
    readings = {}
    for name in FAMILY_ARCHS:
        out["card_vs_cpu"][name] = family_card_vs_cpu(name, seed, device)
    for name in FAMILY_ARCHS:
        out["serve"][name], readings[name] = family_serve(name, seed, device)
    entries = []
    for entry, archs in FAM_PA_ENTRIES:
        entries.append(pa_entry(
            entry, sum(out["serve"][a]["pa_launches"] for a in archs),
            max(readings[a]["err"] for a in archs), readings[archs[0]]))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12 took {out['seconds']:.1f} s")
    return out, entries


# ---------------------------------------------------------------------------
# phase 13: the recurrent families (no kernel of their own)
REC_ARCHS = ("mamba2_130m", "recurrentgemma_9b")
REC_CHECK_LAYERS = {"mamba2_130m": 24,       # (a): full width, fp32; all
                    "recurrentgemma_9b": 3}  # one (rec, rec, attn) group
REC_CHECK_BATCH = 4     # 8 before phase 17; (a)'s CPU side is host-bound
REC_CHECK_PROMPT = 256  # (a): two of mamba2's SSD chunks
REC_CHECK_STEPS = 8
REC_CHECK_SEQ = 256     # (a): the loss and its gradients at B=1
REC_LOGIT_TOL = 1e-3    # (a): max |card - CPU| / max |CPU| of a step's
                        # logits, and of each cached state
REC_BATCH = 8           # (b): requests
REC_PROMPT = 512        # (b): prompt tokens
REC_STEPS = 64          # (b): greedy decode steps
REC_PROFILE = 4         # (b): decode steps under the profiler
# (c): (layers, microbatches) at full width, TRAIN_BATCH x TRAIN_SEQ:
# mamba2 whole; recurrentgemma one group and the 2-layer tail (its 38
# layers need ~150 GB of state), 4 microbatches (its fp32 logits are
# 4.2 GB a sequence)
REC_TRAIN = {"mamba2_130m": (24, 2), "recurrentgemma_9b": (5, 4)}


def rms_norm_without_one(x, scale, eps=1e-6):
    """`layers.rms_norm` with its ``1 +`` dropped: the broken layer that
    phase 13 (a)'s check must fail."""
    xf = x.float()
    y = xf * xf.square().mean(-1, keepdim=True).add(eps).rsqrt()
    return (y * scale.float()).to(x.dtype)


def logit_reading(got, want, vocab):
    """The largest max |got - want| / max |want| over the steps' logits
    (lists of [B, V] on the CPU) on the unpadded vocabulary; inf where
    `got` is not finite."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g[:, :vocab].float(), w[:, :vocab].float()
        if not bool(g.isfinite().all()):
            return math.inf
        worst = max(worst, float((g - w).abs().max()) / float(
            w.abs().max()))
    return worst


def rec_run(cfg, params, tokens, steps, device, feed=None):
    """Prefill then `steps` decode steps of a recurrent family on
    `device`, each step fed the column of `feed` ([B, steps] on the CPU)
    or greedy: (every step's logits on the CPU, the tokens fed, the final
    cache on the CPU)."""
    import torch
    from repro_torch.models import registry
    mod = registry.get_module(cfg)
    B, S = tokens.shape
    cache = mod.init_cache(cfg, B, S + steps + cfg.page_size, device=device)
    cache, logits = mod.prefill(cfg, params, {"tokens": tokens.to(device)},
                                cache)
    out, fed = [logits.cpu()], []
    for i in range(steps):
        fed.append(torch.argmax(out[-1], -1) if feed is None else feed[:, i])
        cache, logits = mod.decode(cfg, params, cache, {
            "tokens": fed[-1][:, None].to(device)})
        out.append(logits.cpu())
    fed = torch.stack(fed, 1) if fed else torch.zeros((B, 0), dtype=int)
    return out, fed, tree_to(cache, "cpu")


def rec_card_vs_cpu(name, seed, device):
    """Phase 13 (a): `name` at full width, REC_CHECK_LAYERS[name] layers,
    fp32: prefill REC_CHECK_BATCH x REC_CHECK_PROMPT tokens and
    REC_CHECK_STEPS greedy decode steps on the card and on the CPU from
    the same parameters, the CPU fed the card's tokens: every step's
    logits and every cached state within REC_LOGIT_TOL of its max, the
    CPU's greedy tokens == the card's; the card's prefill with
    `rms_norm_without_one` fails the limit; the loss and its gradients at
    B=1, S=REC_CHECK_SEQ (`rec_grads`) within TRAIN_LOSS_TOL /
    TRAIN_GRAD_TOL, with flat attention weights where the config's are
    3-D (read with those too)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import layers, registry
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(configs.get(name),
                              n_layers=REC_CHECK_LAYERS[name],
                              dtype="float32")
    B, S, steps = REC_CHECK_BATCH, REC_CHECK_PROMPT, REC_CHECK_STEPS
    params = registry.init(cfg, seed=seed, device=device)
    cpu_params = tree_to(params, cpu)
    tokens = registry.make_prompts(cfg, B, S, seed=seed, device=cpu)
    card, feed, card_cache = rec_run(cfg, params, tokens, steps, device)
    ref, _, cpu_cache = rec_run(cfg, cpu_params, tokens, steps, cpu,
                                feed=feed)
    share = logit_reading(card, ref, cfg.vocab)
    greedy = torch.stack([torch.argmax(x, -1) for x in ref[:-1]], 1)
    states = {k: float((card_cache[k].float() - v.float()).abs().max())
              / max(float(v.float().abs().max()), 1e-30)
              for k, v in cpu_cache.items() if k != "seq_lens"}
    if not share <= REC_LOGIT_TOL:
        raise AssertionError(f"{name} (a): card logits differ from the "
                             f"CPU's by {share:.3g} of max |logit| (limit "
                             f"{REC_LOGIT_TOL})")
    if not torch.equal(greedy, feed):
        raise AssertionError(f"{name} (a): the CPU's greedy tokens differ "
                             f"from the card's")
    bad = {k: v for k, v in states.items() if not v <= REC_LOGIT_TOL}
    if bad or not torch.equal(card_cache["seq_lens"],
                              cpu_cache["seq_lens"]):
        raise AssertionError(f"{name} (a): cached states differ: {bad}")
    real = layers.rms_norm
    layers.rms_norm = rms_norm_without_one
    try:
        mut, _, _ = rec_run(cfg, params, tokens, 0, device)
    finally:
        layers.rms_norm = real
    mut_share = logit_reading(mut, ref[:1], cfg.vocab)
    if mut_share <= REC_LOGIT_TOL:
        raise AssertionError(f"{name} (a): the check passes rms_norm "
                             f"without `1 +`")
    del params, cpu_params
    torch.cuda.empty_cache()
    # the loss and its gradients: with the config's weights (read), and
    # held to the limits with flat attention weights where the config has
    # 3-D ones (the hybrid: under attn_4d the reference's init takes the
    # head count as their fan-in, KVH = 1 for wk / wv, so the scores reach
    # ~1e3 and the softmax turns fp32 rounding at near-ties into
    # gradient differences of parts in 10^3; ROADMAP C)
    grads = {"config": rec_grads(cfg, seed, device)}
    flat = dataclasses.replace(cfg, attn_4d=False)
    held = grads["config"]
    if flat != cfg:
        grads["flat"] = held = rec_grads(flat, seed, device)
    loss_rel, worst, bad, n_leaves = held[:4]
    if not loss_rel <= TRAIN_LOSS_TOL or bad:
        raise AssertionError(f"{name} (a): loss or gradients card != CPU: "
                             f"loss rel {loss_rel}, leaves past "
                             f"{TRAIN_GRAD_TOL}: {bad}")
    out = dict(layers=cfg.n_layers, logit_share=share, states=states,
               mutant_share=mut_share,
               grads={k: dict(loss_rel=g[0], worst=g[1][1],
                              worst_leaf=g[1][0], leaves_past=g[2],
                              leaves=g[3], loss_card=g[4], loss_cpu=g[5])
                      for k, g in grads.items()},
               seconds=time.perf_counter() - t0)
    c = grads["config"]
    print(f"{name} (a): {cfg.n_layers} layers at full width in fp32, "
          f"B={B} x {S} prompt tokens, {steps} greedy decode steps: card == "
          f"CPU, logits max |diff| {share:.3g} of max |logit| (limit "
          f"{REC_LOGIT_TOL}), the CPU's greedy tokens == the card's, "
          f"states " + ", ".join(f"{k} {v:.3g}" for k, v in states.items())
          + f"; rms_norm without `1 +` reads {mut_share:.3g}; loss at B=1, "
          f"S={REC_CHECK_SEQ} rel {loss_rel:.3g} (tol {TRAIN_LOSS_TOL}), "
          f"gradients max |diff| / max |g| at most {worst[1]:.3g} "
          f"({worst[0]}) over {n_leaves} leaves (tol {TRAIN_GRAD_TOL})"
          + ("" if flat == cfg else
             f" with flat attention weights; with the config's attn_4d "
             f"weights loss rel {c[0]:.3g}, gradients at most "
             f"{c[1][1]:.3g} ({c[1][0]}), {len(c[2])} of {c[3]} leaves "
             f"past {TRAIN_GRAD_TOL} (read, not held)")
          + f" [{out['seconds']:.1f} s]")
    return out


def rec_grads(cfg, seed, device):
    """The loss and gradients of `cfg` at B=1, S=REC_CHECK_SEQ on the card
    against the CPU, from the same parameters: `grad_reading`'s (loss
    rel, worst leaf, leaves past TRAIN_GRAD_TOL) + (leaves, loss card,
    loss CPU)."""
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    cpu = torch.device("cpu")
    params = registry.init(cfg, seed=seed, device=device)
    cpu_params = tree_to(params, cpu)
    batch = registry.make_train_batch(
        cfg, ShapeConfig("check", REC_CHECK_SEQ, 1, "train"), seed=seed,
        device=cpu)
    grad_fn = steps_lib.make_grad_fn(cfg)
    want = grad_fn(cpu_params, batch)
    del cpu_params
    got = grad_fn(params, {k: v.to(device) for k, v in batch.items()})
    reading = grad_reading((got[0][0], got[1]), (want[0][0], want[1]))
    out = reading + (len(named_leaves(want[1])), float(got[0][0]),
                     float(want[0][0]))
    del params, got, want
    torch.cuda.empty_cache()
    return out


def rec_profile(cfg, params, cache, toks, n=REC_PROFILE):
    """`n` more greedy decode steps (after one warm-up step) under the
    profiler: per step device busy ms (None where the profiler recorded
    no device time), wall ms and device launches, and the top kernels."""
    import torch
    from repro_torch.models import registry
    mod = registry.get_module(cfg)
    cache, logits = mod.decode(cfg, params, cache, {"tokens": toks})
    state = [cache, logits]

    def run():
        for _ in range(n):
            toks = torch.argmax(state[1], dim=-1)[:, None]
            state[:] = mod.decode(cfg, params, state[0], {"tokens": toks})

    _, busy, wall, launches, top = profile_call(run, top=6)
    return dict(busy_ms=None if busy is None else busy / n,
                wall_ms=wall / n, launches=launches / n,
                top=[[ms / n, c / n, k] for ms, c, k in top])


def rec_serve(name, seed, device, smi):
    """Phase 13 (b): `name` at full width and depth in bf16, REC_BATCH
    requests of REC_PROMPT tokens and REC_STEPS greedy decode steps, the
    five kernel counters set to 0 just before and read just after (they
    must read 0): the hybrid through `launch.serve.serve` (its `sw` pool
    hands out the extents and the decode-time pages), mamba2 through
    `ssm.prefill` / `ssm.decode` (serve refuses ssm, as the reference
    does); then REC_PROFILE more steps under the profiler."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    cfg = configs.get(name)
    mod = registry.get_module(cfg)
    B, S, steps = REC_BATCH, REC_PROMPT, REC_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = registry.init(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in named_leaves(params).values())
    counters = kernel_counters()
    pool = {}
    for f in counters.values():
        f.launches = 0
    if cfg.family == "hybrid":
        res = srv.serve(cfg, batch=B, prompt_len=S, decode_steps=steps,
                        impl="kernel", seed=seed, device=device,
                        params=params)
        torch.cuda.synchronize()
        out, cache, finite = res.tokens, res.cache, res.logits_finite
        pf_s, dec_s = res.timings["prefill_s"], res.timings["decode_s"]
        st = res.stats
        pool = dict(kind=res.pool_kind, rounds=res.pool_rounds,
                    page_allocs=res.page_allocs, stats=st,
                    backend=st["front_misses"] + st["bypass"])
        if st["fails"] or st["front_hits"] <= 0 or res.pool_kind != "sw" \
                or "page_table" in cache:
            raise AssertionError(f"{name} (b): pool {pool}")
    else:
        tokens = registry.make_prompts(cfg, B, S, seed=seed, device=device)
        cache = mod.init_cache(cfg, B, S + steps, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = mod.prefill(cfg, params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        pf_s = time.perf_counter() - t0
        toks = torch.argmax(logits, dim=-1)[:, None]
        out, finite = [toks], torch.isfinite(logits).all()
        t0 = time.perf_counter()
        for _ in range(steps):
            cache, logits = mod.decode(cfg, params, cache, {"tokens": toks})
            toks = torch.argmax(logits, dim=-1)[:, None]
            out.append(toks)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        out, finite = torch.cat(out, 1), bool(finite)
    launched = {k: f.launches for k, f in counters.items()}
    if any(launched.values()):
        raise AssertionError(f"{name} (b): a kernel was launched: "
                             f"{launched}")
    if not finite:
        raise AssertionError(f"{name} (b): non-finite logits in some step")
    if out.shape != (B, steps + 1) or int(out.max()) >= cfg.vocab or \
            int(out.min()) < 0 or \
            cache["seq_lens"].tolist() != [S + steps] * B:
        raise AssertionError(f"{name} (b): tokens {tuple(out.shape)} "
                             f"outside [0, {cfg.vocab}) or lengths "
                             f"{cache['seq_lens'].tolist()}")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    prof = rec_profile(cfg, params, cache, out[:, -1:])
    busy = prof["busy_ms"]
    busy_s = "not measured" if busy is None else \
        f"{busy:.3f} of {prof['wall_ms']:.3f} ms/step " \
        f"({100 * busy / prof['wall_ms']:.1f} %)"
    print(f"{name} (b): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B params in {cfg.dtype} (init {init_s:.2f} "
          f"s); {B} x {S} prompt tokens, {steps} greedy decode steps "
          + ("through launch.serve.serve: " if pool else
             "through ssm.prefill / ssm.decode: ")
          + (f"pool {pool['kind']}, {pool['rounds']} rounds, "
             f"{pool['page_allocs']} decode-time pages, {pool['backend']} "
             f"threads reached the heap's backend, stats {pool['stats']}; "
             if pool else "")
          + f"the five kernels launched {sum(launched.values())} times; "
          f"all logits finite; prefill {pf_s:.4f} s; decode "
          f"{1e3 * dec_s / steps:.3f} ms/step, {B * steps / dec_s:.2f} "
          f"tokens/s; peak device memory {peak_gib:.2f} GiB; profiler "
          f"over {REC_PROFILE} decode steps: {prof['launches']:.0f} device "
          f"launches/step, busy {busy_s}; top: " + "; ".join(
              f"{k} {ms:.3f} ms/step x{c:.0f}" for ms, c, k in prof["top"])
          + f" [{smi}]")
    result = dict(arch=cfg.name, n_params=n_params, init_s=init_s, batch=B,
                  prompt=S, decode_steps=steps, pool=pool,
                  kernel_launches=launched, prefill_s=pf_s,
                  decode_ms_per_step=1e3 * dec_s / steps,
                  tokens_per_s=B * steps / dec_s, peak_gib=peak_gib,
                  profile=prof)
    del params, cache
    torch.cuda.empty_cache()
    return result


def train_family(name, seed, device, smi, n_layers, n_micro, label):
    """Phases 13 (c) and 14 (b): `name` at full width, `n_layers` layers,
    `n_micro` microbatches, bf16, remat, through `launch.train.build` and
    its `make_train_step` on the trainer's TokenStream at TRAIN_BATCH x
    TRAIN_SEQ text tokens (with the stub frontends' embeddings): a
    warm-up step, TRAIN_STEPS timed steps (the counters must read 0), one
    profiled step; then, from a fresh init, one batch repeated
    TRAIN_REPEAT times: its loss falls at every step."""
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg, params, opt, step_fn, stream = train.build(
        name, False, B, S, n_micro, TRAIN_STEPS + 2, device=device,
        layers=n_layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pspec = registry.param_specs(cfg)
    n_params = sum(t.numel() for t in tree_leaves(pspec))
    p_b = tree_bytes(pspec)
    ospec = steps_lib.opt_state_specs(cfg, adamw.AdamWConfig(
        moment_dtype=cfg.opt_moment_dtype))
    mom_b = tree_bytes(ospec.m) + tree_bytes(ospec.v)
    acc_b = 4 * n_params if n_micro > 1 else 0
    plan_b = 2 * p_b + acc_b + mom_b     # params, grads, accumulator, m, v

    def run(params, opt, i):
        return step_fn(params, opt, to_device(stream.batch(i), device))

    params, opt, m = run(params, opt, 0)    # the warm-up step
    torch.cuda.synchronize()
    losses = [float(m["loss"])]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    times = []
    for i in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = run(params, opt, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launched = {k: f.launches for k, f in counters.items()}
    if any(launched.values()):
        raise AssertionError(f"{name} {label}: the training path launched a "
                             f"kernel: {launched}")
    (params, opt, m), busy, wall, launches, kernels = profile_call(
        lambda: run(params, opt, TRAIN_STEPS + 1), top=None)
    classes = kernel_classes(kernels)
    losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    del params, opt, m
    torch.cuda.empty_cache()

    # one batch repeated from the init, with flat attention weights where
    # the config has 3-D ones (the hybrid, the MoEs): under attn_4d the
    # reference's init takes the head count as their fan-in and saturates
    # the softmax (phase 11 (b) says why that stops the loss from falling
    # at every step); the others run as built
    flat = dataclasses.replace(cfg, attn_4d=False)
    params, opt, run = train_setup(flat, seed, device, TRAIN_REPEAT,
                                   n_micro=n_micro)
    rep = []
    for _ in range(TRAIN_REPEAT):
        params, opt, m = run(params, opt, 0)
        rep.append(float(m["loss"]))
    del params, opt, m
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + rep):
        raise AssertionError(f"{name} {label}: non-finite loss: {losses}, "
                             f"{rep}")
    if not all(a > b for a, b in zip(rep, rep[1:])):
        raise AssertionError(f"{name} {label}: the loss on a repeated batch "
                             f"did not fall at every step: {rep}")
    step_s = sum(times) / len(times)
    tokens = B * S
    flops, n_mm = train_flops(cfg, tokens, B, S)
    mfu = flops / step_s / MFU_PEAK
    if not 0 < mfu < 1:
        raise AssertionError(f"{name} {label}: MFU {mfu} outside (0, 1)")
    busy_s = "not measured" if busy is None else \
        f"{busy:.1f} of {wall:.1f} ms ({100 * busy / wall:.1f} %)"
    front = {"vlm": f" after {cfg.n_patches} patches",
             "audio": f" over {cfg.enc_frames} encoder frames ("
                      f"{cfg.enc_layers} encoder layers)"}.get(cfg.family, "")
    print(f"{name} {label}: {cfg.n_layers} layers at full width, "
          f"{n_params / 1e9:.4f} B params, bf16, remat, fp32 moments, B={B} "
          f"x S={S}{front}, {n_micro} microbatches, through "
          f"launch.train.build: "
          f"plan params {p_b / 1e9:.2f} GB + grads {p_b / 1e9:.2f} + fp32 "
          f"accumulator {acc_b / 1e9:.2f} + m, v {mom_b / 1e9:.2f} = "
          f"{plan_b / 1e9:.2f} GB; init {init_s:.2f} s; step "
          f"{1e3 * step_s:.1f} ms (mean of {len(times)}: " + ", ".join(
              f"{1e3 * t:.1f}" for t in times) + f"), {tokens / step_s:.0f} "
          f"tokens/s, MFU {100 * mfu:.2f} % of {MFU_PEAK / 1e12} TFLOP/s "
          f"({flops / 1e12:.2f} TFLOP a step, {n_mm / 1e9:.4f} B matmul "
          f"params); one profiled step: {launches} device launches, busy "
          f"{busy_s}; by kernel class: " + "; ".join(
              f"{k} {t:.1f} ms x{c}" for k, (t, c) in classes.items())
          + f"; the five kernels launched {sum(launched.values())} times; "
          f"losses {[round(x, 4) for x in losses]}; batch 0 repeated from "
          f"the init" + (" (flat attention weights)" if cfg.attn_4d else "")
          + f" {[round(x, 4) for x in rep]}; peak device memory "
          f"{peak / 1e9:.2f} GB against the plan's {plan_b / 1e9:.2f} GB "
          f"[{smi}]")
    return dict(arch=cfg.name, layers=cfg.n_layers, n_params=n_params,
                batch=B, seq=S, n_micro=n_micro, plan_bytes=plan_b,
                peak_bytes=peak, init_s=init_s, step_s=times,
                step_mean_s=step_s, tokens_per_s=tokens / step_s,
                profile_busy_ms=busy, profile_wall_ms=wall,
                launches_per_step=launches, profile_classes=classes,
                losses=losses, repeated_losses=rep, flops=flops,
                matmul_params=n_mm, mfu=mfu, kernel_launches=launched)


def phase_recurrent(seed, device, smi):
    """Phase 13, in the order (b), (c), (a): the timed decode steps and
    training steps run alone; then the example runs phase 14 (c) compares
    start (`start_examples_ahead`) and overlap (a), the card == CPU
    checks, which are not timed. Returns (its result dict, the examples'
    processes)."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": {}, "serve": {}, "train": {}}
    for name in REC_ARCHS:
        out["serve"][name] = rec_serve(name, seed, device, smi)
    for name in REC_ARCHS:
        out["train"][name] = train_family(name, seed, device, smi,
                                          *REC_TRAIN[name], "(c)")
    procs = start_examples_ahead()
    try:
        for name in REC_ARCHS:
            out["card_vs_cpu"][name] = rec_card_vs_cpu(name, seed, device)
    except BaseException:
        stop_examples(procs)
        raise
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13 took {out['seconds']:.1f} s")
    return out, procs


# ---------------------------------------------------------------------------
# phase 14: the moe, vlm and audio families trained (no kernel of their
# own), and the port's examples
# (a): full width, fp32, B=1: the MoEs 1 layer, the others 2 (whisper's
# encoder too), TRAIN_CHECK_TEXT text tokens (paligemma after its patches)
FAM_TRAIN_CHECK = {"olmoe_1b_7b": 1, "qwen2_moe_a2_7b": 1, "paligemma_3b": 2,
                   "whisper_small": 2}
TRAIN_CHECK_TEXT = 64   # 256 before phase 17, 128 before phase 15 (d);
#                         (a)'s CPU side is host-bound
# (b): (layers, microbatches) at full width, TRAIN_BATCH x TRAIN_SEQ text
# tokens, 16 B of state a parameter: olmoe 4 of 16 layers (1.885 B params,
# 30.2 GB), qwen2-moe 2 of 24 (1.833 B, 29.3 GB), paligemma and whisper
# whole; paligemma in 4 microbatches (its fp32 logits are 4.2 GB a
# sequence)
FAM_TRAIN = {"olmoe_1b_7b": (4, 2), "qwen2_moe_a2_7b": (2, 2),
             "paligemma_3b": (18, 4), "whisper_small": (12, 2)}
# (c): the port's examples, each in a subprocess at its default size on the
# card: (name, the kernel whose launches its last line counts)
EXAMPLES = (("quickstart", "heap-step"), ("graph_update", "heap-step"),
            ("serve_paged", "paged-attention"), ("serve_decode", "heap-step"),
            ("serve_fleet", "heap-step"), ("train_lm", None))
EXAMPLES_VS_CPU = ("quickstart", "graph_update")  # == their --device cpu runs
EXAMPLE_TIMEOUT = 600   # seconds a subprocess may take


def route_wrong_axis(cfg, xg, wr):
    """`moe.route` with its gate renormalisation summed over the group's
    tokens instead of each token's k choices: the broken layer that phase
    14 (a)'s check must fail."""
    import torch
    from repro_torch.models import moe
    E, K = cfg.padded_experts, cfg.top_k
    logits = (xg @ wr.to(xg.dtype)).float()
    if E != cfg.n_experts:
        real = torch.arange(E, device=xg.device) < cfg.n_experts
        logits = torch.where(real, logits, moe.MASKED)
    gates, idx = moe.top_k(torch.softmax(logits, dim=-1), K)
    gates = gates / torch.clamp(gates.sum(-2, keepdim=True), min=1e-9)
    return gates, idx


def routed_grads(cfg, params, batch):
    """((loss, grads), [(probs, ids) on the CPU] of every routing of the
    run: the forward's and remat's recomputed one) of `cfg`'s loss at
    `batch`, on the parameters' device."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import moe
    routes, top_k = [], moe.top_k

    def record(x, k):
        vals, idx = top_k(x, k)
        routes.append((x.detach().reshape(-1, x.shape[-1]).cpu(),
                       idx.reshape(-1, k).cpu()))
        return vals, idx

    moe.top_k = record
    try:
        (l, _), g = steps_lib.make_grad_fn(cfg)(params, batch)
    finally:
        moe.top_k = top_k
    return (l, g), routes


def fam_grads(cfg, seed, device):
    """The loss and gradients of `cfg` at B=1 and TRAIN_CHECK_TEXT text
    tokens on the card against the CPU, from the same parameters: the
    reading (`grad_reading`'s parts, the leaves, both losses), the MoE's
    expert choices that differ between the two with their probability
    gaps, and the same reading of the card with the broken layer (the
    MoEs' gate renormalisation over the wrong axis, the others' rms_norm
    without ``1 +``)."""
    import torch
    from repro_torch.models import layers, moe, registry
    from repro_torch.models.config import ShapeConfig
    cpu = torch.device("cpu")
    params = registry.init(cfg, seed=seed, device=device)
    cpu_params = tree_to(params, cpu)
    P = cfg.n_patches if cfg.family == "vlm" else 0
    batch = registry.make_train_batch(
        cfg, ShapeConfig("check", P + TRAIN_CHECK_TEXT, 1, "train"),
        seed=seed, device=cpu)
    want, cpu_routes = routed_grads(cfg, cpu_params, batch)
    del cpu_params
    dbatch = {k: v.to(device) for k, v in batch.items()}
    got, card_routes = routed_grads(cfg, params, dbatch)
    if len(card_routes) != len(cpu_routes):
        raise AssertionError(f"{cfg.name} (a): {len(card_routes)} routings "
                             f"on the card, {len(cpu_routes)} on the CPU")
    flips, routed = [], 0
    for (_, ia), (pb, ib) in zip(card_routes, cpu_routes):
        routed += ia.numel()
        flips += expert_flips(ia, ib, pb)
    loss_rel, worst, bad = grad_reading(got, want)
    loss_card = float(got[0])
    del got
    mod, attr, broken = ((moe, "route", route_wrong_axis)
                         if cfg.family == "moe" else
                         (layers, "rms_norm", rms_norm_without_one))
    real = getattr(mod, attr)
    setattr(mod, attr, broken)
    try:
        mut, _ = routed_grads(cfg, params, dbatch)
    finally:
        setattr(mod, attr, real)
    mut_rel, mut_worst, mut_bad = grad_reading(mut, want)
    out = dict(loss_rel=loss_rel, worst=worst[1], worst_leaf=worst[0],
               leaves_past=bad, leaves=len(named_leaves(want[1])),
               loss_card=loss_card, loss_cpu=float(want[0]), routed=routed,
               flips=len(flips), gaps=[g for _, _, g in flips],
               mutant=attr, mutant_loss_rel=mut_rel,
               mutant_worst=mut_worst[1], mutant_leaves_past=len(mut_bad))
    del params, mut, want
    torch.cuda.empty_cache()
    return out


def fam_train_card_vs_cpu(name, seed, device):
    """Phase 14 (a): `name` at full width, FAM_TRAIN_CHECK[name] layers,
    fp32, B=1: the loss and every gradient on the card against the CPU
    (`fam_grads`) within TRAIN_LOSS_TOL / TRAIN_GRAD_TOL, with flat
    attention weights where the config's are 3-D (the MoEs: their attn_4d
    init saturates the scores, ROADMAP C; read with those too). The
    gradients are held where no expert choice differs between the two
    (a differing one must be a near-tie, <= FAM_TIE_GAP); the loss always.
    The broken layer must fail the same limits."""
    from repro_torch import configs
    t0 = time.perf_counter()
    n = FAM_TRAIN_CHECK[name]
    cfg = dataclasses.replace(configs.get(name), n_layers=n, dtype="float32")
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, enc_layers=n)
    grads = {"config": fam_grads(cfg, seed, device)}
    flat = dataclasses.replace(cfg, attn_4d=False)
    held = grads["config"]
    if flat != cfg:
        grads["flat"] = held = fam_grads(flat, seed, device)
    for what, g in grads.items():
        if any(gap > FAM_TIE_GAP for gap in g["gaps"]):
            raise AssertionError(f"{name} (a) {what}: an expert choice "
                                 f"differs by more than a near-tie: "
                                 f"{g['gaps']}")
        if g["mutant_loss_rel"] <= TRAIN_LOSS_TOL and \
                not g["mutant_leaves_past"]:
            raise AssertionError(f"{name} (a) {what}: the check passes the "
                                 f"broken {g['mutant']}")
    if not held["loss_rel"] <= TRAIN_LOSS_TOL or \
            (held["flips"] == 0 and held["leaves_past"]):
        raise AssertionError(f"{name} (a): loss or gradients card != CPU: "
                             f"loss rel {held['loss_rel']}, leaves past "
                             f"{TRAIN_GRAD_TOL}: {held['leaves_past']}")
    secs = time.perf_counter() - t0
    P = cfg.n_patches if cfg.family == "vlm" else 0
    c = grads["config"]

    def mut(g):
        return (f"{g['mutant']} broken: loss rel {g['mutant_loss_rel']:.3g}"
                f", {g['mutant_leaves_past']} leaves past (worst "
                f"{g['mutant_worst']:.3g})")

    print(f"{name} (a): {cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers over {cfg.enc_frames} "
             f"frames" if cfg.family == "audio" else "")
          + f" at full width in fp32, B=1 x {TRAIN_CHECK_TEXT} text tokens"
          + (f" after {P} patches" if P else "")
          + ": card == CPU"
          + (" with flat attention weights" if flat != cfg else "")
          + f": loss {held['loss_card']} vs {held['loss_cpu']} "
          f"(rel {held['loss_rel']:.3g}, tol {TRAIN_LOSS_TOL}), gradients "
          f"max |diff| / max |g| at most {held['worst']:.3g} "
          f"({held['worst_leaf']}) over {held['leaves']} leaves (tol "
          f"{TRAIN_GRAD_TOL}"
          + (", held" if held["flips"] == 0 else
             f", not held: {held['flips']} expert choices differ")
          + ")"
          + (f"; expert ids of {held['routed']} (token, k): "
             f"{held['flips']} differ" if cfg.family == "moe" else "")
          + f"; {mut(held)}"
          + ("" if flat == cfg else
             f"; with the config's attn_4d weights (read, not held): loss "
             f"rel {c['loss_rel']:.3g}, gradients at most {c['worst']:.3g} "
             f"({c['worst_leaf']}), {len(c['leaves_past'])} of "
             f"{c['leaves']} leaves past {TRAIN_GRAD_TOL}, {c['flips']} of "
             f"{c['routed']} expert choices differ, {mut(c)}")
          + f" [{secs:.1f} s]")
    return dict(layers=cfg.n_layers, grads=grads, seconds=secs)


def finish(proc, what):
    """A subprocess's stdout lines, once it exits with 0 within
    EXAMPLE_TIMEOUT; it is killed otherwise, and the phase fails."""
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no exit within {EXAMPLE_TIMEOUT} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit code {proc.returncode}:\n"
                             + err[-3000:])
    return out.splitlines()


def start_example(name, device, threads=None):
    """(examples/NAME_torch.py --device DEVICE as a subprocess in the
    checkout, with the port's sources on its path and `threads` capping a
    CPU run's threads; its start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if threads:
        env.update(OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads))
    cmd = [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
           "--device", device]
    return (subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            time.perf_counter())


def start_examples_ahead():
    """The example runs phase 14 (c) compares, started after phase 13's
    timed steps: they overlap phase 13 (a), phase 15 and phase 14 (a),
    none of which times the card. Every example's card run (graph_update's
    the longest: the straw-man's host-bound rounds) and quickstart and
    graph_update with ``--device cpu`` (two host threads each). {(name,
    device): (process, start)}."""
    procs = {(name, "cpu"): start_example(name, "cpu", threads=2)
             for name in EXAMPLES_VS_CPU}
    procs.update({(name, "cuda"): start_example(name, "cuda")
                  for name, _ in EXAMPLES})
    return procs


def stop_examples(procs):
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def run_examples(smi, procs):
    """Phase 14 (c): each port example (examples/*_torch.py) at its
    default size (graph_update at the paper's partition: the only run of
    it at that size) in a subprocess with ``--device cuda``, all side by
    side (`procs`, `start_examples_ahead`); quickstart and graph_update
    also with ``--device cpu``. Every run must
    exit with 0; the card's runs of quickstart and
    graph_update print the same lines as the CPU's but their last (the
    launch count), and graph_update's fused row == its hwsw row; the
    kernel each example's last line counts was launched (> 0)."""
    out = {}
    try:
        for name, kernel in EXAMPLES:
            proc, t0 = procs[name, "cuda"]
            lines = finish(proc, f"{name}_torch.py --device cuda")
            secs = time.perf_counter() - t0
            launches = None
            if kernel:
                head = f"{kernel} kernel launches: "
                if not lines or not lines[-1].startswith(head):
                    raise AssertionError(f"{name}: last line {lines[-1:]}")
                launches = int(lines[-1][len(head):])
                if launches <= 0:
                    raise AssertionError(f"{name}: the {kernel} kernel was "
                                         f"not launched")
            out[name] = dict(seconds=secs, launches=launches, lines=lines)
            print(f"{name}_torch.py --device cuda: exit 0 in {secs:.1f} s; "
                  + (f"{kernel} kernel launches {launches}; " if kernel
                     else "")
                  + "last lines: " + " | ".join(lines[-3:]))
        for name in EXAMPLES_VS_CPU:
            proc, t0 = procs[name, "cpu"]
            want = finish(proc, f"{name}_torch.py --device cpu")
            got = out[name]["lines"]
            if got[:-1] != want[:-1] or \
                    want[-1] != "heap-step kernel launches: 0":
                raise AssertionError(f"{name}: the card's lines != the "
                                     f"CPU's:\n" + "\n".join(got) + "\n--\n"
                                     + "\n".join(want))
            out[name]["cpu_s"] = time.perf_counter() - t0
            print(f"{name}_torch.py: the card's {len(got) - 1} result lines "
                  f"== the CPU run's bit for bit (the CPU run done within "
                  f"{out[name]['cpu_s']:.1f} s)")
        rows = {ln.split()[0]: ln.split()[1:] for ln in
                out["graph_update"]["lines"] if ln[:1].isalpha()}
        if rows.get("fused") != rows.get("hwsw"):
            raise AssertionError(f"graph_update: fused {rows.get('fused')} "
                                 f"!= hwsw {rows.get('hwsw')}")
    finally:
        stop_examples(procs)
    print(f"(c) the six examples [{smi}]")
    return out


def phase_train_families(seed, device, smi, procs=None):
    """Phase 14, in the order (a), (c), (b): the examples started ahead
    (`procs`, `start_examples_ahead`; started here if None) overlap (a),
    and (b)'s timed steps run alone. Returns its result dict."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": {}, "train": {}}
    procs = start_examples_ahead() if procs is None else procs
    try:
        for name in FAMILY_ARCHS:
            out["card_vs_cpu"][name] = fam_train_card_vs_cpu(name, seed,
                                                             device)
        out["a_s"] = time.perf_counter() - t0
        out["examples"] = run_examples(smi, procs)
    finally:
        stop_examples(procs)
    out["c_s"] = time.perf_counter() - t0 - out["a_s"]
    for name in FAMILY_ARCHS:
        out["train"][name] = train_family(name, seed, device, smi,
                                          *FAM_TRAIN[name], "(b)")
    out["seconds"] = time.perf_counter() - t0
    out["b_s"] = out["seconds"] - out["a_s"] - out["c_s"]
    print(f"phase 14 took {out['seconds']:.1f} s: (a) {out['a_s']:.1f}, "
          f"(c) {out['c_s']:.1f} (the examples started in phase 13 (a)), "
          f"(b) {out['b_s']:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the analysis tooling
# ---------------------------------------------------------------------------
FLOP_BAND = 0.05        # (b): |dry-run FLOPs / the step's count - 1|
DECODE_CELL = ("decode_32k", SERVE_PROMPT + SERVE_STEPS + 128, SERVE_BATCH)
GRID_BUDGET_S = 5.0     # (c): cells of `dryrun --all` run until this is spent
# (c)'s shapes: a decode cell records 2-11k ops (~1-4 s); a prefill or
# train cell up to ~10^6 (minutes), which tools/dryrun_grid.py runs
GRID_ORDER = ("long_500k", "decode_32k")
RACE_PASS = "write-race"
# (d): (arch, shape, on 2 x 16 x 16, layers) at full width: granite 2 of
# its 40 layers, olmoe 1 of 16
DRY_CELLS = ((SERVE_ARCH, "train_4k", False, 2),
             (SERVE_ARCH, "train_4k", True, 2),
             (SERVE_ARCH, "decode_32k", False, 2),
             ("olmoe_1b_7b", "train_4k", False, 1))


def check_pimcheck(rc, report, kinds, tiers, card=True):
    """(a): pimcheck's report on every kind at every tier, the fixtures and
    the tapes: exit code 0, each kind/tier row with 0 findings and 0
    suppressed, ``fused``'s rows one ``repro_torch::heap_step`` node (the
    round's; none off the card, where the plain version runs), the other
    kinds' none, each fixture flagged by its own pass, every tape clean.
    Raises AssertionError."""
    rows = report["rows"]
    kt = [r for r in rows if not r["target"].startswith(("fixture:",
                                                          "tape:"))]
    fx = [r for r in rows if r["target"].startswith("fixture:")]
    tapes = [r for r in rows if r["target"].startswith("tape:")]
    errs = []
    if rc != 0:
        errs.append(f"exit code {rc}")
    if sorted((r["target"], r["tier"]) for r in kt) != sorted(
            (k, t) for k in kinds for t in tiers):
        errs.append(f"kind/tier rows {[(r['target'], r['tier']) for r in kt]}")
    for r in kt:
        want = {"repro_torch::heap_step": 1} \
            if r["target"] == "fused" and card else {}
        if r["findings"] or r["suppressed"] or r["kernel_nodes"] != want:
            errs.append(f"{r['target']}/{r['tier']}: findings "
                        f"{r['findings']}, suppressed {r['suppressed']}, "
                        f"kernel nodes {r['kernel_nodes']} (want {want})")
    if len(fx) != 4 or not all(r["flagged_by_expected"] for r in fx):
        errs.append(f"fixtures {fx}")
    if len(tapes) != len(TAPES) or any(r["findings"] for r in tapes):
        errs.append(f"tapes {tapes}")
    if report["findings"] or report["fixture_failures"] or \
            report["tape_errors"] or report["suppressed"]:
        errs.append(f"report {report['findings'][:3]} "
                    f"{report['fixture_failures']} {report['tape_errors']}")
    if errs:
        raise AssertionError("pimcheck (a): " + "; ".join(errs))


def check_pass_disabled(rc, report, fixture="aliased_scatter"):
    """(a): with the write-race pass left out, pimcheck misses exactly the
    fixture planted for it and exits 1. Raises AssertionError."""
    if rc != 1 or len(report["fixture_failures"]) != 1 or \
            fixture not in report["fixture_failures"][0]:
        raise AssertionError(f"pimcheck (a) without {RACE_PASS}: exit code "
                             f"{rc}, misses {report['fixture_failures']}")


def recompute_skipped(cfg, tokens):
    """FLOPs `train_flops` counts that the dense family's step does not
    run: the head is outside the checkpointed blocks (6 a parameter and
    token, not 8), and a non-reentrant checkpoint stops its recompute at
    the block's last saved activation, so each layer's down projection
    (w2) is not run twice."""
    from repro_torch.models import registry
    spec = registry.param_specs(cfg)
    head = spec.get("head", spec["embed"])
    return 2 * tokens * (head.numel() + spec["blocks"]["w2"].numel())


def check_dry_train(ana, want_args, plan, peak, want_flops):
    """(b): the dry-run of phase 11's cell against phase 11's run: its
    argument bytes == the step's inputs (parameters, AdamW's m, v and
    count, the batch) byte for byte; plan <= its peak estimate <= the
    measured peak; its FLOPs within FLOP_BAND of `want_flops`. Raises
    AssertionError."""
    errs = []
    if ana["argument_bytes"] != want_args:
        errs.append(f"argument bytes {ana['argument_bytes']} != "
                    f"{want_args}")
    if not plan <= ana["peak_bytes"] <= peak:
        errs.append(f"peak estimate {ana['peak_bytes']} outside [{plan}, "
                    f"{peak}]")
    if not abs(ana["flops"] / want_flops - 1) <= FLOP_BAND:
        errs.append(f"FLOPs {ana['flops']} vs {want_flops} (band "
                    f"{FLOP_BAND})")
    if errs:
        raise AssertionError("dry-run (b): " + "; ".join(errs))


def dry_line(res):
    """One line for a dry-run cell: the one-device program, then the
    per-device one where the cell has it."""
    if res["status"] != "ok":
        return (f"{res['arch']}/{res['shape']}/{res['mesh']}: "
                f"{res['status']} ({res.get('reason', res.get('error'))})")
    a = res["op_analysis"]
    state = sum(res["state_bytes_per_device"].values())
    line = (f"{res['arch']}/{res['shape']}/{res['mesh']}: layers "
            f"{res['layers']}, B={res['global_batch']}, S={res['seq_len']}"
            + (f", n_micro {res['n_micro']}" if "n_micro" in res else "")
            + f"; one device {a['flops'] / 1e12:.2f} TFLOP, memory "
            f"{a['memory_bytes'] / 1e12:.3f} TB, peak "
            f"{a['peak_bytes'] / 1e9:.2f} GB (fits one card: "
            f"{res['fits_one_card']}), {a['n_ops']} ops in "
            f"{res['record_s']} s; state per device {state / 1e9:.3f} GB")
    d = res["spmd_program"]
    if d["status"] != "ok":
        raise AssertionError(f"{line}; the per-device program failed:\n"
                             f"{d['traceback']}")
    rf = res["roofline"]
    return line + (
        f"; per device {d['flops'] / 1e12:.4g} TFLOP, args "
        f"{d['argument_bytes'] / 1e9:.3f} GB, peak "
        f"{d['peak_bytes'] / 1e9:.3f} GB (fits: {d['fits_per_device']}), "
        f"collectives {d['collective_bytes'] / 1e9:.4g} GB; compute "
        f"{rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g} s, "
        f"collective {rf['collective_s']:.4g} s ({rf['bottleneck']}); "
        f"{d['n_ops']} ops in {d['record_s']} s")


def dry_want_args(cfg, res, mesh):
    """(d): the argument bytes a device of the cell's program holds: for a
    train cell the rules' state (parameters, m, v) + AdamW's count + its
    rows of the batch; for a serving cell the whole weights (the port's
    serving program holds them whole) + its rows' slice of the cache's
    pages + its rows of the rest."""
    from repro_torch.models import registry
    from repro_torch.models.config import SHAPES
    from repro_torch.parallel import sharding
    shape = SHAPES[res["shape"]]
    dp = math.prod(n for a, n in mesh.items() if a != "model")
    if shape.kind == "train":
        rows = shape.global_batch // dp
        batch = registry.train_specs(cfg, shape)
        return (sum(res["state_bytes_per_device"].values()) + 4
                + tree_bytes(batch) // shape.global_batch * rows)
    batch, cache = registry.decode_specs(cfg, shape)
    data, model = mesh["data"], mesh["model"]
    div = {k: data * (model if k in ("k_pages", "v_pages") else 1)
           for k in cache}
    return (tree_bytes(registry.param_specs(cfg))
            + sum(t.numel() * t.element_size() // div[k]
                  for k, t in cache.items())
            + tree_bytes(batch) // data)


def check_dry_spmd(res, cfg, mesh, one_flops):
    """(d): one cell's per-device program (module docstring). Raises
    AssertionError."""
    from repro_torch.launch import dryrun
    d = res["spmd_program"]
    if d["status"] != "ok":
        raise AssertionError(f"dry-run (d) {res['arch']}/{res['shape']}/"
                             f"{res['mesh']}: the per-device program failed:"
                             f"\n{d['traceback']}")
    errs = []
    rf, sched = res["roofline"], res["collective_schedule"]
    n = math.prod(mesh.values())
    want = dry_want_args(cfg, res, mesh)
    if res["devices"] != n or d["argument_bytes"] != want:
        errs.append(f"devices {res['devices']} (want {n}), argument bytes "
                    f"{d['argument_bytes']} (want {want})")
    if res["kind"] == "train" and cfg.family == "dense":
        # each weight gathered at its use: a device runs its share exactly
        if d["flops"] * n != one_flops:
            errs.append(f"FLOPs {d['flops']} x {n} != the one-device "
                        f"program's {one_flops}")
    elif not one_flops / n <= d["flops"] <= one_flops:
        errs.append(f"FLOPs {d['flops']} outside [{one_flops / n}, "
                    f"{one_flops}]")
    if rf["collective_s"] != d["collective_bytes"] / dryrun.NVLINK_BW or \
            rf["bottleneck"] != max(("compute_s", "memory_s",
                                     "collective_s"), key=rf.get):
        errs.append(f"roofline {rf}")
    ops = {(e["op"], e["axis"]) for e in sched}
    if res["kind"] == "train":
        if ("all_gather_into_tensor", "data") not in ops:
            errs.append(f"no all-gather over data in {sorted(ops)}")
    elif ops != {("allreduce_", "model")} or sum(
            e["times"] for e in sched) != 2 * res["layers"]:
        errs.append(f"decode schedule {sched}")
    if d["kernel_nodes"]:
        errs.append(f"kernel nodes {d['kernel_nodes']}")
    if errs:
        raise AssertionError(f"dry-run (d) {res['shape']}/{res['mesh']}: "
                             + "; ".join(errs))


def spmd_lines(res, one_flops):
    """(d)'s lines for a cell's per-device program."""
    d, rf = res["spmd_program"], res["roofline"]
    n = res["devices"]
    state = sum(res["state_bytes_per_device"].values())
    top = ", ".join(f"{e['op']} {e['shape']} over {e['axis']} x{e['times']}"
                    for e in res["collective_schedule"][:3])
    return [
        f"(d) {res['arch']}/{res['shape']}/{res['mesh']} ({n} devices, "
        f"{res['layers']} layers" + (f", n_micro {res['n_micro']}"
                                     if "n_micro" in res else "")
        + f"): per device argument bytes {d['argument_bytes']} (rules' "
        f"state {state} + the rows" + (" + whole weights less the rules' "
                                       "share" if res["kind"] != "train"
                                       else " + count")
        + f"), peak {d['peak_bytes'] / 1e9:.3f} GB (fits: "
        f"{d['fits_per_device']}); {d['flops'] / 1e12:.4f} TFLOP against "
        f"the one-device program's / {n} = {one_flops / n / 1e12:.4f} "
        f"({d['flops'] / (one_flops / n):.3f} x)",
        f"(d)   collectives {d['collective_bytes'] / 1e9:.4f} GB a step: "
        f"by op " + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                              d["collective_bytes_by_op"].items())
        + "; by axis " + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                                   d["collective_bytes_by_axis"].items())
        + f" GB; largest: {top}",
        f"(d)   compute {rf['compute_s']:.4g} s, memory "
        f"{rf['memory_s']:.4g} s, collective {rf['collective_s']:.4g} s at "
        f"NVLink's data-sheet 450 GB/s: {rf['bottleneck']}; recorded "
        f"{d['n_ops']} ops in {d['record_s']} s (one-device program "
        f"{res['record_s']} s)"]


def phase_analysis(seed, device, smi, train_result):
    """Phase 15: (a) pimcheck on the card, and again without the
    write-race pass; (b) the dry-run of phase 11's cell on fake tensors
    against phase 11's plan, measured peak and FLOP count, and of a
    decode step at phase 7's shape (one paged-attention node a layer, no
    launch); (c) as many decode cells of the `dryrun --all` grid as fit
    GRID_BUDGET_S; (d) the per-device programs of DRY_CELLS on fake worlds
    of 256 and 512 ranks (`check_dry_spmd`). Returns its result dict."""
    import tempfile

    from repro_torch import configs
    from repro_torch.analysis import pimcheck
    from repro_torch.core import heap
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    out = {}
    where, card = device.type, device.type == "cuda"

    # ---- (a) pimcheck ------------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rep = os.path.join(tmp, "all.json")
        rc = pimcheck.main(["--all-kinds", "--tapes", "--fixtures",
                            "--device", where, "--json", rep])
        with open(rep) as f:
            report = json.load(f)
        check_pimcheck(rc, report, heap.kinds(), pimcheck.TIERS, card)
        keep = [p for p in pimcheck.PASS_NAMES if p != RACE_PASS]
        rep2 = os.path.join(tmp, "no_race.json")
        rc2 = pimcheck.main(["--fixtures", "--passes", ",".join(keep),
                             "--device", where, "--json", rep2])
        with open(rep2) as f:
            report2 = json.load(f)
        check_pass_disabled(rc2, report2)
    ops = {f"{r['target']}/{r['tier']}": r["ops"] for r in report["rows"]
           if "kernel_nodes" in r}
    out["pimcheck"] = dict(rc=rc, rc_without_race=rc2, ops=ops,
                           s=time.perf_counter() - t0)
    print(f"(a) pimcheck --all-kinds --tapes --fixtures on the card: exit 0, "
          f"{len(ops)} kind/tier rounds with 0 findings and 0 suppressed "
          f"(ops recorded: " + ", ".join(f"{k} {v}" for k, v in ops.items())
          + "), fused one repro_torch::heap_step node a round checked through"
          f" its plain version, 4 fixtures each flagged by its pass, "
          f"{len(TAPES)} tapes clean; without {RACE_PASS}: exit 1, "
          f"{report2['fixture_failures'][0]!r} "
          f"[{out['pimcheck']['s']:.1f} s]")

    # ---- (b) the dry-run of phase 11's cell and a decode step --------------
    t0 = time.perf_counter()
    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    cell = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), n_layers=TRAIN_LAYERS)
    ana, rec_s = dryrun.program(cfg, cell, TRAIN_MICRO, where)
    ospec = steps.opt_state_specs(cfg, adamw.AdamWConfig(
        moment_dtype=cfg.opt_moment_dtype))
    want_args = (tree_bytes(registry.param_specs(cfg)) + tree_bytes(
        {"m": ospec.m, "v": ospec.v, "c": ospec.count})
        + tree_bytes(registry.train_specs(cfg, cell)))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tf, _ = train_flops(cfg, tokens, TRAIN_BATCH, TRAIN_SEQ)
    skipped = recompute_skipped(cfg, tokens)
    plan, peak = train_result["plan_bytes"], train_result["peak_bytes"]
    check_dry_train(ana, want_args, plan, peak, tf - skipped)
    shape = ShapeConfig(*DECODE_CELL[:2], DECODE_CELL[2], "decode")
    dec, _ = dryrun.program(dataclasses.replace(
        configs.get(SERVE_ARCH), attend_impl="kernel"), shape, 1, where)
    nodes = dec["kernel_nodes"]
    want_nodes = {"repro_torch::paged_attention":
                  configs.get(SERVE_ARCH).n_layers} if card else {}
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    if nodes != want_nodes or any(launched.values()):
        raise AssertionError(f"dry-run (b) decode: kernel nodes {nodes} "
                             f"(want {want_nodes}); launches {launched}")
    out["dry_train"], out["dry_decode"] = ana, dec
    out["b_s"] = time.perf_counter() - t0
    print(f"(b) dry-run of phase 11's cell ({SERVE_ARCH}, {TRAIN_LAYERS} "
          f"layers, {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MICRO} microbatches, "
          f"fake CUDA tensors): argument bytes {ana['argument_bytes']} == "
          f"parameters + m + v + count + batch (phase 11's plan "
          f"{plan / 1e9:.2f} GB also holds the gradients and the fp32 "
          f"accumulator the step makes); peak estimate "
          f"{ana['peak_bytes'] / 1e9:.3f} GB in [plan {plan / 1e9:.3f}, "
          f"measured {peak / 1e9:.3f}]; {ana['flops'] / 1e12:.3f} TFLOP = "
          f"{ana['flops'] / (tf - skipped):.5f} x the step's count "
          f"{(tf - skipped) / 1e12:.3f} (train_flops {tf / 1e12:.3f} less "
          f"{skipped / 1e12:.3f} not recomputed; {ana['flops'] / tf:.4f} x "
          f"train_flops), memory {ana['memory_bytes'] / 1e12:.3f} TB, "
          f"{ana['n_ops']} ops in {rec_s:.2f} s; decode at phase 7's "
          f"shape (B={shape.global_batch}, {shape.seq_len} positions): "
          f"{nodes}, {dec['flops'] / 1e9:.2f} GFLOP, peak "
          f"{dec['peak_bytes'] / 1e9:.2f} GB, 0 launches "
          f"[{out['b_s']:.1f} s] [{smi}]")

    # ---- (c) the grid, as far as the budget goes ---------------------------
    t0 = time.perf_counter()
    grid = [(a, n, mp) for n in GRID_ORDER for a in configs.ARCHS
            for mp in (False, True)]
    programs, cells = {}, []
    for arch, name, mp in grid:
        if time.perf_counter() - t0 > GRID_BUDGET_S:
            break
        cells.append(dryrun.dryrun_cell(arch, name, multi_pod=mp,
                                        device=where, verbose=False,
                                        _programs=programs))
        print("(c) " + dry_line(cells[-1]))
    out["grid"] = cells
    out["c_s"] = time.perf_counter() - t0
    print(f"(c) {len(cells)} of the grid's {len(grid)} decode cells in "
          f"{out['c_s']:.1f} s (the whole grid of 80: "
          f"tools/dryrun_grid.py)")

    # ---- (d) the per-device SPMD program on fake worlds -------------------
    t0 = time.perf_counter()
    before = {k: f.launches for k, f in counters.items()}
    from repro_torch.launch.mesh import make_production_mesh
    programs, out["spmd"] = {}, []
    for arch, name, mp, layers in DRY_CELLS:
        res = dryrun.dryrun_cell(arch, name, multi_pod=mp, layers=layers,
                                 device=where, verbose=False,
                                 _programs=programs)
        dcfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        one = res["op_analysis"]["flops"]
        check_dry_spmd(res, dcfg, make_production_mesh(multi_pod=mp), one)
        out["spmd"].append(res)
        for line in spmd_lines(res, one):
            print(line)
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    if any(launched.values()):
        raise AssertionError(f"dry-run (d) launched kernels {launched}")
    out["d_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"(d) {len(DRY_CELLS)} per-device programs on fake worlds of "
          f"256 and 512 ranks in {out['d_s']:.1f} s, 0 launches [{smi}]")
    print(f"phase 15 took {out['seconds']:.1f} s: (a) "
          f"{out['pimcheck']['s']:.1f}, (b) {out['b_s']:.1f}, (c) "
          f"{out['c_s']:.1f}, (d) {out['d_s']:.1f} [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 16: the heap fleet and sequence-parallel decode across processes
# ---------------------------------------------------------------------------
MESH_PROCS = 4          # (a), (b): processes of the rank mesh
MESH_SHARDS = ((8, 16), (2, 64))  # (a): ShardedHeap (R, C): 2 ranks a
#                         process; 2 processes holding ranks and 2 none
MESH_SHARD_ROUNDS = 4   # (a): malloc / realloc / free rounds of each
SEQPAR_PROCS = 2        # (c): the ("data"=1, "model"=2) mesh
SEQPAR_STEPS = 16       # (c): greedy decode steps after 8 x 512 prompts
SEQPAR_BF16_GAP = 2e-2  # (c): a top-2 gap / max |logit| below it may flip
# (c) decodes with flat attention weights (attn_4d off): under the
# config's attn_4d init the softmax is one-hot and 40 layers amplify any
# change of summation order, so that even the one-device kernel and plain
# attention disagree on every token after the first decode step
# (tools/seqpar_divergence.py)
SEQPAR_CHECK = (2, 2, 256, 4)  # (c) fp32: layers, batch, prompt, steps
SEQPAR_FP32_TOL = 1e-4  # (c) fp32: max |mesh - one device| / max |logit|
def mesh_device():
    """A spawned process's device: its current card."""
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def host_digest(x):
    """sha256 of a tensor's bytes (on the host)."""
    import hashlib
    return hashlib.sha256(
        x.detach().contiguous().cpu().view(-1).numpy().tobytes()).hexdigest()


def resp_digests(resp):
    return {f: host_digest(getattr(resp, f)) for f in resp._fields}


def leaf_digests(tree, rows=None):
    """Each state leaf's digest, of its rows `rows` (a slice) where given."""
    from repro_torch import convert
    return [host_digest(x if rows is None else x[rows])
            for x in convert.leaves(tree)]


def digests_equal(got, want, what):
    if got != want:
        bad = ([f for f in want if got.get(f) != want[f]]
               if isinstance(want, dict) else
               [i for i, (a, b) in enumerate(zip(got, want)) if a != b])
        raise AssertionError(f"{what}: differs on {bad or 'length'}")


def gather_timer(comm, name="all_gather"):
    """Wrap `comm.<name>` to add its host seconds to a counter; returns
    (the counter list, a restore function)."""
    real = getattr(comm, name)
    spent = [0.0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    setattr(comm, name, timed)
    return spent, lambda: setattr(comm, name, real)


def mesh_fleet_session(mesh, device):
    """(a): the paper's fleet (phase 5e (a)'s steady session) on kind
    fused; returns the engine, plan, final state and responses."""
    from repro_torch.launch.serve_fleet import FleetServe, TrafficConfig
    shape, traffic = SERVE_FLEET
    tc = TrafficConfig(arrival_rate=SERVE_RATE,
                       **dict(traffic, rounds=STEADY_ROUNDS))
    eng = FleetServe(paper_cfg("fused"), shape[0], shape[1], traffic=tc,
                     placement="least_loaded", mesh=mesh, device=device)
    plan = eng.plan()
    return eng, plan


def mesh_shard_sizes(seed, R, C, T):
    import numpy as np
    rng = np.random.default_rng(seed + R)
    return rng.choice([16, 100, 256, 2048, 3000, 8192],
                      (MESH_SHARD_ROUNDS, R, C, T)).astype(np.int32)


def mesh_shard_session(h, sizes):
    """(a): malloc, realloc (rolled sizes), free the survivors, a round
    each row of `sizes`; the responses' digests."""
    import numpy as np
    import torch
    out = []
    for s in sizes:
        ra = h.malloc(s)
        rr = h.realloc(ra.ptr, np.roll(s, 1, axis=-1))
        rf = h.free(torch.where(rr.ptr >= 0, rr.ptr, ra.ptr))
        out += [resp_digests(r) for r in (ra, rr, rf)]
    return out


def mesh_chaos_engine(mesh, device):
    """(b): phase 5e (c)'s chaos session on fused."""
    from repro_torch.launch import elastic
    from repro_torch.launch.serve_fleet import TrafficConfig
    shape, traffic = SERVE_FLEET
    tc = TrafficConfig(arrival_rate=SERVE_RATE, zipf_a=CHAOS_ZIPF, **traffic)
    faults = elastic.FaultPlan.generate(rounds=tc.rounds, shape=shape,
                                        **CHAOS_FAULTS)
    return elastic.ElasticFleetServe(
        paper_cfg("fused"), shape[0], shape[1], traffic=tc,
        placement="chunked", mesh=mesh, device=device, faults=faults,
        migration=elastic.MigrationConfig(**CHAOS_MIGRATION))


def mesh_held(eng):
    return None if eng.shard is None else (eng.shard.lo, eng.shard.hi)


def mesh_fleet_worker(seed, snap_mesh, snap_fold):
    """Phase 16 (a) and (b) on one process of the group: the fleet
    session, the two ShardedHeaps and the chaos session snapshotted on
    the mesh, then the one-device snapshot restored on it. Returns
    digests, reports, launches and host times."""
    import torch
    from repro_torch.core import heap
    from repro_torch.kernels import heap_step
    from repro_torch.launch.serving import fleet_health
    from repro_torch.parallel import comm
    device = mesh_device()
    spent, restore = gather_timer(comm)
    out = {"rank": torch.distributed.get_rank()}
    try:
        eng, plan = mesh_fleet_session(None, device)
        sync(device)
        heap_step.fused_heap_step.launches = 0
        spent[0] = 0.0
        t0 = time.perf_counter()
        state, resps = eng.run(plan)
        sync(device)
        run_s = time.perf_counter() - t0
        R, C, _ = eng.shape
        out["fleet"] = dict(
            launches=heap_step.fused_heap_step.launches, run_s=run_s,
            gather_s=spent[0], rounds=plan.rounds, held=mesh_held(eng),
            report=eng.report(plan, resps, state),
            health=fleet_health(eng.cfg, state, R, C, eng.shard),
            resps=resp_digests(resps), state=leaf_digests(state))
        del eng, state, resps
        out["shards"] = {}
        for R, C in MESH_SHARDS:
            h = heap.ShardedHeap(paper_cfg("fused"), R, C, device=device)
            got = mesh_shard_session(h, mesh_shard_sizes(
                seed, R, C, h.num_threads))
            out["shards"][R] = dict(held=mesh_held(h), resps=got,
                                    state=leaf_digests(h.state))
            del h
        eng = mesh_chaos_engine(None, device)
        heap_step.fused_heap_step.launches = 0
        eng.start()
        eng.run_until(SNAP_ROUND)
        eng.snapshot(snap_mesh)
        _, rep = eng.finish()
        out["chaos"] = dict(report=rep, launches=heap_step.fused_heap_step
                            .launches, held=mesh_held(eng),
                            resps=resp_digests(eng._stacked()),
                            state=leaf_digests(eng.state))
        del eng
        eng = mesh_chaos_engine(None, device).restore(snap_fold)
        heap_step.fused_heap_step.launches = 0
        _, rep = eng.finish()
        out["restored"] = dict(report=rep, launches=heap_step.fused_heap_step
                               .launches, held=mesh_held(eng),
                               resps=resp_digests(eng._stacked()),
                               state=leaf_digests(eng.state))
    finally:
        restore()
    return out


def check_mesh_fleet(got, want, what):
    """Every process's report (and, where given, fleet health) == the
    one-device session's, its responses (gathered) bit for bit, and the
    state slice it holds bit for bit."""
    for g in got:
        if "health" in want and g.get("health") != want["health"]:
            raise AssertionError(f"{what}: process {g['rank']}'s fleet "
                                 f"health {g.get('health')} != "
                                 f"{want['health']}")
        if g["report"] != want["report"]:
            bad = [k for k in want["report"]
                   if g["report"].get(k) != want["report"][k]]
            raise AssertionError(f"{what}: process {g['rank']}'s report "
                                 f"differs on {bad}")
        digests_equal(g["resps"], want["resps"],
                      f"{what}: process {g['rank']}'s responses")
        lo, hi = g["held"]
        if hi > lo:
            digests_equal(g["state"], want["state_rows"][(lo, hi)],
                          f"{what}: process {g['rank']}'s ranks [{lo}, "
                          f"{hi})")


def one_device_fleet(seed, device, snap_fold, holds):
    """The one-device (``mesh=False``) runs (a) and (b) are held to:
    digests of responses and of the state rows each process holds
    (`holds`: the (lo, hi) the rank mesh gives), the reports; the chaos
    session is snapshotted at SNAP_ROUND into `snap_fold` on the way."""
    from repro_torch.core import heap
    from repro_torch.launch.serving import fleet_health
    out = {}
    eng, plan = mesh_fleet_session(False, device)
    t0 = time.perf_counter()
    state, resps = eng.run(plan)
    sync(device)
    out["fleet_s"] = time.perf_counter() - t0
    R, C, _ = eng.shape
    out["fleet"] = dict(report=eng.report(plan, resps, state),
                        health=fleet_health(eng.cfg, state, R, C),
                        resps=resp_digests(resps), state_rows={
                            h: leaf_digests(state, slice(*h))
                            for h in holds[0]})
    del eng, state, resps
    out["shards"] = {}
    for (R, C), hs in zip(MESH_SHARDS, holds[1:]):
        h = heap.ShardedHeap(paper_cfg("fused"), R, C, mesh=False,
                             device=device)
        out["shards"][R] = dict(
            resps=mesh_shard_session(h, mesh_shard_sizes(
                seed, R, C, h.num_threads)),
            state_rows={x: leaf_digests(h.state, slice(*x)) for x in hs})
        del h
    eng = mesh_chaos_engine(False, device)
    eng.start()
    eng.run_until(SNAP_ROUND)
    eng.snapshot(snap_fold)
    _, rep = eng.finish()
    out["chaos"] = dict(report=rep, resps=resp_digests(eng._stacked()),
                        state_rows={h: leaf_digests(eng.state, slice(*h))
                                    for h in holds[0]})
    return out


def seqpar_worker(seed, feed):
    """Phase 16 (c) on one process of the ("data"=1, "model"=2) mesh:
    granite-3-8b at full width in bf16 through `launch.serve.serve(...,
    mesh=)`, the same decode fed `feed` (the one-device run's tokens,
    [B, steps]), then the fp32 slice. Returns tokens, logits and host
    times."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    from repro_torch.parallel import comm
    device = mesh_device()
    mesh = mesh_mod.make_host_mesh(model=SEQPAR_PROCS, live=True)
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), attn_4d=False)
    params = registry.init(cfg, seed=seed, device=device)
    spent, restore = gather_timer(comm, "all_reduce")
    try:
        pa.paged_attention.launches = 0
        res = srv.serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                        decode_steps=SEQPAR_STEPS, impl="kernel", seed=seed,
                        device=device, params=params, mesh=mesh)
        sync(device)
    finally:
        restore()
    out = dict(rank=torch.distributed.get_rank(), tokens=res.tokens.cpu(),
               timings=res.timings,
               pa_launches=pa.paged_attention.launches,
               collective_s=spent[0], pages=res.cache["k_pages"].shape[2],
               finite=res.logits_finite,
               peak=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    del res
    prompts = registry.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    seed=seed, device=device)
    forced = seqpar_steps(cfg, params, prompts, SEQPAR_STEPS, device, mesh,
                          feed=feed)
    out["forced"] = torch.stack([x.argmax(-1) for x in forced], 1).cpu()
    del params, forced
    L, B, S, steps = SEQPAR_CHECK
    fcfg = dataclasses.replace(configs.get(SERVE_ARCH), n_layers=L,
                               dtype="float32")
    out["fp32"] = seqpar_fp32_logits(fcfg, seed, device, mesh)
    return out


def seqpar_steps(cfg, params, tokens, steps, device, mesh, feed=None):
    """Prefill `tokens` [B, S] and `steps` decode steps of `cfg` on
    `device`, on `mesh` or (None) on one device, each step fed column i of
    `feed` ([B, steps]) or its greedy token; every step's logits (on the
    device). The page table rotates each sequence's pages, so that a
    token's page may lie on either process of the mesh."""
    import torch
    from repro_torch.models import transformer
    B, S = tokens.shape
    kw = {} if mesh is None else {"mesh": mesh}
    cache = transformer.init_cache(cfg, B, S + steps + cfg.page_size,
                                   device=device, **kw)
    P = cache["page_table"].shape[1]
    cache["page_table"] = ((torch.arange(P, device=device)[None, :]
                            + torch.arange(B, device=device)[:, None] + 1)
                           % P).to(torch.int32)
    cache, logits = transformer.prefill(cfg, params, {"tokens": tokens},
                                        cache, **kw)
    out = [logits]
    for i in range(steps):
        tok = (torch.argmax(logits, -1) if feed is None
               else feed[:, i].to(device))
        cache, logits = transformer.decode(cfg, params, cache,
                                           {"tokens": tok[:, None]}, **kw)
        out.append(logits)
    return out


def seqpar_fp32_logits(cfg, seed, device, mesh):
    """(c) fp32: prefill + greedy decode steps of `cfg` (a slice of the
    full-width model) from `seed`'s weights and prompts, on `mesh` or on
    one device; every step's logits on the host."""
    from repro_torch.models import registry
    _, B, S, steps = SEQPAR_CHECK
    params = registry.init(cfg, seed=seed, device=device)
    tokens = registry.make_prompts(cfg, B, S, seed=seed, device=device)
    return [x.cpu() for x in seqpar_steps(cfg, params, tokens, steps, device,
                                          mesh)]


def top2_gaps(logits, vocab):
    """[steps + 1, B]: each step's gap between a request's two largest
    logits over its largest |logit|, on the real vocabulary (`logits`: a
    list of [B, padded vocab], one a step); on the host."""
    import torch
    out = []
    for x in logits:
        real = x[:, :vocab].float()
        top = torch.topk(real, 2, dim=-1).values
        out.append((top[:, 0] - top[:, 1]) / real.abs().amax(-1))
    return torch.stack(out).cpu()


def near_tie_errors(got, want, gaps, what, free=False):
    """Greedy tokens `got` against `want` ([B, steps + 1]): a token may
    differ only where the one-device top-2 gap (`gaps`, [steps + 1, B])
    is below SEQPAR_BF16_GAP. With `free` (a free-running decode) a
    request is compared up to its first difference, after which its
    history is another one. Returns (errors, differing (request, step))."""
    errs, diff = [], []
    for b in range(want.shape[0]):
        for k in range(want.shape[1]):
            if int(got[b, k]) == int(want[b, k]):
                continue
            diff.append((b, k))
            if float(gaps[k, b]) >= SEQPAR_BF16_GAP:
                errs.append(f"{what}: request {b} step {k} token "
                            f"{int(got[b, k])} != {int(want[b, k])} at a top-2 "
                            f"gap of {float(gaps[k, b]):.3g}")
            if free:
                break
    return errs, diff


def phase_mesh(seed, device, smi):
    """Phase 16: (a) the paper's fleet on a rank mesh of MESH_PROCS
    processes on kind fused == the one-device session bit for bit, and
    ShardedHeaps of 8 and 2 ranks; (b) the chaos session snapshotted on
    the mesh and finished on one device, and the other way round, each
    == the uninterrupted run; (c) granite-3-8b at full width decoded on
    a ("data"=1, "model"=2) mesh == on one device, and its fp32 slice
    within SEQPAR_FP32_TOL. Returns the result dict."""
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    from repro_torch.parallel.meshctx import rank_mesh_size
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_PROCS else "gloo"
    backend_c = "nccl" if cards >= SEQPAR_PROCS else "gloo"
    where = (f"{backend} on one card: collectives staged through the host, "
             f"not NVLink" if backend == "gloo" and cards == 1 else backend)
    print(f"phase 16: {cards} card(s); (a)-(b) {MESH_PROCS} processes, "
          f"backend {backend}; (c) {SEQPAR_PROCS} processes, backend "
          f"{backend_c} [{smi}]")
    out = dict(cards=cards, backend=backend, backend_decode=backend_c,
               procs=MESH_PROCS, procs_decode=SEQPAR_PROCS)

    def holds(R):
        d = rank_mesh_size(R, MESH_PROCS)
        return [(i * (R // d), (i + 1) * (R // d)) for i in range(d)]

    # ---- (a), (b): the rank mesh ---------------------------------------
    R = SERVE_FLEET[0][0]
    snap_mesh = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    snap_fold = tempfile.mkdtemp(prefix="chip_smoke_fold_")
    try:
        t0 = time.perf_counter()
        want = one_device_fleet(seed, device, snap_fold, [holds(R)] + [
            holds(r) for r, _ in MESH_SHARDS])
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = mesh_mod.spawn(mesh_fleet_worker, MESH_PROCS, seed, snap_mesh,
                             snap_fold, backend=backend, timeout=900)
        spawn_s = time.perf_counter() - t0
        rounds = STEADY_ROUNDS
        card = device.type == "cuda"  # off the card the plain version runs
        check_mesh_fleet([dict(g["fleet"], rank=g["rank"]) for g in got],
                         want["fleet"], "(a) fleet")
        launches = [g["fleet"]["launches"] for g in got]
        if launches != [rounds if card and g["fleet"]["held"][1] >
                        g["fleet"]["held"][0] else 0 for g in got]:
            raise AssertionError(f"(a) fleet: heap-step launches by process "
                                 f"{launches}, expected {rounds} each")
        for (r, c), hs in zip(MESH_SHARDS, [holds(r) for r, _ in
                                            MESH_SHARDS]):
            w = want["shards"][r]
            for g in got:
                x = g["shards"][r]
                if x["resps"] != w["resps"]:
                    raise AssertionError(f"(a) ShardedHeap R={r}: process "
                                         f"{g['rank']}'s responses differ")
                lo, hi = x["held"]
                want_held = hs[g["rank"]] if g["rank"] < len(hs) else (0, 0)
                if (lo, hi) != want_held:
                    raise AssertionError(f"(a) R={r}: process {g['rank']} "
                                         f"holds [{lo}, {hi})")
                if hi > lo:
                    digests_equal(x["state"], w["state_rows"][(lo, hi)],
                                  f"(a) R={r} process {g['rank']}")
        ms = [1e3 * g["fleet"]["run_s"] / rounds for g in got]
        share = [g["fleet"]["gather_s"] / g["fleet"]["run_s"] for g in got]
        out["fleet"] = dict(launches=launches, ms_per_round=ms,
                            gather_share=share,
                            one_device_ms_per_round=1e3 * want["fleet_s"]
                            / rounds)
        print(f"(a) the paper's fleet (R={R} x C={SERVE_FLEET[0][1]} x "
              f"T={SERVE_FLEET[0][2]}, {rounds} rounds at {SERVE_RATE} "
              f"arrivals, least_loaded, fused) on a rank mesh of "
              f"{MESH_PROCS} processes == mesh=False in this process: every "
              f"process's report and fleet health, every response field "
              f"(latency_cyc and backend_cyc bitwise) and the state leaves "
              f"of the ranks it holds, residual {want['fleet']['report']['conservation_residual']}"
              f"; heap-step launches by process {launches}; ms a round by "
              f"process " + ", ".join(f"{x:.3f}" for x in ms) + " (one "
              f"device: " f"{out['fleet']['one_device_ms_per_round']:.3f}); "
              f"share in the response gather " + ", ".join(
                  f"{100 * x:.1f} %" for x in share)
              + f" [{where}; {smi}]")
        print("(a) ShardedHeap on the mesh == mesh=False, responses and "
              "state slices: " + "; ".join(
                  f"R={r} x C={c}, ranks held " + str(
                      [g["shards"][r]["held"] for g in got])
                  for r, c in MESH_SHARDS))
        # ---- (b) snapshots across the mesh -----------------------------
        chaos_r = want["chaos"]["report"]["rounds"]
        for key, n in (("chaos", chaos_r), ("restored", chaos_r - SNAP_ROUND)):
            check_mesh_fleet([dict(g[key], rank=g["rank"]) for g in got],
                             want["chaos"], f"(b) {key}")
            bad = [g["rank"] for g in got
                   if g[key]["launches"] != (n if card else 0)]
            if bad:
                raise AssertionError(f"(b) {key}: processes {bad} did not "
                                     f"launch the heap step {n} times")
        eng = mesh_chaos_engine(False, device).restore(snap_mesh)
        _, rep = eng.finish()
        if rep != want["chaos"]["report"]:
            raise AssertionError("(b) the mesh's snapshot finished on one "
                                 "device: report differs")
        digests_equal(resp_digests(eng._stacked()), want["chaos"]["resps"],
                      "(b) the mesh's snapshot finished on one device")
        for h, d in want["chaos"]["state_rows"].items():
            digests_equal(leaf_digests(eng.state, slice(*h)), d,
                          f"(b) mesh snapshot, ranks {h}")
        nbytes = sum(f.stat().st_size for f in Path(snap_mesh).rglob("*")
                     if f.is_file())
        rep = want["chaos"]["report"]
        print(f"(b) the chaos session ({chaos_r} rounds, kills "
              f"{[ev['core'] for ev in rep['kills']]}, "
              f"{len(rep['migrations'])} migrations) snapshotted at round "
              f"{SNAP_ROUND} on the mesh ({nbytes} B, written by process 0) "
              f"and finished on one device, and snapshotted on one device "
              f"and finished on the mesh: each == the uninterrupted run "
              f"(report, responses, state); heap-step launches by process "
              f"{[g['chaos']['launches'] for g in got]} and "
              f"{[g['restored']['launches'] for g in got]}")
        out.update(one_device_s=one_s, spawn_s=spawn_s, snapshot_bytes=nbytes)
        del eng, got, want
    finally:
        shutil.rmtree(snap_mesh, ignore_errors=True)
        shutil.rmtree(snap_fold, ignore_errors=True)

    # ---- (c) granite-3-8b decoded on a ("data", "model") mesh ---------------
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), attn_4d=False)
    t0 = time.perf_counter()
    params = registry.init(cfg, seed=seed, device=device)
    pa.paged_attention.launches = 0
    one = srv.serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    decode_steps=SEQPAR_STEPS, impl="kernel", seed=seed,
                    device=device, params=params)
    sync(device)
    one_pa = pa.paged_attention.launches
    one_ms = 1e3 * one.timings["decode_s"] / SEQPAR_STEPS
    serve_tokens = one.tokens.cpu()
    del one
    # the reference the mesh is held to: the same greedy decode on one
    # device through the kernel, each step's logits kept for its gaps
    prompts = registry.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    seed=seed, device=device)
    ref = seqpar_steps(dataclasses.replace(cfg, attend_impl="kernel"),
                       params, prompts, SEQPAR_STEPS, device, None)
    one_tokens = torch.stack([x.argmax(-1) for x in ref], 1).cpu()
    one_gaps = top2_gaps(ref, cfg.vocab)
    del params, prompts, ref
    L, B, S, steps = SEQPAR_CHECK
    fcfg = dataclasses.replace(configs.get(SERVE_ARCH), n_layers=L,
                               dtype="float32")
    one_fp32 = seqpar_fp32_logits(fcfg, seed, device, None)
    torch.cuda.empty_cache()
    one_c_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = mesh_mod.spawn(seqpar_worker, SEQPAR_PROCS, seed,
                         one_tokens[:, :SEQPAR_STEPS], backend=backend_c,
                         timeout=900)
    spawn_c_s = time.perf_counter() - t0
    P = -(-(SERVE_PROMPT + SEQPAR_STEPS + cfg.page_size) // cfg.page_size)
    errs, _ = near_tie_errors(serve_tokens, one_tokens, one_gaps,
                              "(c) one-device serve", free=True)
    forced_diff, free_diff = [], []
    for g in got:
        e, d = near_tie_errors(g["forced"], one_tokens, one_gaps,
                               f"(c) process {g['rank']} fed")
        errs += e
        forced_diff.append(d)
        e, d = near_tie_errors(g["tokens"], one_tokens, one_gaps,
                               f"(c) process {g['rank']} free", free=True)
        errs += e
        free_diff.append(d)
        if g["pa_launches"] or not g["finite"] or \
                g["pages"] != P // SEQPAR_PROCS:
            errs.append(f"(c) process {g['rank']}: {g['pa_launches']} "
                        f"paged-attention launches (want 0), finite "
                        f"{g['finite']}, {g['pages']} pages of {P}")
    if any(not torch.equal(g["tokens"], got[0]["tokens"]) for g in got):
        errs.append("(c) the processes' tokens differ")
    if errs:
        raise AssertionError("; ".join(errs))
    near = [(k, b, float(one_gaps[k, b])) for k in range(one_gaps.shape[0])
            for b in range(one_gaps.shape[1])
            if float(one_gaps[k, b]) < SEQPAR_BF16_GAP]
    worst, V, same = 0.0, cfg.vocab, True  # padded columns hold -1e30
    for g in got:
        for a, w in zip(g["fp32"], one_fp32):
            a, w = a[:, :V], w[:, :V]
            worst = max(worst, float((a - w).abs().max() / w.abs().max()))
            same &= torch.equal(a.argmax(-1), w.argmax(-1))
    if not worst <= SEQPAR_FP32_TOL:
        raise AssertionError(f"(c) fp32: max |mesh - one device| / max "
                             f"|logit| = {worst:.3g} > {SEQPAR_FP32_TOL}")
    if not same:
        raise AssertionError("(c) fp32: the mesh's greedy tokens differ")
    ms = [1e3 * g["timings"]["decode_s"] / SEQPAR_STEPS for g in got]
    share = [g["collective_s"] / g["timings"]["decode_s"] for g in got]
    n_tok = one_tokens.numel()
    out["decode"] = dict(ms_per_step=ms, one_device_ms_per_step=one_ms,
                         collective_share=share, near_ties=near,
                         forced_diff=forced_diff[0], free_diff=free_diff[0],
                         fp32_err=worst, one_device_pa_launches=one_pa,
                         peak_bytes=[g["peak"] for g in got],
                         one_device_s=one_c_s, spawn_s=spawn_c_s)
    print(f"(c) {SERVE_ARCH} at full width ({cfg.n_layers} layers, "
          f"{cfg.dtype}, flat attention weights from --seed on each "
          f"process), "
          f"{SERVE_BATCH} x {SERVE_PROMPT} prompt tokens, {SEQPAR_STEPS} "
          f"decode steps through launch.serve.serve(mesh=) on a (data=1, "
          f"model={SEQPAR_PROCS}) mesh, each process {P // SEQPAR_PROCS} of "
          f"{P} pages a sequence, 0 paged-attention launches; against the "
          f"one-device decode (paged-attention kernel, {one_pa} launches): "
          f"fed the same tokens, {n_tok - len(forced_diff[0])} of {n_tok} "
          f"greedy tokens equal, the others {forced_diff[0]} (request, "
          f"step) at near-ties; free-running, first differences "
          f"{free_diff[0] or 'none'}; (step, request, top-2 gap) below "
          f"{SEQPAR_BF16_GAP} of max |logit|: "
          + (", ".join(f"({k}, {b}, {x:.3g})" for k, b, x in near) or "none")
          + "; ms a step by process " + ", ".join(f"{x:.2f}" for x in ms)
          + f" (one device {one_ms:.2f}); share in the all-reduces "
          + ", ".join(f"{100 * x:.1f} %" for x in share)
          + f"; fp32 {L} layers (the config's attn_4d weights), B={B}, {S} "
          f"tokens, {steps} steps: max "
          f"|mesh - one device| / max |logit| {worst:.3g} (limit "
          f"{SEQPAR_FP32_TOL}), tokens equal [{where}; {smi}]")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 16 took {out['seconds']:.1f} s: (a)-(b) one device "
          f"{out['one_device_s']:.1f} s, spawned {out['spawn_s']:.1f} s; (c) "
          f"one device {one_c_s:.1f} s, spawned {spawn_c_s:.1f} s [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 17: training on a mesh of processes
MT_PROCS = 4            # the ("data"=2, "model"=2) mesh
MT_MESH = (2, 2)
MT_LAYERS = 2           # (a): granite-3-8b at full width, 2 of its 40 layers
MT_BATCH, MT_SEQ = 4, 512    # (a): global batch (4 x 1024 before phase
#                              15 (d))
MT_MICRO = 2            # (a): microbatches a step
MT_STEPS = 2            # (a): steps
MT_BF16_LOSS_TOL = 1e-3   # (a) bf16: |loss mesh - one device| / |loss|
MT_BF16_GNORM_TOL = 1e-2  # (a) bf16: the same for the gradient norm
MT_FP32 = (1, 4, 256, 1)  # (a) fp32 guard: layers, global batch,
#                           sequence, steps (one microbatch: the guard's
#                           cost is its weights' traffic, ~18 s a step
#                           through the host; the update's effect is held
#                           by the bf16 run's step 2 and by (c))
MT_FP32_LOSS_TOL = 1e-5   # (a) fp32: loss, relative
MT_FP32_GNORM_TOL = 1e-4  # (a) fp32: gradient norm, relative
MT_PSUM_N = 4096 * 4096   # (b): elements each process sums
MT_PSUM_TOL = 1e-6      # (b): max |sum - parent's| / max |parent's|
MT_DRILL = ["--arch", SERVE_ARCH, "--reduced", "--steps", "12", "--batch",
            "4", "--seq", "32", "--ckpt-every", "3", "--fail-at", "7"]
MT_LINE_TOL = 1e-4      # (c): the trainer's printed numbers, rel and abs
MT_RESTORE = (4, 2)     # (c): steps, the checkpoint restored (step 2)
MT_RESTORE_LOSS_TOL = 1e-5  # (c): a restored run's loss, relative
MT_RESTORE_PARAM_TOL = 5e-5  # (c): its parameters, absolute
# (a)'s comparisons use the trainer's optimizer settings (lr 1e-3 after a
# 10-step warm-up), so that step 2's loss reads step 1's update; (c) uses
# flat attention weights: under the reduced config's attn_4d init 12 Adam
# steps turn summation-order noise into another run (tests/test_torch_train)


def mt_opt(steps):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)


def mt_batches(vocab, B, S, n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out.append({"tokens": t, "labels": t.copy()})
    return out


def mt_cfg(layers, dtype):
    from repro_torch import configs
    return dataclasses.replace(configs.get(SERVE_ARCH), n_layers=layers,
                               dtype=dtype, attn_4d=False)


def mt_value(x):
    return float(x.full_tensor() if hasattr(x, "placements") else x)


def mt_run(cfg, batches, n_micro, device, mesh, seed, spent=None,
           record=None):
    """`steps` of `cfg` from `seed`'s weights over `batches`, on one device
    (mesh None) or on `mesh` (FSDP + TP by `param_specs(fsdp=True)`,
    grad_pspec); each step's (loss, gradient norm, ms, collective ms) and
    the local shapes of the parameters and of the first batch. With
    `record` (a step index) that step runs under the recorder
    (`trace_utils.record`) and the result's third item is its collectives
    (`mt_recorded`)."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    opt_cfg = mt_opt(len(batches))
    params = registry.init(cfg, seed=seed, device=device)
    opt = adamw.init(opt_cfg, params)
    pspec = None
    if mesh is not None:
        params, opt, pspec = sharding.place_state(mesh, params, opt,
                                                  fsdp=True)
        torch.cuda.empty_cache() if device.type == "cuda" else None
    step = steps_mod.make_train_step(cfg, opt_cfg, n_micro=n_micro,
                                     grad_pspec=pspec)
    rows, local, recorded = [], None, None
    for i, b in enumerate(batches):
        sync(device)
        t0, c0 = time.perf_counter(), spent() if spent else 0.0
        feed = (pipeline.to_device(b, device) if mesh is None
                else pipeline.shard_batch(mesh, b))
        if i == record:
            params, opt, m, recorded = mt_recorded(step, params, opt, feed,
                                                   mesh)
        else:
            params, opt, m = step(params, opt, feed)
        loss, gnorm = mt_value(m["loss"]), mt_value(m["grad_norm"])
        sync(device)
        rows.append((loss, gnorm, 1e3 * (time.perf_counter() - t0),
                     1e3 * ((spent() if spent else 0.0) - c0)))
        if mesh is not None and local is None:
            local = dict(params={k: tuple(v.to_local().shape) for k, v in
                                 named_leaves(params).items()},
                         batch={k: tuple(v.to_local().shape)
                                for k, v in feed.items()})
    return (rows, local) if record is None else (rows, local, recorded)


def mt_recorded(step, params, opt, feed, mesh):
    """(d): one mesh step under the recorder; returns its (params, opt,
    metrics) and its collectives: the whole schedule by mesh axis, the
    bytes by op and by axis, and the host-staged group's own count of
    the bytes its collectives wrote (`HostStagedGroup.moved_bytes`; None
    under another backend)."""
    import torch.distributed as dist
    from repro_torch.analysis import trace_utils
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.parallel.comm import HostStagedGroup
    staged = isinstance(dist.group.WORLD, HostStagedGroup)
    HostStagedGroup.moved_bytes = {}
    rec, (params, opt, m) = trace_utils.record(step, params, opt, feed,
                                               descend=False, dtensor=True)
    axes = mesh_axes(mesh)
    ana = op_analysis.analyze(rec, axes)
    return params, opt, m, dict(
        schedule=op_analysis.collective_schedule(rec, 1 << 30, axes),
        by_op=ana["collective_bytes_by_op"],
        by_axis=ana["collective_bytes_by_axis"],
        moved=dict(HostStagedGroup.moved_bytes) if staged else None)


def mt_collective_clock():
    """A reader of this process's seconds in collectives: the host-staged
    gloo group's counter (None under nccl, whose collectives are
    asynchronous)."""
    import torch.distributed as dist
    from repro_torch.parallel.comm import HostStagedGroup
    if not isinstance(dist.group.WORLD, HostStagedGroup):
        return None
    return lambda: HostStagedGroup.spent_s


def mt_restore_run(cfg, batches, device, mesh, ckpt_dir, seed):
    """(c): `run_with_recovery` over `batches` (one microbatch a step,
    a checkpoint every MT_RESTORE[1] steps) from `seed`'s weights placed on
    `mesh` by `param_specs(fsdp=True)` (None: one device); each step's
    loss, the final parameters on the host and the steps it ran."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.runtime import fault
    total, every = MT_RESTORE
    opt_cfg = mt_opt(total)
    params = registry.init(cfg, seed=seed, device=device)
    opt = adamw.init(opt_cfg, params)
    if mesh is not None:
        params, opt, _ = sharding.place_state(mesh, params, opt, fsdp=True)
    inner = steps_mod.make_train_step(cfg, opt_cfg)
    losses = {}

    def step(state, i, _):
        feed = (pipeline.to_device(batches[i], device) if mesh is None
                else pipeline.shard_batch(mesh, batches[i]))
        p, o, m = inner(*state, feed)
        losses[i] = mt_value(m["loss"])
        return (p, o), m

    (p, _), hist = fault.run_with_recovery(
        fault.TrainLoopConfig(total_steps=total, ckpt_every=every,
                              ckpt_dir=ckpt_dir),
        init_state=(params, opt), step_fn=step, make_batch=lambda i: i)
    whole = {k: (v.full_tensor() if hasattr(v, "placements") else v)
             .detach().float().cpu() for k, v in named_leaves(p).items()}
    return losses, whole, hist["steps"]


def mesh_train_worker(seed, psum_seed, drill_dir, restore_dir, backend):
    """Phase 17 on one process of the (2, 2) mesh: (a) the sharded step at
    full width in bf16 and the fp32 guard, (b) compressed_psum, (c)
    train.main on the (4, 1) mesh with --fail-at and the restore from
    (2, 2) onto (1, 2). Returns host objects."""
    import contextlib
    import io
    import os
    import shutil
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.optim import compression
    device = mesh_device()
    rank = dist.get_rank()
    mesh = mesh_mod.make_host_mesh(model=MT_MESH[1], live=True)
    clock = mt_collective_clock()
    out = dict(rank=rank, mesh=list(mesh.mesh.shape))
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    # ---- (a)
    cfg = mt_cfg(MT_LAYERS, "bfloat16")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out["bf16"], out["local"], out["recorded"] = mt_run(
        cfg, mt_batches(cfg.vocab, MT_BATCH, MT_SEQ, MT_STEPS, seed),
        MT_MICRO, device, mesh, seed, clock, record=MT_STEPS - 1)
    out["peak"] = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    L, B, S, n = MT_FP32
    fcfg = mt_cfg(L, "float32")
    out["fp32"], _ = mt_run(fcfg, mt_batches(fcfg.vocab, B, S, n, seed), 1,
                            device, mesh, seed)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # ---- (b)
    flat = init_device_mesh(mesh.device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
    g = torch.Generator(device=device).manual_seed(psum_seed + rank)
    x = torch.randn(MT_PSUM_N, generator=g, device=device)
    qs, scales, n = compression.gather_quantized(x, "data", flat)
    total = compression.compressed_psum(x, "data", flat)
    out["psum"] = dict(q=[host_digest(q) for q in qs],
                       scales=[host_digest(v) for v in scales], n=n,
                       sum_digest=host_digest(total),
                       sum=total.cpu() if rank == 0 else None)
    del x, qs, scales, total
    # ---- (c) the trainer, on the (4, 1) mesh
    get = configs.get
    configs.get = lambda name: dataclasses.replace(get(name), attn_4d=False)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            (tp, _), hist = train.main(MT_DRILL + [
                "--dist-backend", backend, "--ckpt-dir", drill_dir])
    finally:
        configs.get = get
    out["drill"] = dict(lines=buf.getvalue().splitlines(), hist=hist,
                        placements=sorted({str(p.placements) for p in
                                           named_leaves(tp).values()}))
    # ---- (c) the restore: (2, 2) -> (1, 2)
    rcfg = dataclasses.replace(get(SERVE_ARCH).reduced(), attn_4d=False)
    total, every = MT_RESTORE
    batches = mt_batches(rcfg.vocab, 4, 32, total, seed + 1)
    losses, whole, _ = mt_restore_run(rcfg, batches, device, mesh,
                                      f"{restore_dir}/whole", seed)
    out["whole"] = dict(losses=losses, params=whole if rank == 0 else None)
    if rank == 0:
        os.makedirs(f"{restore_dir}/sub")
        shutil.copytree(f"{restore_dir}/whole/step_{every:08d}",
                        f"{restore_dir}/sub/step_{every:08d}")
    sub = DeviceMesh(mesh.device_type, torch.tensor([[0, 1]]),
                     mesh_dim_names=("data", "model"))
    from repro_torch.parallel import comm
    comm.barrier()
    if rank < 2:
        losses, params, ran = mt_restore_run(rcfg, batches, device, sub,
                                             f"{restore_dir}/sub", seed)
        out["sub"] = dict(losses=losses, steps=ran,
                          params=params if rank == 0 else None)
    comm.barrier()
    return out


def mt_lines_equal(got, want, what):
    """The trainer's printed lines: the same words, numbers within
    MT_LINE_TOL (relative and absolute)."""
    import re
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
    keep = ("arch=", "step ", "done:", "latest checkpoint")
    # the watchdog's straggler count reads the host's clock
    slow = re.compile(r"\d+ straggler events")
    a = [slow.sub("#", x) for x in got if x.startswith(keep)]
    b = [slow.sub("#", x) for x in want if x.startswith(keep)]
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} lines, want {len(b)}")
    for x, y in zip(a, b):
        nx, ny = num.findall(x), num.findall(y)
        if num.sub("#", x) != num.sub("#", y) or any(
                abs(float(u) - float(v)) > MT_LINE_TOL * (1 + abs(float(v)))
                for u, v in zip(nx, ny)):
            raise AssertionError(f"{what}: {x!r} != {y!r}")
    return len(a)


def mt_want_local(cfg, mesh_shape):
    """Each parameter leaf's local shape on a process of the mesh, from
    its placement (`param_specs(fsdp=True)`): every dimension over the
    product of the axes it names."""
    from repro_torch.models import registry
    from repro_torch.parallel import sharding
    meta = registry.param_specs(cfg)
    specs = named_leaves(sharding.param_specs(mesh_shape, meta, fsdp=True))
    out = {}
    for k, t in named_leaves(meta).items():
        shape = list(t.shape)
        for d, axes in enumerate(specs[k]):
            for a in (() if axes is None else (axes,) if isinstance(
                    axes, str) else axes):
                shape[d] //= mesh_shape[a]
        out[k] = tuple(shape)
    return out


def phase_mesh_train(seed, device, smi):
    """Phase 17: (a) granite-3-8b at full width (MT_LAYERS layers, flat
    attention weights), FSDP + TP on a (data=2, model=2) mesh of
    MT_PROCS processes, grad_pspec, MT_MICRO microbatches, MT_STEPS steps
    at MT_BATCH x MT_SEQ == the same steps on one device (bf16 within
    MT_BF16_*, the fp32 guard within MT_FP32_*), every process holding the
    shards its placements imply; (b) compressed_psum over the processes ==
    each rank's quantization bit for bit, its sum within MT_PSUM_TOL of the
    parent's; (c) train.main on the (4, 1) mesh with --fail-at == the
    one-device trainer's lines, and a checkpoint saved on (2, 2) restored
    onto (1, 2) and onto one device, each continuing == the uninterrupted
    run; (d) each process's step 2 of (a), recorded, runs exactly the
    collectives of the dry-run of (a)'s cell on a fake (2, 2) world.
    Returns the result dict."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import compression
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "nccl" if cards >= MT_PROCS else "gloo"
    where = (f"{backend} on one card: collectives staged through the host, "
             f"not NVLink" if backend == "gloo" and cards <= 1 else backend)
    print(f"phase 17: {cards} card(s); {MT_PROCS} processes on a "
          f"(data={MT_MESH[0]}, model={MT_MESH[1]}) mesh, backend {backend}"
          f" [{smi}]")
    out = dict(cards=cards, backend=backend, procs=MT_PROCS)
    # ---- one device, in this process
    t0 = time.perf_counter()
    cfg = mt_cfg(MT_LAYERS, "bfloat16")
    one_bf16, _ = mt_run(cfg, mt_batches(cfg.vocab, MT_BATCH, MT_SEQ,
                                         MT_STEPS, seed), MT_MICRO, device,
                         None, seed)
    L, B, S, n = MT_FP32
    fcfg = mt_cfg(L, "float32")
    one_fp32, _ = mt_run(fcfg, mt_batches(fcfg.vocab, B, S, n, seed), 1,
                         device, None, seed)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    psum_seed = seed + 17
    parts = []
    for r in range(MT_PROCS):
        g = torch.Generator(device=device).manual_seed(psum_seed + r)
        parts.append(compression.quantize(torch.randn(
            MT_PSUM_N, generator=g, device=device)))
    want_q = [host_digest(q) for q, _, _ in parts]
    want_s = [host_digest(s) for _, s, _ in parts]
    want_sum = sum(compression.dequantize(q, s, n, (n,)).double()
                   for q, s, n in parts).cpu()
    del parts
    get = configs.get
    configs.get = lambda name: dataclasses.replace(get(name), attn_4d=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mt_")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train.main(MT_DRILL + ["--device", str(device), "--ckpt-dir",
                                   f"{tmp}/one_drill"])
        one_lines = buf.getvalue().splitlines()
        rcfg = dataclasses.replace(get(SERVE_ARCH).reduced(), attn_4d=False)
        one_s = time.perf_counter() - t0
        # ---- the spawn
        t0 = time.perf_counter()
        got = mesh_mod.spawn(mesh_train_worker, MT_PROCS, seed, psum_seed,
                             f"{tmp}/drill", f"{tmp}/restore", backend,
                             backend=backend, timeout=900)
        spawn_s = time.perf_counter() - t0
        # ---- (c) the restore onto one device, here
        total, every = MT_RESTORE
        import os
        os.makedirs(f"{tmp}/one")
        shutil.copytree(f"{tmp}/restore/whole/step_{every:08d}",
                        f"{tmp}/one/step_{every:08d}")
        one_restore = mt_restore_run(
            rcfg, mt_batches(rcfg.vocab, 4, 32, total, seed + 1), device,
            None, f"{tmp}/one", seed)
    finally:
        configs.get = get
        shutil.rmtree(tmp, ignore_errors=True)
    errs = []
    # ---- (a)
    want_local = mt_want_local(cfg, dict(zip(("data", "model"), MT_MESH)))
    whole_shapes = {k: tuple(v.shape) for k, v in
                    named_leaves(registry.param_specs(cfg)).items()}
    split = [k for k, v in want_local.items() if v != whole_shapes[k]]
    worst = dict(bf16_loss=0.0, bf16_gnorm=0.0, fp32_loss=0.0,
                 fp32_gnorm=0.0)
    for g in got:
        if g["local"]["params"] != want_local:
            bad = [k for k in want_local
                   if g["local"]["params"].get(k) != want_local[k]]
            errs.append(f"(a) process {g['rank']}: local shapes differ from "
                        f"the placements' on {bad}")
        if g["local"]["batch"] != {k: (MT_BATCH // MT_MESH[0], MT_SEQ)
                                   for k in ("tokens", "labels")}:
            errs.append(f"(a) process {g['rank']}: batch shard "
                        f"{g['local']['batch']}")
        for key, ref, lt, gt in (("bf16", one_bf16, MT_BF16_LOSS_TOL,
                                  MT_BF16_GNORM_TOL),
                                 ("fp32", one_fp32, MT_FP32_LOSS_TOL,
                                  MT_FP32_GNORM_TOL)):
            for i, (a, w) in enumerate(zip(g[key], ref)):
                el = abs(a[0] - w[0]) / abs(w[0])
                eg = abs(a[1] - w[1]) / abs(w[1])
                worst[f"{key}_loss"] = max(worst[f"{key}_loss"], el)
                worst[f"{key}_gnorm"] = max(worst[f"{key}_gnorm"], eg)
                if not (el <= lt and eg <= gt):
                    errs.append(f"(a) {key} process {g['rank']} step {i}: "
                                f"loss {a[0]:.6f} / {w[0]:.6f}, gnorm "
                                f"{a[1]:.5f} / {w[1]:.5f}")
    if not split:
        errs.append("(a) no leaf is split: the mesh holds whole weights")
    launched = {k: v for g in got for k, v in g["launches"].items() if v}
    if launched:
        errs.append(f"(a) the mesh step launched kernels {launched}: the "
                    f"reference trains through none")
    # ---- (b)
    psum_err = None
    for g in got:
        p = g["psum"]
        if p["q"] != want_q or p["scales"] != want_s or p["n"] != MT_PSUM_N:
            errs.append(f"(b) process {g['rank']}: the gathered payloads or "
                        f"scales != each rank's own quantization")
        if p["sum_digest"] != got[0]["psum"]["sum_digest"]:
            errs.append(f"(b) process {g['rank']}: its sum differs from "
                        f"process 0's")
    psum_err = float((got[0]["psum"]["sum"].double() - want_sum).abs().max()
                     / want_sum.abs().max())
    if not psum_err <= MT_PSUM_TOL:
        errs.append(f"(b) max |sum - parent's| / max |parent's| = "
                    f"{psum_err:.3g} > {MT_PSUM_TOL}")
    # ---- (c)
    d = got[0]["drill"]
    try:
        n_lines = mt_lines_equal(d["lines"], one_lines, "(c) train.main")
    except AssertionError as e:
        errs.append(str(e))
        n_lines = 0
    if d["hist"]["recoveries"] != 1 or d["hist"]["steps"] != list(range(12)):
        errs.append(f"(c) train.main history {d['hist']}")
    if d["placements"] != ["(Replicate(), Replicate())"]:
        errs.append(f"(c) train.main placed its state {d['placements']}")
    if any(g["drill"]["lines"] for g in got[1:]):
        errs.append("(c) a process other than 0 printed")
    whole = got[0]["whole"]
    tail = {k: v for k, v in whole["losses"].items() if k >= every + 1}
    restored = dict(one=one_restore, sub=(got[0]["sub"]["losses"],
                                          got[0]["sub"]["params"],
                                          got[0]["sub"]["steps"]))
    restore_err = {}
    for name, (losses, params, ran) in restored.items():
        if ran != list(range(every + 1, total)) or losses.keys() != \
                tail.keys():
            errs.append(f"(c) restored onto {name}: ran steps {ran}")
            continue
        el = max(abs(losses[k] - tail[k]) / abs(tail[k]) for k in tail)
        ep = max(float((params[k] - whole["params"][k]).abs().max())
                 for k in params)
        restore_err[name] = (el, ep)
        if not (el <= MT_RESTORE_LOSS_TOL and ep <= MT_RESTORE_PARAM_TOL):
            errs.append(f"(c) restored onto {name}: loss error {el:.3g}, "
                        f"parameter error {ep:.3g}")
    if got[1]["sub"]["losses"] != got[0]["sub"]["losses"]:
        errs.append("(c) the (1, 2) mesh's processes disagree")
    # ---- (d) the dry-run of (a)'s cell against process 0's step 2
    t0 = time.perf_counter()
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    dry, dry_sched, _ = dryrun.spmd_program(
        cfg, ShapeConfig("phase_17", MT_SEQ, MT_BATCH, "train"),
        dict(zip(("data", "model"), MT_MESH)), MT_MICRO, device,
        schedule_len=1 << 30)
    live = got[0]["recorded"]
    if live["schedule"] != dry_sched or \
            live["by_op"] != dry["collective_bytes_by_op"] or \
            live["by_axis"] != dry["collective_bytes_by_axis"]:
        key = [(e["op"], e["shape"], e["axis"], e["times"], e["bytes"])
               for e in live["schedule"]]
        want = [(e["op"], e["shape"], e["axis"], e["times"], e["bytes"])
                for e in dry_sched]
        errs.append(f"(d) process 0's step 2 ran collectives the dry-run "
                    f"does not: {sorted(set(key) - set(want))[:4]}; the "
                    f"dry-run's it did not run: "
                    f"{sorted(set(want) - set(key))[:4]}")
    if any(g["recorded"]["schedule"] != live["schedule"] for g in got[1:]):
        errs.append("(d) the processes ran different collectives")
    dry_s = time.perf_counter() - t0
    if errs:
        raise AssertionError("; ".join(errs))
    ms = [[r[2] for r in g["bf16"]] for g in got]
    share = [[r[3] / r[2] for r in g["bf16"]] for g in got]
    out.update(
        bf16=[g["bf16"] for g in got], fp32=[g["fp32"] for g in got],
        one_bf16=one_bf16, one_fp32=one_fp32, worst=worst,
        peak_bytes=[g["peak"] for g in got], psum_err=psum_err,
        restore_err=restore_err, one_device_s=one_s, spawn_s=spawn_s)
    print(f"(a) {SERVE_ARCH} at full width ({MT_LAYERS} layers, bf16, flat "
          f"attention weights from --seed), FSDP + TP by "
          f"named(param_specs(fsdp=True)) on a (data={MT_MESH[0]}, "
          f"model={MT_MESH[1]}) mesh of {MT_PROCS} processes, grad_pspec, "
          f"{MT_MICRO} microbatches, {MT_STEPS} steps at {MT_BATCH} x "
          f"{MT_SEQ}: each process holds the shards its placements imply "
          f"({len(split)} of {len(want_local)} leaves split), 0 launches of "
          f"the five kernels; against one "
          f"device: loss {worst['bf16_loss']:.3g} (limit "
          f"{MT_BF16_LOSS_TOL}), gnorm {worst['bf16_gnorm']:.3g} (limit "
          f"{MT_BF16_GNORM_TOL}) relative; ms a step by process (step 1 "
          f"warm) " + ", ".join(f"{x[-1]:.1f}" for x in ms)
          + f" (one device {one_bf16[-1][2]:.1f}); share in collectives "
          + (", ".join(f"{100 * x[-1]:.1f} %" for x in share)
             if got[0]["bf16"][-1][3] else "not measured")
          + "; peak memory by process " + ", ".join(
              f"{g['peak'] / 1e9:.2f} GB" for g in got)
          + f"; fp32 guard ({L} layer, {B} x {S}, {n} step): loss "
          f"{worst['fp32_loss']:.3g} (limit {MT_FP32_LOSS_TOL}), gnorm "
          f"{worst['fp32_gnorm']:.3g} (limit {MT_FP32_GNORM_TOL}) "
          f"[{where}; {smi}]")
    print(f"(b) compressed_psum of {MT_PSUM_N} fp32 over the {MT_PROCS} "
          f"processes: the gathered int8 payloads and scales == each "
          f"rank's own quantization bit for bit; the sum == on every "
          f"process, max |sum - parent's| / max |parent's| {psum_err:.3g} "
          f"(limit {MT_PSUM_TOL})")
    print(f"(c) train.main {' '.join(MT_DRILL)} on the ({MT_PROCS}, 1) mesh "
          f"(state replicated, shard_batch): {n_lines} lines == the one-"
          f"device trainer's (numbers within {MT_LINE_TOL}), 1 recovery; a "
          f"checkpoint saved on (2, 2) at step {every} restored onto (1, 2) "
          f"and onto one device: (loss, parameter) error " + ", ".join(
              f"{k} ({v[0]:.3g}, {v[1]:.3g})" for k, v in
              restore_err.items()) + f" (limits {MT_RESTORE_LOSS_TOL}, "
          f"{MT_RESTORE_PARAM_TOL})")
    moved = live["moved"]
    print(f"(d) process 0's step 2, recorded: {len(dry_sched)} kinds of "
          f"collective, {sum(e['times'] for e in dry_sched)} calls, == the "
          f"dry-run of the same cell on a fake (2, 2) {device.type!r} world "
          f"(every op, result shape, axis, count and byte; every process "
          f"the same): by op " + ", ".join(
              f"{k} {v / 1e9:.4f}" for k, v in
              dry["collective_bytes_by_op"].items())
          + " GB; by axis " + ", ".join(
              f"{k} {v / 1e9:.4f}" for k, v in
              dry["collective_bytes_by_axis"].items())
          + " GB; the host-staged group's own count of the bytes it wrote "
          + ("not kept (another backend)" if moved is None else ", ".join(
              f"{k} {v / 1e9:.4f}" for k, v in moved.items()) + " GB")
          + f"; the dry-run took {dry_s:.1f} s [{smi}]")
    out.update(dry=dry, dry_schedule=dry_sched, recorded=live, dry_s=dry_s)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['seconds']:.1f} s: one device {one_s:.1f} "
          f"s, spawned {spawn_s:.1f} s, (d) {dry_s:.1f} s [{smi}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write results as JSON")
    args = ap.parse_args(argv)

    # the caching allocator's segments grow in place: phase 14 (b) trains
    # paligemma-3b whole in ~62 GB, and with fixed segments its AdamW
    # update found 18 GB reserved but unallocated and ran out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    t_main = time.perf_counter()

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
    # the committed tapes' replay reports, {tape: {kind: report}}: phase 4's
    # fused ones, 5b's scan kinds', 5c's; 5d's re-recordings reuse them
    tape_reports = {name: {"fused": rep}
                    for name, rep in result.pop("fused_reports").items()}
    scan_result = phase_scan(args.seed, device, tape_reports, smi=smi)

    # ---- 5c: region frontends, sanitizer, sharded tier ---------------------
    region_result = phase_regions(args.seed, device, smi,
                                  tape_reports=tape_reports)

    # ---- 5d: the workload generators and the decode-serving engine --------
    from repro_torch.graphupd.workload import GraphConfig
    workload_result = phase_workloads(device, smi, tape_reports,
                                      graph=GraphConfig(**WL_GRAPH))

    # ---- 5e: the closed-loop and elastic serving tiers ---------------------
    fleet_result = phase_fleet_serve(device, smi)

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

    # ---- 11: the training path at full width -------------------------------
    train_result = phase_train(args.seed, device, smi)

    # ---- 12: the moe, vlm and audio families served at full width ----------
    family_result, entries = phase_families(args.seed, device)
    kernels += entries

    # ---- 13: the recurrent families served and trained at full width -------
    # the examples phase 14 (c) holds against the CPU, and its longest card
    # run, start after its timed steps: they overlap 13 (a) and 14 (a)
    recurrent_result, procs = phase_recurrent(args.seed, device, smi)
    try:
        # ---- 15: the analysis tooling, beside the examples (times nothing
        # on the card) --------------------------------------------------------
        analysis_result = phase_analysis(args.seed, device, smi,
                                         train_result["full"])
        # ---- 14: the moe, vlm and audio families trained; the examples ----
        family_train_result = phase_train_families(args.seed, device, smi,
                                                   procs)
    finally:
        stop_examples(procs)

    # ---- 16: the heap fleet and seqpar decode across processes -------------
    mesh_result = phase_mesh(args.seed, device, smi)

    # ---- 17: training on a mesh of processes -------------------------------
    mesh_train_result = phase_mesh_train(args.seed, device, smi)
    print(f"chip_smoke took {time.perf_counter() - t_main:.1f} s [{smi}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, scan=scan_result, regions=region_result,
                           workloads=workload_result,
                           fleet_serve=fleet_result, serve=serve_result,
                           build_s=secs,
                           paged_vs_plain=worst, buddy=buddy_result,
                           freelist=fl_result, flash=fa_result,
                           train=train_result, families=family_result,
                           recurrent=recurrent_result,
                           family_train=family_train_result,
                           analysis=analysis_result, mesh=mesh_result,
                           mesh_train=mesh_train_result,
                           gpu=smi,
                           kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
