"""DecodeServe demo on the PyTorch port: paged-KV LLM decode through the
PIM-malloc fleet.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu] \
        [--ranks 2] [--cores 2] [--threads 4] [--rounds 64] [--rate 1.5] \
        [--tenants 8] [--max-context 576] [--placement least_loaded] \
        [--kind fused] [--seed 0] [--smoke] [--export-trace PATH]

The port of examples/serve_decode.py. Plans a multi-tenant
continuous-batching decode session (Poisson session arrivals, Zipf tenant
popularity, prefill bursts, one KV page per page-boundary token, eviction
on completion or context overflow), runs it as a loop of fleet heap steps
on the device, and prints the coupled report: tokens/sec + TTFT next to
allocator percentiles, per-rank heap high-water marks and the conservation
residual. ``--export-trace`` writes the Zipf-head tenant's home-core slice
as a ``pim-malloc-trace/v1`` tape (replayable with ``python -m
repro_torch.workloads.replay``).

The kind defaults to ``fused`` (the reference's ``pallas``; the reference
example's default is ``sw``): one launch of the hand-written heap-step
kernel a round on the card. The reference's ``--mesh`` (a rank mesh) has
no counterpart on one device. It runs on the card unless ``--device cpu``
is given, and raises without a GPU. The last line counts the heap-step
kernel's launches (0 on the CPU).
"""
import argparse

from repro_torch import device as _device
from repro_torch.core import system as sysm
from repro_torch.kernels import heap_step
from repro_torch.launch.serve_decode import DecodeServe, DecodeTraffic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cores", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--rate", type=float, default=1.5,
                    help="mean new sessions per round (Poisson)")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--max-context", type=int, default=576)
    ap.add_argument("--queue-cap", type=int, default=16)
    ap.add_argument("--placement", default="least_loaded",
                    choices=("chunked", "round_robin", "least_loaded"))
    ap.add_argument("--kind", default="fused",
                    choices=("strawman", "sw", "hwsw", "sanitizer",
                             "fused"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny deterministic session (CI decode-smoke)")
    ap.add_argument("--export-trace", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    heap_step.fused_heap_step.launches = 0

    if args.smoke:
        args.rounds, args.rate, args.threads = 24, 1.0, 4

    cfg = sysm.SystemConfig(kind=args.kind, heap_bytes=1 << 20,
                            num_threads=args.threads)
    traffic = DecodeTraffic(seed=args.seed, rounds=args.rounds,
                            session_rate=args.rate,
                            num_tenants=args.tenants,
                            max_context=args.max_context,
                            queue_cap=args.queue_cap)
    engine = DecodeServe(cfg, args.ranks, args.cores, traffic=traffic,
                         placement=args.placement, device=dev)
    plan, rep = engine.serve()

    R, C, T = plan.shape
    print(f"fleet [{R} ranks x {C} cores x {T} threads] kind={args.kind} "
          f"placement={args.placement} mesh=False")
    print(f"sessions: offered={rep['sessions_offered']} "
          f"dropped={rep['sessions_dropped']} "
          f"prefilled={rep['sessions_prefilled']} "
          f"completed={rep['sessions_completed']} "
          f"overflow={rep['sessions_evicted_overflow']} "
          f"active_end={rep['sessions_active_end']}")
    print(f"tokens: prefill={rep['prefill_tokens']} "
          f"decode={rep['decode_tokens']} "
          f"-> {rep['tokens_per_sec']:.0f} tok/s (modeled)  "
          f"stalls={rep['decode_stalls']}")
    print(f"TTFT cyc: p50={rep['ttft_p50_cyc']:.0f} "
          f"p95={rep['ttft_p95_cyc']:.0f} p99={rep['ttft_p99_cyc']:.0f}")
    print(f"alloc cyc: p50={rep['alloc_p50_cyc']:.0f} "
          f"p95={rep['alloc_p95_cyc']:.0f} "
          f"p99={rep['alloc_p99_cyc']:.0f}  "
          f"us/op={rep['us_per_op']:.3f}  "
          f"({rep['prefill_allocs']} prefills + "
          f"{rep['decode_page_allocs']} pages + "
          f"{rep['evict_frees']} frees)")
    print(f"heap: live={rep['live_bytes']}B "
          f"hwm/rank={rep['hwm_bytes_per_rank']} "
          f"frag={rep['external_frag_mean']:.3f} "
          f"failed_allocs={rep['failed_allocs']} "
          f"dropped_frees={rep['dropped_frees']} "
          f"conservation_residual={rep['conservation_residual']}")
    assert rep["conservation_residual"] == 0

    toks = rep["decode_tokens_per_round"]
    peak = max(max(toks), 1)
    for r0 in range(0, len(toks), max(len(toks) // 12, 1)):
        bar = "#" * int(toks[r0] / peak * 40)
        print(f"  round {r0:4d} tokens {toks[r0]:4d} |{bar}")

    if args.export_trace:
        rank, core = plan.tenant_home.get(0, (0, 0))
        tr = engine.trace(plan, rank, core)
        tr.save(args.export_trace)
        print(f"wrote rank{rank}/core{core} tape ({tr.ops} ops) -> "
              f"{args.export_trace}")
    print(f"heap-step kernel launches: {heap_step.fused_heap_step.launches}")
    return rep


if __name__ == "__main__":
    main()
