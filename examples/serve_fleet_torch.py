"""FleetServe demo on the PyTorch port: steady-state multi-tenant traffic
over the PIM fleet.

    PYTHONPATH=src python examples/serve_fleet_torch.py [--device cpu] \
        [--ranks 2] [--cores 2] [--threads 4] [--rounds 48] [--rate 12] \
        [--placement round_robin|least_loaded|chunked] [--kind fused] \
        [--seed 0] [--queue-cap 64] [--export-trace PATH] [--chaos]

The port of examples/serve_fleet.py. Plans a Poisson/Zipf tenant session,
drives it through the round loop (fleet heap steps, one a round, on the
device), and prints the serving report: admission / backpressure
counters, end-to-end latency percentiles in modeled DPU cycles,
queue-depth trace, and the fleet cost accounting. ``--export-trace``
writes rank 0 / core 0's slice as a ``pim-malloc-trace/v1`` tape
replayable with ``python -m repro_torch.workloads.replay``.

``--chaos`` serves the same session through `ElasticFleetServe` instead:
a seed-derived `FaultPlan` (core kill, one-round stall, dropped round)
plus heap-pressure tenant migration, with the extra elastic counters
(migrations, kills, pressure checks) appended to the report. The chaos
session still pins dropped_frees == 0 and conservation_residual == 0.

The kind defaults to ``fused`` (the reference's ``pallas``; the reference
example's default is ``sw``): one launch of the hand-written heap-step
kernel a round on the card. It runs on the card unless ``--device cpu`` is
given, and raises without a GPU. The last line counts the heap-step
kernel's launches (0 on the CPU).
"""
import argparse

from repro_torch import device as _device
from repro_torch.core import system as sysm
from repro_torch.kernels import heap_step
from repro_torch.launch.elastic import (ElasticFleetServe, FaultPlan,
                                        MigrationConfig)
from repro_torch.launch.serve_fleet import FleetServe, TrafficConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cores", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=48)
    ap.add_argument("--rate", type=float, default=12.0,
                    help="mean external arrivals per round (Poisson)")
    ap.add_argument("--placement", default="round_robin",
                    choices=("chunked", "round_robin", "least_loaded"))
    ap.add_argument("--kind", default="fused",
                    choices=("strawman", "sw", "hwsw", "fused"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queue-cap", type=int, default=64)
    ap.add_argument("--tenants", type=int, default=16)
    ap.add_argument("--export-trace", default=None, metavar="PATH")
    ap.add_argument("--chaos", action="store_true",
                    help="elastic session: seed-derived fault plan + "
                         "heap-pressure tenant migration")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    heap_step.fused_heap_step.launches = 0

    cfg = sysm.SystemConfig(kind=args.kind, heap_bytes=1 << 19,
                            num_threads=args.threads)
    traffic = TrafficConfig(seed=args.seed, rounds=args.rounds,
                            arrival_rate=args.rate, num_tenants=args.tenants,
                            queue_cap=args.queue_cap)
    if args.chaos:
        faults = FaultPlan.generate(seed=args.seed + 1, rounds=args.rounds,
                                    shape=(args.ranks, args.cores,
                                           args.threads))
        engine = ElasticFleetServe(
            cfg, args.ranks, args.cores, traffic=traffic,
            placement=args.placement, faults=faults,
            migration=MigrationConfig(ratio=1.3, min_bytes=1 << 10,
                                      drain="interval", check_rounds=8),
            device=dev)
    else:
        engine = FleetServe(cfg, args.ranks, args.cores, traffic=traffic,
                            placement=args.placement, device=dev)
    plan, rep = engine.serve()

    R, C, T = plan.shape
    print(f"fleet [{R} ranks x {C} cores x {T} threads] kind={args.kind} "
          f"placement={args.placement} capacity={rep['capacity_per_round']}/round")
    print(f"offered={rep['offered']} dropped={rep['dropped']} "
          f"(drop_rate={rep['drop_rate']:.2f}) "
          f"dispatched={rep['external_dispatched']} external "
          f"+ {rep['expiry_frees_dispatched']} expiry frees "
          f"backlog_end={rep['backlog_end']}")
    print(f"latency e2e cyc: p50={rep['e2e_p50_cyc']:.0f} "
          f"p95={rep['e2e_p95_cyc']:.0f} p99={rep['e2e_p99_cyc']:.0f}  "
          f"service p99={rep['service_p99_cyc']:.0f}  "
          f"us/op={rep['us_per_op']:.3f}")
    print(f"queue depth mean={rep['queue_depth_mean']:.1f} "
          f"max={rep['queue_depth_max']}  modeled wall "
          f"{rep['modeled_wall_us']:.0f}us  "
          f"{rep['ops_per_sec']:.0f} ops/s")
    print(f"heap: live={rep['live_bytes']}B failed_allocs="
          f"{rep['failed_allocs']} dropped_frees={rep['dropped_frees']} "
          f"conservation_residual={rep['conservation_residual']}")
    print("per-rank ops:", rep["accounting"]["per_rank"]["ops"])
    if args.chaos:
        faults = ", ".join(f"r{ev['round']} {ev['kind']}"
                           + (f"@({ev['rank']},{ev['core']})"
                              if ev["kind"] != "drop" else "")
                           for ev in rep["faults"]) or "none"
        print(f"chaos: faults=[{faults}] kills={len(rep['kills'])} "
              f"migrations={len(rep['migrations'])} "
              f"(+{rep['migration_ops_dispatched']} migration ops) "
              f"killed_cores={rep['killed_cores']}")
        for ev in rep["migrations"]:
            src = tuple(ev["src"]) if ev["src"] else "?"
            print(f"  round {ev['round']:4d} migrate tenant {ev['tenant']} "
                  f"{src} -> {tuple(ev['dst'])} ({ev['bytes']}B live)")
    depths = rep["queue_depth"]
    peak = max(max(depths), 1)
    for r0 in range(0, len(depths), max(len(depths) // 12, 1)):
        bar = "#" * int(depths[r0] / peak * 40)
        print(f"  round {r0:4d} queue {depths[r0]:4d} |{bar}")

    if args.export_trace:
        tr = engine.trace(plan, 0, 0)
        tr.save(args.export_trace)
        print(f"wrote rank0/core0 tape ({tr.ops} ops) -> "
              f"{args.export_trace}")
    print(f"heap-step kernel launches: {heap_step.fused_heap_step.launches}")
    return rep


if __name__ == "__main__":
    main()
