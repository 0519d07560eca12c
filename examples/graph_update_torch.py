"""Dynamic graph updates, the paper's case study (Section 6.2 / Fig 16), on
the PyTorch port.

    PYTHONPATH=src python examples/graph_update_torch.py [--device cpu] \
        [--nodes 384] [--edges-pre 4000] [--edges-new 2000]

The port of examples/graph_update.py: static CSR against linked-list
adjacency on every registered allocator kind. The dynamic structure is
functionally real (pointers into an allocator-managed heap); throughput
comes from the DPU cost model. Kind ``fused`` (the reference's ``pallas``)
runs the hand-written heap-step kernel on the card, one launch a round.
The sizes default to the paper's partition (`GraphConfig()`).

It runs on the card unless ``--device cpu`` is given, and raises without a
GPU. The last line counts the heap-step kernel's launches (0 on the CPU).
"""
import argparse

from repro_torch import device as _device
from repro_torch.graphupd.workload import GraphConfig, compare_all
from repro_torch.kernels import heap_step


def main(argv=None):
    base = GraphConfig()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=base.n_nodes)
    ap.add_argument("--edges-pre", type=int, default=base.n_edges_pre)
    ap.add_argument("--edges-new", type=int, default=base.n_edges_new)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    heap_step.fused_heap_step.launches = 0

    cfg = GraphConfig(n_nodes=args.nodes, n_edges_pre=args.edges_pre,
                      n_edges_new=args.edges_new)
    print(f"partition: {cfg.n_nodes} nodes, {cfg.n_edges_pre} pre-edges, "
          f"{cfg.n_edges_new} new edges (1:2, paper methodology)\n")
    res = compare_all(cfg, device=dev)
    st = res["static_csr"]["us_per_edge"]
    print(f"{'structure':22s} {'us/edge':>9s} {'edges/s':>12s} {'vs static':>10s}")
    for name, v in res.items():
        speed = st / v["us_per_edge"]
        print(f"{name:22s} {v['us_per_edge']:9.3f} {v['edges_per_s']:12.0f} "
              f"{speed:9.1f}x")
    sw, hw = res["sw"], res["hwsw"]
    fr = sw["frontend_ops"] / (sw["frontend_ops"] + sw["backend_ops"])
    print(f"\nfrontend service rate (PIM-malloc-SW): {fr:.1%} (paper: >90%)")
    if sw["dram_bytes"]:
        red = 1 - hw["dram_bytes"] / sw["dram_bytes"]
        print(f"metadata DRAM traffic reduction HW/SW vs SW: {red:.0%} "
              "(paper: 33%)")
    print(f"heap-step kernel launches: {heap_step.fused_heap_step.launches}")
    return res


if __name__ == "__main__":
    main()
