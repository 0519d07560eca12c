"""Dynamic graph updates (paper Section 6.2): static CSR against a dynamic
array-of-linked-lists built on PIM-malloc.

The port of `repro.graphupd.workload`. A loc-gowalla-scale graph is
partitioned across PIM cores (node hashing); edges are sampled 1:2 into
(new : pre-existing). The pre-existing part builds the initial structure;
the new edges stream in as per-round batches (one edge per hardware
thread). One core's partition is simulated and costed with the DPU model:

  static CSR    : each insert shifts the EdgeIdx suffix and rewrites
                  NodePtr: DMA traffic ~ half the partition per insert
                  (the paper's Fig 3(c) size dependence).
  dynamic       : pimMalloc(16 B) node {dst, next}, two MRAM writes and a
                  head-pointer update: O(1) whatever the graph's size.

The dynamic structure is real: node cells live in a heap array on the
allocator's device, addressed by the allocator's pointers, and
`neighbors` walks the linked lists.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import api, cost_model, heap as heap_api

NODE_BYTES = 16  # one edge cell: dst (4B) + next (4B) + padding to size class


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    n_nodes: int = 384          # per-core partition (loc-gowalla/512 cores)
    n_edges_pre: int = 4000     # ~1.9M directed edges / 512 cores
    n_edges_new: int = 2000     # 1:2 new:existing (paper methodology)
    num_threads: int = 16
    heap_bytes: int = 1 << 21
    seed: int = 0


def synth_edges(cfg: GraphConfig):
    """Power-law-ish synthetic partition (loc-gowalla-like degree skew):
    (pre src, pre dst, new src, new dst) int64 host arrays."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_nodes
    w = 1.0 / np.arange(1, n + 1) ** 0.8      # Zipf-weighted endpoints
    p = w / w.sum()
    total = cfg.n_edges_pre + cfg.n_edges_new
    src = rng.choice(n, size=total, p=p)
    dst = rng.choice(n, size=total, p=p)
    return (src[:cfg.n_edges_pre], dst[:cfg.n_edges_pre],
            src[cfg.n_edges_pre:], dst[cfg.n_edges_pre:])


# --------------------------------------------------------------- static CSR
def static_update_cost_us(cfg: GraphConfig, dpu: cost_model.DPUCost = None):
    """Per-round latency series for batched CSR rebuild (no allocator).

    A round applies up to T inserts by rewriting the partition's EdgeIdx
    and NodePtr arrays once (sorted merge): the best-case static strategy,
    still O(partition size) per round. Returns (per_round_us array,
    us_per_edge). Host arithmetic; the DMA cost in float32, as the
    reference computes it."""
    dpu = dpu or cost_model.DPUCost()
    m = cfg.n_edges_pre
    T = cfg.num_threads
    lat = []
    total = cfg.n_edges_new
    done = 0
    while done < total:
        k = min(T, total - done)
        edge_bytes = (m + done) * 4
        nodeptr_bytes = cfg.n_nodes * 4
        moved = 2 * (edge_bytes + nodeptr_bytes)   # read + write both arrays
        cyc = float(cost_model.mram_access_cyc(dpu, torch.tensor(moved)))
        cyc += 120.0 * k                            # per-edge locate/merge
        lat.append(cyc / dpu.freq_hz * 1e6)
        done += k
    lat = np.asarray(lat)
    return lat, float(lat.sum() / total)


# ------------------------------------------------- dynamic (PIM-malloc heap)
class DynamicGraph:
    """Array-of-linked-lists adjacency on a PIM-malloc heap (one core).

    Every allocation round goes through one `repro_torch.core.api
    .HeapClient`, so the whole workload, insertion and deletion, is
    recordable as an `AllocRequest` tape: pass a
    `repro_torch.workloads.trace.RecordingAllocator` as ``client``. The
    node cells and list heads live on the client's device (the card
    unless ``device="cpu"``, or the given client's)."""

    def __init__(self, cfg: GraphConfig, kind: str = "sw", client=None,
                 alloc=None, device="cuda"):
        """``alloc`` is the deprecated injection hook (bare Allocator-style
        handles); it warns and is adapted via `HeapClient.wrap`. Pass
        ``client=`` instead."""
        self.cfg = cfg
        if alloc is not None:
            import warnings
            warnings.warn(
                "DynamicGraph(alloc=...) is deprecated: pass client="
                "HeapClient (or any HeapClient subclass); bare handles are "
                "adapted via HeapClient.wrap for now",
                DeprecationWarning, stacklevel=2)
            if client is not None:
                raise TypeError("pass either client= or (deprecated) alloc=")
            client = api.HeapClient.wrap(alloc)
        if client is None:
            client = api.Allocator(
                heap_bytes=cfg.heap_bytes, num_threads=cfg.num_threads,
                kind=kind, device=device)
        self.client = client
        self.alloc = client   # the old name: callers read g.alloc.last_info
        self.sys_cfg = client.cfg
        dev = client.device
        self.head = torch.full((cfg.n_nodes,), -1, dtype=torch.int32,
                               device=dev)
        self.heap = torch.zeros((cfg.heap_bytes // 4,), dtype=torch.int32,
                                device=dev)

    @property
    def state(self):
        return self.alloc.state

    def _insert(self, ptrs, srcs, dsts):
        """The serial pointer splice of one round, in thread order, as one
        batch: thread t's cell links to the cell of the last earlier thread
        that inserted at the same node this round (else the old head), and
        a node's new head is its last inserting thread's cell. Failed
        allocations (ptr < 0) write nothing."""
        T = ptrs.shape[0]
        t = torch.arange(T, device=ptrs.device)
        ok = ptrs >= 0
        same = (srcs[:, None] == srcs[None, :]) & ok[None, :]
        prev = torch.where(same & (t[None, :] < t[:, None]), t[None, :],
                           -1).amax(1)
        nxt = torch.where(prev >= 0, ptrs[prev.clamp(min=0)],
                          self.head[srcs.long()])
        w = torch.clamp(torch.div(ptrs, 4, rounding_mode="floor"),
                        min=0).long()
        self.heap[w[ok]] = dsts[ok]                                  # dst
        self.heap[w[ok] + 1] = nxt[ok]                               # next
        last = ok & ~(same & (t[None, :] > t[:, None])).any(1)
        self.head[srcs[last].long()] = ptrs[last]

    def insert_round(self, srcs, dsts):
        """One batched round: up to T edges. Returns the AllocResponse."""
        T = self.cfg.num_threads
        n = len(srcs)
        sizes = torch.where(torch.arange(T) < n, NODE_BYTES, 0).to(
            torch.int32)
        info = self.alloc.request(heap_api.malloc_request(sizes))
        dev = self.heap.device
        srcs = torch.as_tensor(np.pad(np.asarray(srcs), (0, T - n)),
                               dtype=torch.int32, device=dev)
        dsts = torch.as_tensor(np.pad(np.asarray(dsts), (0, T - n)),
                               dtype=torch.int32, device=dev)
        self._insert(info.ptr.to(dev), srcs, dsts)
        return info

    def delete_round(self, srcs, dsts):
        """Remove up to T edges (u, v): unlink the first matching cell from
        u's list and pimFree its node cell, through a host mirror of the
        cells. Returns the AllocResponse (a miss, edge not present, frees
        nothing on that thread slot)."""
        T = self.cfg.num_threads
        if len(srcs) > T:
            raise ValueError(f"{len(srcs)} deletions > {T} threads")
        dev = self.heap.device
        heap_np = self.heap.cpu().numpy().copy()
        head_np = self.head.cpu().numpy().copy()
        free_ptrs = np.full((T,), -1, np.int32)
        for t, (u, v) in enumerate(zip(srcs, dsts)):
            u, v = int(u), int(v)
            prev = -1
            ptr = int(head_np[u])
            while ptr >= 0:
                w = ptr // 4
                if int(heap_np[w]) == v:          # unlink this cell
                    nxt = int(heap_np[w + 1])
                    if prev < 0:
                        head_np[u] = nxt
                    else:
                        heap_np[prev // 4 + 1] = nxt
                    free_ptrs[t] = ptr
                    break
                prev, ptr = ptr, int(heap_np[w + 1])
        self.heap = torch.from_numpy(heap_np).to(dev)
        self.head = torch.from_numpy(head_np).to(dev)
        return self.alloc.request(heap_api.free_request(
            torch.from_numpy(free_ptrs)))

    def neighbors(self, u: int):
        """Walk u's linked list (host side; tests and verification)."""
        out = []
        heap = self.heap.cpu().numpy()
        ptr = int(self.head[u])
        while ptr >= 0 and len(out) <= self.cfg.heap_bytes:
            w = ptr // 4
            out.append(int(heap[w]))
            ptr = int(heap[w + 1])
        return out


def run_dynamic(cfg: GraphConfig, kind: str, device="cuda"):
    """Build the pre-update graph (untimed), then stream and time the new
    edges. Returns (graph, per-round AllocResponse list, per_round_us,
    us/edge).

    Round latency = max over active threads (threads run concurrently; the
    mutex queue is inside the cost model) + the serialized splice cost."""
    g = DynamicGraph(cfg, kind=kind, device=device)
    pre_src, pre_dst, new_src, new_dst = synth_edges(cfg)
    T = cfg.num_threads
    dpu = g.sys_cfg.dpu
    for i in range(0, len(pre_src), T):            # untimed pre-build
        g.insert_round(pre_src[i:i + T], pre_dst[i:i + T])
    lat_rounds = []
    infos = []
    for i in range(0, len(new_src), T):
        info = g.insert_round(new_src[i:i + T], new_dst[i:i + T])
        # 'Run' phase per edge: node-cell MRAM write (DMA) + head update
        splice_cyc = 140.0
        path, lat = (x.cpu().numpy() for x in (info.path, info.latency_cyc))
        active = path >= 0
        lat = lat + splice_cyc
        lat_rounds.append(float(lat[active].max()) if active.any() else 0.0)
        infos.append(info)
    per_round_us = np.asarray(lat_rounds) / dpu.freq_hz * 1e6
    per_edge_us = float(np.sum(lat_rounds) / max(len(new_src), 1)
                        / dpu.freq_hz * 1e6)
    return g, infos, per_round_us, per_edge_us


def compare_all(cfg: GraphConfig = GraphConfig(), device="cuda"):
    """Fig 16(a)-style comparison over every registered kind. Returns
    {"static_csr" or kind: per-edge us, throughput, and for the kinds the
    mean allocation us, metadata DRAM bytes and frontend / backend op
    counts}; the port's ``fused`` stands where the reference says
    ``pallas``."""
    out = {}
    _, us_static = static_update_cost_us(cfg)
    out["static_csr"] = {
        "us_per_edge": us_static,
        "edges_per_s": 1e6 / us_static,
    }
    for kind in heap_api.kinds():
        g, infos, per_round, us = run_dynamic(cfg, kind, device=device)
        path, lat, dram = (torch.stack([getattr(i, f) for i in infos])
                           .cpu().numpy()
                           for f in ("path", "latency_cyc", "dram_bytes"))
        alloc_us = float(np.mean([lat[r][path[r] >= 0].mean()
                                  for r in range(len(infos))])) / 350e6 * 1e6
        out[kind] = {
            "us_per_edge": us,
            "edges_per_s": 1e6 / us if us > 0 else float("inf"),
            "alloc_us_mean": alloc_us,
            "dram_bytes": int(np.sum([d.sum() for d in dram])),
            "frontend_ops": int(np.sum([np.sum(p == 0) for p in path])),
            "backend_ops": int(np.sum([np.isin(p, (1, 2)).sum()
                                       for p in path])),
        }
    return out
