"""The representative PIM workload scenarios, recorded as tapes.

The port of `repro.workloads.scenarios`. Each scenario rebuilds an
allocation-heavy application over the heap API and records every protocol
round through a `RecordingAllocator` (see `repro_torch.workloads.trace`):

  * ``graph_churn``: dynamic graph insertion/deletion
    (`repro_torch.graphupd.workload.DynamicGraph`): streaming edge inserts
    (pimMalloc of 16 B node cells) interleaved with edge deletions (unlink
    + pimFree).
  * ``kv_paged``: paged-KV serving churn (`repro_torch.kvcache.PagePool`):
    sequence prefills reserve page extents, decode steps grow single pages
    through the thread-cache frontend, context growth reallocs extents,
    and finished sequences free everything back.
  * ``hashtable``: open-addressing KV store
    (`repro_torch.workloads.hashtable`): per-thread tables with
    pimCalloc'd backing arrays, per-insert value cells, and grow-rehash
    `realloc` pressure across size classes into buddy bypass range.
  * ``decode_serve``: the busiest core's slice of a `DecodeServe` session
    (`repro_torch.launch.serve_decode`), exported through
    `ScanEngine.trace`.

Scenarios are seeded and, at their smoke sizes, reproduce the committed
tapes of ``benchmarks/tapes/`` byte for byte through `Trace.save`. Each
records on the reference's design point ``hwsw`` unless ``kind`` says
otherwise (``fused`` runs the heap-step kernel once per round), on
`device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np

from ..graphupd.workload import DynamicGraph, GraphConfig, synth_edges
from ..kvcache.paged import PAGE_UNIT, PagePool
from .hashtable import HashTableConfig, HashTableWorkload
from .trace import RecordingAllocator, Trace

RECORD_KIND = "hwsw"   # the paper's winning design point records the tapes


def record_graph_churn(smoke: bool = True, kind: str = RECORD_KIND,
                       device="cuda") -> Trace:
    """Dynamic graph: build a partition, then stream insert/delete rounds."""
    # heap must cover the 16-thread x 8-class x 4 KB prepopulation (512 KB)
    gcfg = GraphConfig(n_nodes=64, n_edges_pre=160, n_edges_new=96,
                       num_threads=16, heap_bytes=1 << 20, seed=3)
    if not smoke:
        gcfg = GraphConfig(n_nodes=192, n_edges_pre=1200, n_edges_new=600,
                           num_threads=16, heap_bytes=1 << 21, seed=3)
    rec = RecordingAllocator(heap_bytes=gcfg.heap_bytes,
                             num_threads=gcfg.num_threads, kind=kind,
                             device=device)
    g = DynamicGraph(gcfg, client=rec)
    pre_s, pre_d, new_s, new_d = synth_edges(gcfg)
    T = gcfg.num_threads
    rng = np.random.default_rng(gcfg.seed)
    inserted = list(zip(pre_s.tolist(), pre_d.tolist()))
    for i in range(0, len(pre_s), T):
        g.insert_round(pre_s[i:i + T], pre_d[i:i + T])
    # churn: every other new-edge round is followed by a deletion round
    # over randomly chosen existing edges
    for i in range(0, len(new_s), T):
        g.insert_round(new_s[i:i + T], new_d[i:i + T])
        inserted.extend(zip(new_s[i:i + T].tolist(),
                            new_d[i:i + T].tolist()))
        if (i // T) % 2 == 1 and inserted:
            take = [inserted.pop(rng.integers(len(inserted)))
                    for _ in range(min(T, len(inserted)))]
            g.delete_round([u for u, _ in take], [v for _, v in take])
    return rec.finish(
        "graph_churn",
        "dynamic graph insertion/deletion over the PIM-malloc heap "
        "(loc-gowalla-style partition, paper Section 6.2 + deletions)",
        meta={"n_nodes": gcfg.n_nodes, "edges_inserted":
              int(len(pre_s) + len(new_s)), "live_edges": len(inserted)})


def record_kv_paged(smoke: bool = True, kind: str = RECORD_KIND,
                    device="cuda") -> Trace:
    """Paged-KV serving churn: prefill extents, decode growth, eviction."""
    T = 16
    n_pages = 1 << 16 if smoke else 1 << 18   # heap >= 512 KB prepopulation
    steps = 24 if smoke else 96
    rec = RecordingAllocator(heap_bytes=n_pages * PAGE_UNIT,
                             num_threads=T, kind=kind, device=device)
    pool = PagePool(n_pages=n_pages, num_threads=T, client=rec)
    rng = np.random.default_rng(11)

    # one serving slot per thread: each holds (extent_first, extent_pages,
    # decode_pages). Prefill lengths mix frontend classes and buddy bypass.
    extent_choices = (4, 8, 16, 64, 512)   # pages; 512 pages = 8 KB bypass
    slots = []
    for t in range(T):
        n = int(rng.choice(extent_choices))
        ext = pool.alloc_pages(n, thread=t)
        if ext.shape[0] != n:
            raise RuntimeError(f"prefill extent of {n} pages failed")
        slots.append({"first": int(ext[0]), "pages": n, "decode": []})

    for step in range(steps):
        # decode growth: ~2/3 of the sequences gain one page this round
        growing = rng.random(T) < 0.66
        pages, _ = pool.alloc_page_batch(growing)
        pages = pages.cpu().numpy()
        for t in range(T):
            p = int(pages[t])
            if growing[t] and p >= 0:
                slots[t]["decode"].append(p)
        # occasional context growth: realloc one extent to twice the pages
        if step % 6 == 3:
            t = int(rng.integers(T))
            ids, moved = pool.grow_extent(slots[t]["first"],
                                          slots[t]["pages"] * 2, thread=t)
            if ids.shape[0]:
                slots[t].update(first=int(ids[0]),
                                pages=slots[t]["pages"] * 2)
        # eviction: a finished sequence frees ALL its decode pages, then
        # its extent, through the protocol (PagePool.evict), and a fresh
        # sequence prefills into the vacated slot
        if step % 4 == 2:
            t = int(rng.integers(T))
            pool.evict(slots[t]["first"], slots[t]["decode"], thread=t)
            n = int(rng.choice(extent_choices))
            ext = pool.alloc_pages(n, thread=t)
            slots[t] = {"first": int(ext[0]) if ext.shape[0] else -1,
                        "pages": n if ext.shape[0] else 0, "decode": []}
    return rec.finish(
        "kv_paged",
        "paged-KV serving churn: prefill extents + single-page decode "
        "growth + extent realloc + sequence eviction (PagePool)",
        meta={"n_pages": n_pages, "steps": steps})


def record_hashtable(smoke: bool = True, kind: str = RECORD_KIND,
                     device="cuda") -> Trace:
    """Open-addressing KV store with grow-rehash realloc pressure."""
    cfg = HashTableConfig(num_threads=16, heap_bytes=1 << 19,
                          n_inserts=40 if smoke else 256,
                          delete_every=5, seed=7)
    rec = RecordingAllocator(heap_bytes=cfg.heap_bytes,
                             num_threads=cfg.num_threads, kind=kind,
                             device=device)
    wl = HashTableWorkload(cfg, rec)
    stats = wl.run()
    wl.verify()
    return rec.finish(
        "hashtable",
        "open-addressing hash-table/KV-store: calloc'd tables, per-insert "
        "value cells, grow-rehash realloc across size classes",
        meta=stats)


def record_decode_serve(smoke: bool = True, kind: str = RECORD_KIND,
                        device="cuda") -> Trace:
    """The busiest core's slice of a DecodeServe session (paged-KV LLM
    decode: Zipf tenants, prefill bursts, page-per-token appends,
    eviction), exported through `ScanEngine.trace`: the serving engine's
    page traffic is a standard tape (the planner alone makes it)."""
    from ..core import system as sysm
    from ..launch.serve_decode import DecodeServe, DecodeTraffic

    T = 4 if smoke else 16
    cfg = sysm.SystemConfig(kind=kind, heap_bytes=1 << 20, num_threads=T)
    tc = DecodeTraffic(seed=29, rounds=24 if smoke else 96,
                       session_rate=1.5 if smoke else 6.0, num_tenants=8,
                       queue_cap=16)
    eng = DecodeServe(cfg, 2, 2, traffic=tc, mesh=False, device=device)
    plan = eng.plan()
    # the Zipf head tenant's home is the hottest heap in the fleet
    rank, core = plan.tenant_home.get(0, (0, 0))
    return eng.trace(plan, rank, core, name="decode_serve")


SCENARIOS = {
    "graph_churn": record_graph_churn,
    "kv_paged": record_kv_paged,
    "hashtable": record_hashtable,
    "decode_serve": record_decode_serve,
}
