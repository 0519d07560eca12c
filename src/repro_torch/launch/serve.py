"""Paged-KV serving: PIM-malloc page allocation + batched decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_8b \\
        --reduced --device cpu --batch 2 --prompt-len 16 --decode-steps 8

The port of `repro.launch.serve`. It shows the paper's allocator as the
serving substrate:

  * prefill allocates each request's page extent through a `PagePool`
    (the reference's default kind ``sw``: plain PyTorch rounds on the
    card), a frontend hit at these sizes;
  * per-token page growth is served by the thread-cache frontend when any
    sequence crosses a page boundary;
  * attention consumes the page tables (``--impl kernel``: the
    paged-attention kernel on the card; ``--impl ref``: the plain
    batched gather);
  * with ``--fleet-ranks R``, decode-time page growth routes through a
    `ShardedHeap` fleet of R single-core page heaps (`make_fleet_pool`):
    sequence b lands on rank b % R, and the run reports the
    `FleetRouter`'s per-rank cost accounting.

Every family with a paged KV cache is served: dense, moe, vlm (a patch
prefix of ``n_patches`` positions before the text) and audio (an encoder
over ``enc_frames`` stub frames, whose K/V the cache holds densely); and
the hybrid, whose cache is its recurrent states and a rolling window of
K/V (no page table: the pool still hands out each request's extent and
its decode-time pages, as in the reference); ssm is refused, as in the
reference. The stub frontends' embeddings come from
`registry.make_frontends` unless the caller passes them.

One deviation from the reference: it sizes the cache for ``prompt +
decode_steps + page`` positions, without the vlm's patch prefix, so a
prefix longer than a page makes its prefill write past the cache
(paligemma-3b: 256 patches and a 32-token prompt need 3 pages of 128, it
reserves 2). The port counts the prefix: ``n_patches + prompt +
decode_steps + page`` (ROADMAP C).

Across processes (``mesh=``, a ``("data", "model")`` `DeviceMesh`):
every process holds the weights whole and allocates every request's
pages from its own pool (the same ids on every process); the batch
splits over ``"data"`` where it divides evenly, the physical pages over
``"model"``, and the decode takes `paged.write_attend_seqpar`; the
fleet's ranks (``fleet_ranks``) split over the processes as the rank
mesh of `make_fleet_pool`. The tokens and logits come back whole on
every process.

`serve` is the entry point a program calls; `main` parses the reference's
flags plus ``--device``, ``--seed``, ``--no-reduced`` for full width and
``--dist-backend``: under ``torchrun`` it joins the process group with
that backend (``nccl`` needs a card per process; ``gloo`` lets the
processes share one) and serves on a ``1 x world`` mesh.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --dist-backend gloo --no-reduced --batch 8 --prompt-len 512
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import configs
from .. import device as _device
from ..core import heap as heap_api
from ..core import system as sysm
from ..kvcache import paged
from ..models import registry
from ..models.config import ArchConfig
from ..parallel import comm
from . import mesh as _mesh
from .fleet import FleetRouter


@dataclasses.dataclass
class ServeResult:
    """What one `serve` run produced.

    tokens: greedy tokens int64 [B, decode_steps + 1] (the prefill's, then
      one per decode step); prompt: the (page-padded) text prompt [B, S];
      frontends: the stub frontends' embeddings the prefill took
      (``patch_embeds`` / ``enc_embeds``; empty for dense and moe);
    logits: the last step's logits [B, V]; logits_finite: whether every
      step's logits were finite; page_ids: each request's prefill extent,
      int32 [B, P]; stats / prefill_stats: the pool's
      allocator counters at the end and after the extents;
    pool_kind: the pool's heap kind; pool_rounds: allocator rounds the
      pool served (one heap step each);
    page_allocs: decode-time page allocations; alloc_us: their modeled DPU
      time; timings: host-clock seconds (``prefill_s``, ``decode_s``,
      ``sync_s``, the part of the decode loop spent waiting to read the
      sequence lengths back, and ``pool_s``, the pool rounds' own time,
      each ending in a synchronise: the prefill extents before
      ``prefill_s`` starts, the decode pages inside ``decode_s``);
      cache / params: the final cache and the parameters, for
      inspection; fleet_stats: with ``fleet_ranks``, the `FleetRouter`'s
      accounting of the decode-time pages it served (else None)."""

    tokens: torch.Tensor
    prompt: torch.Tensor
    logits: torch.Tensor
    logits_finite: bool
    page_ids: torch.Tensor
    stats: dict
    prefill_stats: dict
    pool_kind: str
    pool_rounds: int
    page_allocs: int
    alloc_us: float
    timings: dict
    cache: dict
    params: dict
    fleet_stats: dict = None
    frontends: dict = None


def make_fleet_pool(num_ranks: int, n_pages: int, num_threads: int = 16,
                    kind: str = "sw", device="cuda", mesh=None) -> FleetRouter:
    """A FleetRouter over R single-core page-heap ranks (the serving
    fleet), on `device` (the card unless the caller asks for the CPU).

    Each rank owns an independent page heap of `n_pages`; page ids are
    rank-local, mirroring one PagePool per device shard. ``mesh`` is the
    `ShardedHeap`'s: the rank mesh over the process group by default, as
    in the reference (one device without a group)."""
    cfg = sysm.SystemConfig(kind=kind, heap_bytes=n_pages * paged.PAGE_UNIT,
                            num_threads=num_threads)
    return FleetRouter(heap_api.ShardedHeap(cfg, num_ranks=num_ranks,
                                            num_cores=1, mesh=mesh,
                                            device=device))


def fleet_page_request(router: FleetRouter, need) -> heap_api.AllocRequest:
    """One fleet round allocating a page for every sequence b with
    need[b], on rank b % R (thread slot b // R of that rank), on the
    router's device."""
    R, C, T = router.shape
    size = np.zeros((R, C, T), np.int32)
    for b in np.nonzero(np.asarray(need))[0]:
        rank, slot = int(b) % R, int(b) // R
        if slot >= C * T:
            raise ValueError(f"sequence {b} exceeds fleet thread capacity "
                             f"{router.capacity} ({R}x{C}x{T})")
        size[rank, slot // T, slot % T] = paged.PAGE_UNIT
    return heap_api.malloc_request(
        torch.from_numpy(size).to(router.heap.device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _whole_batch(mesh, x: torch.Tensor, batch: int) -> torch.Tensor:
    """This process's rows of a batch tensor, whole: gathered over the
    mesh's ``"data"`` axis where `paged.batch_rows` split it."""
    rows = paged.batch_rows(mesh, batch)
    if rows.stop - rows.start == batch:
        return x
    return torch.cat(comm.all_gather(x, group=mesh.get_group("data")))


def serve(cfg: ArchConfig, *, batch: int, prompt_len: int,
          decode_steps: int, impl: str = "kernel", seed: int = 0,
          device="cuda", params=None, tokens=None, frontends=None,
          fleet_ranks: int = 0, mesh=None) -> ServeResult:
    """Serve `batch` requests of `prompt_len` tokens for `decode_steps`
    greedy decode steps, on `device` (the card unless the caller asks for
    the CPU; raises without a GPU).

    With `fleet_ranks` R > 0 the decode-time pages come from a fleet of R
    page heaps (`make_fleet_pool`, `fleet_page_request`), which serves
    up to R x 16 sequences; without it one pool serves up to its 16
    hardware threads.

    `params` (a `registry.init` tree), `tokens` (int [batch,
    prompt_len], the text) and `frontends` (`registry.make_frontends`'
    dict) default to ones made from `seed`. The prompt is padded with
    zeros so that the prefill (the vlm's patch prefix included) covers a
    whole number of pages, as the reference pads it.

    With `mesh` (a ``("data", "model")`` `DeviceMesh` of processes, every
    one of which calls `serve` alike) each process decodes its batch rows
    over its slice of the pages (module docstring); the result's tokens
    and logits are whole, its cache this process's."""
    dev = _device.resolve(device)
    if cfg.family == "ssm":
        raise ValueError("ssm decode has no paged KV cache to serve")
    cfg = dataclasses.replace(cfg, attend_impl=impl)
    mod = registry.get_module(cfg)
    B, S = batch, prompt_len
    page = cfg.page_size
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    max_seq = prefix + S + decode_steps + page
    P = paged.pages_per_seq(max_seq, page)

    # ---- PIM-malloc page pool: one extent per request ---------------------
    # floor: the hierarchy needs headroom beyond thread-cache prepopulation
    n_pages = max(1 << (B * P - 1).bit_length(), 1 << 16)
    pool = paged.PagePool(n_pages=n_pages, device=dev)
    T = pool.cfg.num_threads
    router = (make_fleet_pool(fleet_ranks, n_pages, num_threads=T,
                              device=dev,
                              mesh=None if mesh is not None else False)
              if fleet_ranks else None)
    if router is None and B > T:
        raise ValueError(f"batch {B} exceeds the single pool's {T} hardware "
                         f"threads; pass fleet_ranks to scale page "
                         f"allocation")
    if router is not None and B > router.capacity:
        raise ValueError(f"batch {B} exceeds the fleet's {router.capacity} "
                         f"hardware threads; raise fleet_ranks")
    rows = []
    t0 = time.perf_counter()
    for b in range(B):
        pages = pool.alloc_pages(P, thread=b % T)
        if pages.shape[0] != P:
            raise RuntimeError(f"page pool exhausted at request {b}")
        rows.append(pages)
    _sync(dev)
    pool_s = time.perf_counter() - t0
    pool_rounds = B
    prefill_stats = pool.stats

    if params is None:
        params = registry.init(cfg, seed=seed, device=dev)
    # the hybrid's cache has no pages to split: its rows are all it splits
    on_mesh = {} if mesh is None or cfg.family == "hybrid" else {"mesh": mesh}
    mine = paged.batch_rows(mesh, B)
    cache = mod.init_cache(cfg, mine.stop - mine.start, max_seq, device=dev,
                           **on_mesh)
    page_ids = torch.stack(rows)
    if "page_table" in cache:
        # per-sequence page tables are slot indices into the sequence's
        # own pool; the pool's ids map through modulo the extent
        cache["page_table"] = (page_ids[mine] % P).to(torch.int32)

    if tokens is None:
        tokens = registry.make_prompts(cfg, B, S, seed=seed, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    if tuple(tokens.shape) != (B, S):
        raise ValueError(f"tokens {tuple(tokens.shape)} != (batch, "
                         f"prompt_len) = {(B, S)}")
    pad = (-(prefix + S)) % page
    if pad:  # page-align the prompt for prefill
        tokens = torch.nn.functional.pad(tokens, (0, pad))
    if frontends is None:
        frontends = registry.make_frontends(cfg, B, seed=seed, device=dev)
    frontends = {k: torch.as_tensor(v, device=dev)
                 for k, v in frontends.items()}

    _sync(dev)
    t0 = time.perf_counter()
    feed = {k: v[mine] for k, v in {"tokens": tokens, **frontends}.items()}
    cache, logits = mod.prefill(cfg, params, feed, cache, **on_mesh)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks = torch.argmax(logits, dim=-1)[:, None]
    out = [toks]
    finite = torch.isfinite(logits).all()  # every step's, kept on the device
    page_allocs, alloc_cyc, sync_s = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        # a fresh page from the frontend when any sequence crosses a page
        # boundary (the paper's fast path, Fig 9 case 1); reading the
        # lengths back waits for the previous step, as in the reference
        ts = time.perf_counter()
        pos = _whole_batch(mesh, cache["seq_lens"], B).cpu().numpy()
        sync_s += time.perf_counter() - ts
        need = (pos % page) == 0
        if need.any():
            tp = time.perf_counter()
            if router is not None:
                resp = router.route(fleet_page_request(router, need))
            else:
                _, resp = pool.alloc_page_batch(np.pad(need, (0, T - B)))
            _sync(dev)
            pool_s += time.perf_counter() - tp
            pool_rounds += 1
            page_allocs += int(need.sum())
            alloc_cyc += float(resp.latency_cyc.max())
        cache, logits = mod.decode(cfg, params, cache, {"tokens": toks},
                                   **on_mesh)
        toks = torch.argmax(logits, dim=-1)[:, None]
        out.append(toks)
        finite &= torch.isfinite(logits).all()
    _sync(dev)
    decode_s = time.perf_counter() - t0

    return ServeResult(
        tokens=_whole_batch(mesh, torch.cat(out, dim=1), B), prompt=tokens,
        logits=_whole_batch(mesh, logits, B),
        logits_finite=bool(finite), page_ids=page_ids, stats=pool.stats,
        prefill_stats=prefill_stats, pool_kind=pool.client.kind,
        pool_rounds=pool_rounds, page_allocs=page_allocs,
        alloc_us=alloc_cyc / pool.client.cfg.dpu.freq_hz * 1e6,
        timings={"prefill_s": prefill_s, "decode_s": decode_s,
                 "sync_s": sync_s, "pool_s": pool_s},
        cache=cache, params=params,
        fleet_stats=None if router is None else router.stats,
        frontends=frontends)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="smoke-test widths (the default, as "
                    "in the reference); --no-reduced for full width")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=48)
    ap.add_argument("--impl", default="kernel", choices=["kernel", "ref"])
    ap.add_argument("--fleet-ranks", type=int, default=0,
                    help="route decode page growth through a ShardedHeap "
                         "fleet of this many ranks (0 = single PagePool)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-backend", default="nccl", choices=_mesh.BACKENDS,
                    help="under torchrun: the process group's backend "
                         "(nccl needs a card per process; gloo lets them "
                         "share one)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh, joined = None, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        joined = not torch.distributed.is_initialized()
        _mesh.init_world(args.dist_backend)
        mesh = _mesh.make_host_mesh(model=torch.distributed.get_world_size(),
                                    live=True)
    try:
        res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    decode_steps=args.decode_steps, impl=args.impl,
                    seed=args.seed, device=args.device,
                    fleet_ranks=args.fleet_ranks, mesh=mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    if mesh is not None and int(os.environ.get("RANK", "0")):
        return res  # every process holds the same result: one prints it
    B, S = res.prompt.shape
    dev = res.logits.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("allocator stats after prefill extents:", res.prefill_stats)
    front = ", ".join(f"{k} {tuple(v.shape)}"
                      for k, v in res.frontends.items())
    print(f"prefill {B}x{S}" + (f" ({front})" if front else "")
          + f": {res.timings['prefill_s']:.2f}s")
    total = args.decode_steps * B
    dt = res.timings["decode_s"]
    print(f"decode: {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, "
          f"{where}, {args.impl})" + (
              "" if mesh is None else
              f" on a {'x'.join(map(str, mesh.shape))} (data, model) mesh "
              f"of processes, {args.dist_backend}"))
    print(f"frontend page allocations during decode: {res.page_allocs} "
          f"({res.alloc_us:.2f} us modeled DPU time)")
    print("final allocator stats:", res.stats)
    if res.fleet_stats is not None:
        st = res.fleet_stats
        print(f"fleet ({args.fleet_ranks} ranks): {st['rounds']} rounds, "
              f"{st['ops']} page allocs, {st['us_per_op']:.3f} us/op, "
              f"per-rank ops={st['per_rank']['ops']}")
    return res


if __name__ == "__main__":
    main()
