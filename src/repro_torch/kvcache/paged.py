"""Paged KV cache backed by PIM-malloc: the paper's allocator as the
serving substrate.

Layout: **per-sequence page pools**

    k_pages [L, B, P, page, KVH, hd]

Each sequence owns a reserved extent of P physical pages (what the buddy
backend hands out at prefill); the page table indirects logical ->
physical *within* that extent, and single-page decode growth is served by
the thread-cache frontend.

`attend(impl="kernel")` flattens the per-sequence pools into the shared
pool the paged-attention kernel takes (``[B*P, page, KVH, hd]`` views with
global page ids ``b*P + pt``); `attend(impl="ref")` is the batched-gather
plain version. Both compute the same function.

The port of `repro.kvcache.paged`, with one difference of contract: the
reference's writers are functional, the port's **write into the pages
they are given, in place** (`write_prefill`, `write_token`). At
granite-3-8b's full width one layer's K and V pools hold ~25 MB; copying
them per layer per decode step would move gigabytes per step for a write
of 4 KiB.

Sequence parallelism (`write_attend_seqpar`, the reference's
``shard_map`` flash-decoding): on a `DeviceMesh` of processes with a
``"model"`` axis, each process holds the pools' slice of the **physical**
page axis for its model index (``[B, P / model, ...]``; page ids stay
global in the page table) and its batch rows (split over ``"data"`` where
it divides the batch, `batch_rows`). A process writes the new token only
into a page it owns, attends over its own pages with an fp32 online-
softmax partial, and the partials combine with one MAX and one SUM
all-reduce over ``"model"`` (`repro_torch.parallel.comm`). Without such a
mesh it is `write_token` then `attend`, on one device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from ..core import api
from ..core.heap import AllocResponse
from ..kernels.paged_attention import paged_attention
from ..parallel import comm

PAGE_UNIT = 16  # allocator bytes per page (smallest size class)


def pages_per_seq(max_seq: int, page_size: int) -> int:
    return math.ceil(max_seq / page_size)


def cache_spec(*, n_layers: int, batch: int, max_seq: int, page_size: int,
               kv_heads: int, head_dim: int, dtype) -> dict:
    """{name: (shape, dtype)} of the paged cache (nothing allocated)."""
    P = pages_per_seq(max_seq, page_size)
    pool = (n_layers, batch, P, page_size, kv_heads, head_dim)
    return {
        "k_pages": (pool, dtype),
        "v_pages": (pool, dtype),
        "page_table": ((batch, P), torch.int32),
        "seq_lens": ((batch,), torch.int32),
    }


def model_axis(mesh):
    """(group, index, size) of this process on `mesh`'s ``"model"`` axis;
    None without a mesh or without that axis."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    return (mesh.get_group("model"), mesh.get_local_rank("model"),
            mesh.size(mesh.mesh_dim_names.index("model")))


def batch_rows(mesh, batch: int) -> slice:
    """This process's rows of a `batch`: split over the mesh's ``"data"``
    axis where its size divides the batch (the reference's ``dpb``), all
    of them otherwise or without a mesh."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return slice(0, batch)
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    if batch % n:
        return slice(0, batch)
    i = mesh.get_local_rank("data")
    return slice(i * batch // n, (i + 1) * batch // n)


def local_pages(mesh, n_pages: int) -> tuple[int, int]:
    """(first physical page, page count) of this process's slice of a
    pool of `n_pages` on the mesh's ``"model"`` axis; (0, n_pages)
    without one. Raises unless the axis divides the pages."""
    ax = model_axis(mesh)
    if ax is None:
        return 0, n_pages
    _, i, m = ax
    if n_pages % m:
        raise ValueError(f"{n_pages} pages a sequence do not split over "
                         f"model={m}")
    return i * (n_pages // m), n_pages // m


def init_cache(*, n_layers: int, batch: int, max_seq: int, page_size: int,
               kv_heads: int, head_dim: int, dtype, device="cuda",
               mesh=None) -> dict:
    """Zero cache with the identity page table (contiguous buddy extent),
    on `device` (the card unless the caller asks for the CPU). `batch` is
    the rows this process holds; with a `mesh` that has a ``"model"`` axis
    the pools hold only this process's physical pages (`local_pages`),
    the page table all P of them."""
    dev = _device.resolve(device)
    spec = cache_spec(n_layers=n_layers, batch=batch, max_seq=max_seq,
                      page_size=page_size, kv_heads=kv_heads,
                      head_dim=head_dim, dtype=dtype)
    P = spec["page_table"][0][1]
    _, n_local = local_pages(mesh, P)
    for k in ("k_pages", "v_pages"):
        shape, dt = spec[k]
        spec[k] = (shape[:2] + (n_local,) + shape[3:], dt)
    cache = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in spec.items()}
    cache["page_table"] = torch.arange(
        P, dtype=torch.int32, device=dev).expand(batch, P).contiguous()
    return cache


def write_prefill(pages, kv, page_table, mesh=None):
    """Write a prompt's K or V into its pages, **in place**.

    pages [B, P, page, KVH, hd]; kv [B, S, KVH, hd] with S % page == 0;
    page_table int32 [B, P] (ids clamped to [0, P)). With a `mesh` that
    has a ``"model"`` axis, `pages` is this process's slice of the
    physical pages (`local_pages`) and only the prompt pages that fall in
    it are written. Returns `pages`."""
    B, P, page_size, KVH, hd = pages.shape
    S = kv.shape[1]
    if S % page_size:
        raise ValueError(f"prompt length {S} is not a multiple of the page "
                         f"size {page_size}")
    sp = S // page_size
    kv4 = kv.reshape(B, sp, page_size, KVH, hd).to(pages.dtype)
    bidx = torch.arange(B, device=pages.device)[:, None]
    if model_axis(mesh) is None:
        idx = page_table[:, :sp].long().clamp(0, P - 1)
        pages[bidx, idx] = kv4
        return pages
    # each local page's prompt page (the inverse page table), so that no
    # shape hangs on the data: a fake tensor, which has none, runs it too
    Pn = page_table.shape[1]
    base, n_local = local_pages(mesh, Pn)
    inv = torch.full((B, Pn), -1, dtype=torch.long, device=pages.device)
    inv.scatter_(1, page_table[:, :sp].long().clamp(0, Pn - 1),
                 torch.arange(sp, device=pages.device).expand(B, sp))
    src = inv[:, base:base + n_local]
    hit = (src >= 0)[:, :, None, None, None]
    pages.copy_(torch.where(hit, kv4[bidx, src.clamp(min=0)], pages))
    return pages


def write_token(pages, kv, page_table, pos):
    """Write one new token's K or V per sequence, **in place**.

    pages [B, P, page, KVH, hd]; kv [B, KVH, hd]; pos int32 [B] (0-based
    slot). Returns `pages`."""
    B, P, page_size, KVH, hd = pages.shape
    pos = pos.long()
    pidx = page_table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    pidx = pidx.clamp(0, P - 1)
    slot = pos % page_size
    pages[torch.arange(B, device=pages.device), pidx, slot] = \
        kv.to(pages.dtype)
    return pages


def _attend_ref(q, k_pages, v_pages, page_table, seq_lens):
    """Batched-gather plain version over per-sequence pools: gathers in the
    pools' dtype, fp32 only inside the products (as the reference's
    ``preferred_element_type=float32`` einsums)."""
    B, H, D = q.shape
    _, P, page_size, KVH, _ = k_pages.shape
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    pt = page_table.long().clamp(0, P - 1)
    bidx = torch.arange(B, device=q.device)[:, None]
    k = k_pages[bidx, pt].reshape(B, P * page_size, KVH, D)
    v = v_pages[bidx, pt].reshape(B, P * page_size, KVH, D)
    qh = q.reshape(B, KVH, G, D).to(k.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k.float()) * scale
    pos = torch.arange(P * page_size, device=q.device)[None, None, None, :]
    mask = pos < seq_lens[:, None, None, None]
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(k.dtype).float(), v.float())
    return o.reshape(B, H, D).to(q.dtype)


def write_attend_seqpar(q, k_new, v_new, k_pages, v_pages, page_table, pos,
                        mesh=None, impl: str = "ref"):
    """Write one new token's K and V and attend over the paged cache.

    q [B, H, hd]; k_new / v_new [B, KVH, hd]; pools [B, P, page, KVH, hd];
    page_table int32 [B, P]; pos int32 [B], the new token's position.
    Returns (o [B, H, hd], k_pages, v_pages), the pools written in place.

    With a `mesh` that has a ``"model"`` axis every tensor is this
    process's: its batch rows, and its slice of the physical pages
    (``[B, P / model, ...]``; the page table keeps all P global ids). As
    the reference's ``shard_map`` body (`repro.kvcache.paged`): the
    token is written only by the process that owns its page; the inverse
    page table, sliced to the local pages, gives each local slot its
    logical position; the fp32 partial over the local pages combines
    with a MAX all-reduce of the row maxima and one SUM all-reduce of the
    denominators and outputs over ``"model"``. Plain tensor code, as the
    reference's einsums are, and no kernel. Without such a mesh it is
    `write_token` + `attend(impl=impl)`."""
    ax = model_axis(mesh)
    if ax is None:
        write_token(k_pages, k_new, page_table, pos)
        write_token(v_pages, v_new, page_table, pos)
        return (attend(q, k_pages, v_pages, page_table, pos + 1, impl=impl),
                k_pages, v_pages)
    group = ax[0]
    B, H, hd = q.shape
    _, Pl, page_size, KVH, _ = k_pages.shape
    Pn = page_table.shape[1]
    base, n_local = local_pages(mesh, Pn)
    if n_local != Pl:
        raise ValueError(f"the pools hold {Pl} pages, this process's "
                         f"slice of {Pn} is {n_local}")
    G = H // KVH
    dev = q.device
    pos = pos.long()
    bidx = torch.arange(B, device=dev)
    # ---- the new token, on the process that owns its page ----------------
    pidx = page_table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    mine = ((pidx >= base) & (pidx < base + Pl))[:, None, None]
    li = (pidx - base).clamp(0, Pl - 1)
    slot = pos % page_size
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        cur = pages[bidx, li, slot]
        pages[bidx, li, slot] = torch.where(mine, new.to(pages.dtype), cur)
    # ---- logical positions of the local physical pages -------------------
    inv = torch.full((B, Pn), -1, dtype=torch.long, device=dev)
    inv.scatter_(1, page_table.long().clamp(0, Pn - 1),
                 torch.arange(Pn, device=dev).expand(B, Pn))
    inv_local = inv[:, base:base + Pl]
    grid = (inv_local[:, :, None] * page_size
            + torch.arange(page_size, device=dev)[None, None, :])
    valid = (inv_local[:, :, None] >= 0) & (grid <= pos[:, None, None])
    valid = valid.reshape(B, 1, 1, Pl * page_size)
    # ---- the local partial, combined over "model" -------------------------
    k2 = k_pages.reshape(B, Pl * page_size, KVH, hd)
    v2 = v_pages.reshape(B, Pl * page_size, KVH, hd)
    qh = q.reshape(B, KVH, G, hd).to(k2.dtype)
    s = torch.einsum("bkgd,btkd->bkgt", qh.float(), k2.float()) / (hd ** 0.5)
    s = torch.where(valid, s, -1e30)
    m = comm.all_reduce(s.amax(dim=-1), dist.ReduceOp.MAX, group=group)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o_p = torch.einsum("bkgt,btkd->bkgd", p.to(k2.dtype).float(), v2.float())
    lo = comm.all_reduce(torch.cat([p.sum(dim=-1)[..., None], o_p], dim=-1),
                         group=group)
    o = lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)
    return o.reshape(B, H, hd).to(q.dtype), k_pages, v_pages


def global_page_table(page_table, P: int):
    """Per-sequence page ids as ids into the flattened ``[B*P, ...]`` pool:
    ``b*P + clip(pt, 0, P-1)`` (int32 [B, P])."""
    B = page_table.shape[0]
    base = torch.arange(B, dtype=torch.int32, device=page_table.device)
    return (base[:, None] * P + page_table.clamp(0, P - 1)).to(torch.int32)


def attend(q, k_pages, v_pages, page_table, seq_lens, impl: str = "ref"):
    """Decode attention over per-sequence paged KV: q [B, H, hd] ->
    [B, H, hd].

    ``impl="kernel"`` goes through `kernels.paged_attention.paged_attention`
    (the CUDA kernel on the card) over ``[B*P, page, KVH, hd]`` views of the
    pools with `global_page_table`'s ids; ``impl="ref"`` is
    `_attend_ref`."""
    if impl == "kernel":
        B, P, page_size, KVH, hd = k_pages.shape
        kp = k_pages.view(B * P, page_size, KVH, hd)
        vp = v_pages.view(B * P, page_size, KVH, hd)
        return paged_attention(q, kp, vp, global_page_table(page_table, P),
                               seq_lens)
    if impl != "ref":
        raise ValueError(f"unknown attend impl {impl!r} (kernel | ref)")
    return _attend_ref(q, k_pages, v_pages, page_table, seq_lens)


class PagePool:
    """Host-side page allocator for serving: PIM-malloc manages page ids.

    Pages are allocator 'bytes' at PAGE_UNIT per page; ptr -> page_id =
    ptr // PAGE_UNIT. Built on a `repro_torch.core.api.HeapClient` (kind
    ``sw`` by default, as in the reference; ``fused`` runs the heap-step
    kernel on the card), so every call also yields the DPU cost model's
    per-thread latencies (``pool.client.last_info``).

    Every page free routes through the protocol's free path: a stale or
    repeated page id reaches the backend and shows up in
    `Stats.dropped_frees` instead of being absorbed host-side.
    """

    def __init__(self, n_pages: int, num_threads: int = 16,
                 kind: str = "sw", client: api.HeapClient = None,
                 alloc=None, device="cuda"):
        """``client`` injects a `HeapClient` whose heap spans
        n_pages * PAGE_UNIT bytes; otherwise one is built on `device`.

        ``alloc`` is the deprecated injection hook: an Allocator-compatible
        handle (or a zero-argument factory returning one). It is still
        accepted, with a DeprecationWarning, and adapted through
        `HeapClient.wrap`."""
        if n_pages <= 0 or n_pages & (n_pages - 1):
            raise ValueError(f"n_pages must be a power of two, got {n_pages}")
        self.n_pages = n_pages
        if alloc is not None:
            import warnings
            warnings.warn(
                "PagePool(alloc=...) is deprecated: pass client=HeapClient "
                "(or any HeapClient subclass); bare handles/factories are "
                "adapted via HeapClient.wrap for now",
                DeprecationWarning, stacklevel=2)
            if client is not None:
                raise TypeError("pass either client= or (deprecated) alloc=")
            client = api.HeapClient.wrap(alloc)
        if client is None:
            client = api.HeapClient(heap_bytes=n_pages * PAGE_UNIT,
                                    num_threads=num_threads, kind=kind,
                                    device=device)
        elif not isinstance(client, api.HeapClient):
            raise TypeError(
                f"client must be a HeapClient, got {type(client).__name__!r}")
        if client.cfg.heap_bytes != n_pages * PAGE_UNIT:
            raise ValueError(f"client heap {client.cfg.heap_bytes} B != "
                             f"{n_pages} pages x {PAGE_UNIT} B")
        self.client = client
        self.alloc = client  # the old name: callers read pool.alloc
        self.cfg = client.cfg.pm  # block_bytes=4096: 256-page refills

    @property
    def device(self) -> torch.device:
        return self.client.device

    def alloc_pages(self, n: int, thread: int = 0) -> torch.Tensor:
        """Contiguous extent of `n` pages; returns page ids [n] (empty on
        OOM)."""
        ptr = self.client.malloc(n * PAGE_UNIT, thread=thread)
        if ptr < 0:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return ptr // PAGE_UNIT + torch.arange(n, dtype=torch.int32,
                                               device=self.device)

    def alloc_page_batch(self, threads) -> tuple[torch.Tensor, AllocResponse]:
        """One single-page allocation per requesting thread (decode growth).
        threads: bool [T] mask. Returns (int32 [T] page ids, -1 = none;
        the response)."""
        threads = torch.as_tensor(threads, dtype=torch.bool,
                                  device=self.device)
        sizes = torch.where(threads, PAGE_UNIT, 0).to(torch.int32)
        resp = self.client.malloc_batch(sizes, threads)
        ids = torch.where(resp.ptr >= 0,
                          torch.div(resp.ptr, PAGE_UNIT,
                                    rounding_mode="floor"), -1)
        return ids.to(torch.int32), resp

    def grow_extent(self, first_page: int, n_pages: int,
                    thread: int = 0) -> tuple[torch.Tensor, bool]:
        """realloc an extent to `n_pages` pages.

        Returns (page ids [n], moved). ids is empty on OOM (the old extent
        then remains live). When `moved` is True the allocator relocated the
        extent and freed the old pages: the caller MUST copy the old pages'
        KV contents into the returned ids before its next allocation, or the
        old pages may be handed to another sequence."""
        new_ptr = self.client.realloc(int(first_page) * PAGE_UNIT,
                                      n_pages * PAGE_UNIT, thread=thread)
        if new_ptr < 0:
            return torch.zeros((0,), dtype=torch.int32,
                               device=self.device), False
        moved = bool(self.client.last_info.moved[thread])
        return new_ptr // PAGE_UNIT + torch.arange(
            n_pages, dtype=torch.int32, device=self.device), moved

    def free_page_batch(self, pages) -> AllocResponse:
        """Free one page per thread slot (decode-page reclaim): pages
        int32 [T] page ids, -1 = nothing to free on that slot."""
        pages = torch.as_tensor(pages, dtype=torch.int32, device=self.device)
        ptrs = torch.where(pages >= 0, pages * PAGE_UNIT, -1)
        return self.client.free_batch(ptrs.to(torch.int32))

    def free_extent(self, first_page: int, thread: int = 0) -> None:
        self.client.free(int(first_page) * PAGE_UNIT, thread=thread)

    def evict(self, first_page: int, decode_pages, thread: int = 0) -> dict:
        """Session-end eviction: free ALL decode pages (chunked into T-wide
        free rounds), then the extent at ``first_page`` (skipped when < 0),
        every free through the protocol. Returns ``{"freed_pages",
        "dropped_frees"}``; a nonzero ``dropped_frees`` means a stale or
        double page id reached the backend's dropped-free path."""
        T = self.client.cfg.num_threads
        ids = [int(p) for p in np.asarray(
            torch.as_tensor(decode_pages).cpu(), np.int64).reshape(-1)
            if int(p) >= 0]
        freed = dropped = 0
        for i in range(0, len(ids), T):
            chunk = np.full((T,), -1, np.int32)
            chunk[:len(ids[i:i + T])] = ids[i:i + T]
            resp = self.free_page_batch(chunk)
            freed += len(ids[i:i + T])
            dropped += int(((resp.path == 2).cpu().numpy()
                            & (chunk >= 0)).sum())
        if int(first_page) >= 0:
            self.free_extent(first_page, thread=thread)
            dropped += int(self.client.last_info.path[thread] == 2)
        return {"freed_pages": freed, "dropped_frees": dropped}

    def gc(self) -> None:
        self.client.gc()

    @property
    def stats(self) -> dict:
        return self.client.stats
