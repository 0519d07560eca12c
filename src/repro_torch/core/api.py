"""Allocator client surface: `HeapClient` and the Table-2 facade.

`HeapClient` is the one stateful client object consumers build on
(`repro_torch.kvcache.PagePool` first). It drives one registered heap kind,
one PIM core serving T hardware threads, through one surface:

  * ``malloc / calloc / realloc / free``: single-op convenience (one
    hardware thread active per call);
  * ``malloc_batch / calloc_batch / realloc_batch / free_batch``: one op
    per hardware thread, returning the full `AllocResponse` (``[T]``
    leaves);
  * ``request()``: the raw protocol entry point every method routes
    through (a subclass that overrides it sees every round);
  * ``epoch_reset``: an ``OP_EPOCH_RESET`` round (the arena kinds retire
    their epoch, the ``sanitizer`` its live shadow starts, every other
    kind answers it as idle);
  * ``gc``: merge fully free thread-cache blocks back into the buddy;
  * ``stats`` / ``telemetry()`` / ``last_info``: the allocator counters, a
    heap-health snapshot (`repro_torch.core.telemetry`), and the per-thread
    responses of the most recent round.

Every call builds one `AllocRequest` and runs one `heap.step` round on a
single-core state (the core axis of `heap.step` has length 1 here). The
port of the reference's `repro.core.api`. The default kind is the
reference's, ``sw``.

`Allocator` is the paper-facing facade (Table 2): ``initAllocator`` /
``pimMalloc`` / ``pimFree`` / ``pimRealloc`` / ``pimCalloc`` and their
Batch variants are aliases over the client surface. `HeapClient.wrap`
adapts legacy duck-typed handles (the deprecated ``PagePool(alloc=)``
hook) onto it.
"""
from __future__ import annotations

import torch

from .. import device as _device
from . import heap, pim_malloc
from .heap import AllocRequest, AllocResponse
from .pim_malloc import PimMallocConfig
from .system import SystemConfig, SystemState


class HeapClient:
    """One registered heap kind behind malloc/free/realloc/calloc +
    telemetry, for one PIM core of T hardware threads, on `device` (the
    card unless the caller asks for the CPU).

    The state lives on the device and each round updates it in place (see
    `heap.step`); host syncs happen only where a method returns a Python
    number (``malloc``, ``realloc``, ``calloc``, ``stats``)."""

    def __init__(self, heap_bytes: int = 32 * 1024 * 1024,
                 size_classes=(16, 32, 64, 128, 256, 512, 1024, 2048),
                 num_threads: int = 16, prepopulate: bool = True,
                 kind: str = "sw", device="cuda"):
        self.device = _device.resolve(device)
        pm = PimMallocConfig(
            heap_bytes=heap_bytes, size_classes=tuple(size_classes),
            num_threads=num_threads)
        self.cfg = SystemConfig(kind=kind, heap_bytes=heap_bytes,
                                num_threads=num_threads, pm=pm)
        self.state: SystemState = heap.init(self.cfg, prepopulate,
                                            num_cores=1, device=self.device)
        self.last_info: AllocResponse | None = None

    @classmethod
    def wrap(cls, handle) -> "HeapClient":
        """Adapt a legacy allocator handle onto the client surface.

        Accepts a `HeapClient` (returned as it is), a zero-argument factory
        returning one, or any duck-typed object with ``cfg`` and
        ``request()`` (the old ``PagePool(alloc=)`` contract); anything
        else raises TypeError."""
        if isinstance(handle, HeapClient):
            return handle
        if callable(handle) and not hasattr(handle, "request"):
            return cls.wrap(handle())
        if not hasattr(handle, "request") or not hasattr(handle, "cfg"):
            raise TypeError(
                f"cannot adapt {type(handle).__name__!r} to HeapClient: "
                "need a HeapClient, a zero-arg factory returning one, or "
                "an object with .cfg and .request(AllocRequest)")
        return _HandleAdapter(handle)

    # -- protocol entry point ------------------------------------------------
    def request(self, req: AllocRequest) -> AllocResponse:
        """Serve one ``[T]`` request round; advances the heap state."""
        req = AllocRequest(*(torch.as_tensor(
            x, dtype=torch.int32, device=self.device)[None] for x in req))
        self.state, resp = heap.step(self.cfg, self.state, req)
        resp = AllocResponse(*(x[0] for x in resp))
        self.last_info = resp
        return resp

    def _full(self, v) -> torch.Tensor:
        return torch.full((self.cfg.num_threads,), v, dtype=torch.int32,
                          device=self.device)

    def _one(self, build, thread: int) -> AllocResponse:
        active = torch.zeros((self.cfg.num_threads,), dtype=torch.bool,
                             device=self.device)
        active[thread] = True
        return self.request(build(active))

    # -- single-op convenience (one hardware thread active) ------------------
    def malloc(self, size: int, thread: int = 0) -> int:
        resp = self._one(lambda a: heap.malloc_request(self._full(size), a),
                         thread)
        return int(resp.ptr[thread])

    def free(self, ptr: int, thread: int = 0) -> None:
        self._one(lambda a: heap.free_request(self._full(ptr), a), thread)

    def realloc(self, ptr: int, size: int, thread: int = 0) -> int:
        resp = self._one(lambda a: heap.realloc_request(
            self._full(ptr), self._full(size), a), thread)
        return int(resp.ptr[thread])

    def calloc(self, nmemb: int, size: int, thread: int = 0) -> int:
        resp = self._one(lambda a: heap.calloc_request(
            self._full(nmemb), self._full(size), a), thread)
        return int(resp.ptr[thread])

    # -- batched (one op per hardware thread, full response) -----------------
    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def _mask(self, active):
        return None if active is None else torch.as_tensor(
            active, dtype=torch.bool, device=self.device)

    def malloc_batch(self, sizes, active=None) -> AllocResponse:
        return self.request(heap.malloc_request(self._i32(sizes),
                                                self._mask(active)))

    def free_batch(self, ptrs, active=None) -> AllocResponse:
        """Free one pointer per thread slot. NULL (-1) frees are benign
        no-ops; any other stale or garbage pointer reaches the backend and
        counts against `Stats.dropped_frees`."""
        return self.request(heap.free_request(self._i32(ptrs),
                                              self._mask(active)))

    def realloc_batch(self, ptrs, sizes, active=None) -> AllocResponse:
        return self.request(heap.realloc_request(
            self._i32(ptrs), self._i32(sizes), self._mask(active)))

    def calloc_batch(self, nmemb, sizes, active=None) -> AllocResponse:
        return self.request(heap.calloc_request(
            self._i32(nmemb), self._i32(sizes), self._mask(active)))

    def epoch_reset(self, active=None) -> AllocResponse:
        """Retire the current allocation epoch (``OP_EPOCH_RESET``).

        On ``arena`` any active thread clears the whole shared bump region
        (idempotent across threads in one round); on ``tlregion`` each
        active thread clears only its own region. Every pointer the arena
        handed out this epoch is invalid afterwards (the ``trace_lint``
        rule). The ``sanitizer`` retires every LIVE shadow start to STALE
        and tags later uses ``epoch_stale``; the other kinds answer the
        round as idle (ok False, path -1)."""
        return self.request(heap.epoch_reset_request(
            self.cfg.num_threads, self._mask(active), device=self.device))

    # -- maintenance / introspection -------------------------------------------
    def gc(self) -> None:
        """Merge fully free thread-cache blocks back into the buddy
        (`pim_malloc.gc`, up to ``max_gc`` blocks per call). Works on every
        pim-style kind: they share the `PimMallocState` layout in
        ``.alloc`` (the sanitizer's shadow and quarantine describe live
        allocations, which gc never moves; the arena region lies outside
        the thread caches). Live bytes are unchanged, so the telemetry
        carries over; ``strawman`` has no thread caches and returns at
        once."""
        if self.cfg.kind == "strawman":
            return
        self.state = self.state._replace(
            alloc=pim_malloc.gc(self.cfg.pm, self.state.alloc))

    @property
    def kind(self) -> str:
        return self.cfg.kind

    @property
    def num_threads(self) -> int:
        return self.cfg.num_threads

    @property
    def heap_bytes(self) -> int:
        return self.cfg.heap_bytes

    @property
    def stats(self) -> dict:
        """The allocator counters ({} for ``strawman``, which keeps none)."""
        if self.cfg.kind == "strawman":
            return {}
        return {k: int(v[0])
                for k, v in self.state.alloc.stats._asdict().items()}

    def telemetry(self) -> dict:
        """Heap-health snapshot: live/hwm/free bytes, external_frag, the
        conservation residual (see `repro_torch.core.telemetry.snapshot`)."""
        from . import telemetry
        return telemetry.snapshot(self.cfg, self.state)


class _HandleAdapter(HeapClient):
    """`HeapClient.wrap` shim: forwards the protocol to a duck-typed handle
    while exposing the whole client surface (the deprecation path of the
    old ``PagePool(alloc=)`` hook). Requests are built on the handle's
    ``device`` (the card when it names none)."""

    def __init__(self, handle):  # no heap of its own
        self._handle = handle
        self.cfg = handle.cfg
        self.device = _device.resolve(getattr(handle, "device", "cuda"))
        self.last_info = getattr(handle, "last_info", None)

    def request(self, req: AllocRequest) -> AllocResponse:
        resp = self._handle.request(req)
        self.last_info = resp
        return resp

    @property
    def state(self):
        return self._handle.state

    def gc(self) -> None:
        if hasattr(self._handle, "gc"):
            self._handle.gc()


class Allocator(HeapClient):
    """A per-PIM-core allocator handle under the paper's Table 2 names
    (pimMalloc / pimFree / pimRealloc / pimCalloc and the Batch variants),
    thin aliases over the `HeapClient` surface."""

    # -- Table 2 API ---------------------------------------------------------
    def pimMalloc(self, size: int, thread: int = 0) -> int:
        return self.malloc(size, thread=thread)

    def pimFree(self, ptr: int, thread: int = 0) -> None:
        self.free(ptr, thread=thread)

    def pimRealloc(self, ptr: int, size: int, thread: int = 0) -> int:
        return self.realloc(ptr, size, thread=thread)

    def pimCalloc(self, nmemb: int, size: int, thread: int = 0) -> int:
        return self.calloc(nmemb, size, thread=thread)

    # -- batched (one request per hardware thread) ---------------------------
    def pimMallocBatch(self, sizes) -> torch.Tensor:
        return self.malloc_batch(sizes).ptr

    def pimFreeBatch(self, ptrs) -> None:
        self.free_batch(ptrs)

    def pimReallocBatch(self, ptrs, sizes) -> torch.Tensor:
        return self.realloc_batch(ptrs, sizes).ptr

    def pimCallocBatch(self, nmemb, sizes) -> torch.Tensor:
        return self.calloc_batch(nmemb, sizes).ptr


def initAllocator(heap_bytes: int, size_classes=None, **kw) -> Allocator:
    """Table 2's initAllocator: an `Allocator` over a ``heap_bytes`` heap
    (keyword arguments as `HeapClient`'s: ``num_threads``, ``kind``,
    ``device``, ...)."""
    if size_classes is None:
        size_classes = (16, 32, 64, 128, 256, 512, 1024, 2048)
    return Allocator(heap_bytes=heap_bytes, size_classes=size_classes, **kw)
