"""Allocator client surface: `HeapClient`.

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
  * ``epoch_reset``: an ``OP_EPOCH_RESET`` round (idle on every kind the
    port has: none has an arena frontend);
  * ``gc``: merge fully free thread-cache blocks back into the buddy;
  * ``stats`` / ``telemetry()`` / ``last_info``: the allocator counters, a
    heap-health snapshot (`repro_torch.core.telemetry`), and the per-thread
    responses of the most recent round.

Every call builds one `AllocRequest` and runs one `heap.step` round on a
single-core state (the core axis of `heap.step` has length 1 here). The
port of the reference's `repro.core.api`; the ``wrap`` adapter and the
Table-2 ``Allocator`` facade wait for ROADMAP A3. The default kind is the
reference's, ``sw``.
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
        """Retire the current allocation epoch (``OP_EPOCH_RESET``). The
        port's kinds have no arena frontend and answer the round as idle
        (ok False, path -1), as the reference's non-arena kinds do."""
        return self.request(heap.epoch_reset_request(
            self.cfg.num_threads, self._mask(active), device=self.device))

    # -- maintenance / introspection -------------------------------------------
    def gc(self) -> None:
        """Merge fully free thread-cache blocks back into the buddy
        (`pim_malloc.gc`, up to ``max_gc`` blocks per call). Live bytes are
        unchanged, so the telemetry carries over; ``strawman`` has no
        thread caches and returns at once."""
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
