"""The port's client and telemetry surface against the reference's.

`HeapClient.wrap` on its three handle forms and its TypeError, the Table-2
facade (`initAllocator`, ``pimMalloc`` ... ``pimCallocBatch``),
`PagePool`'s deprecated ``alloc=`` hook, `telemetry.fleet_pressure` /
`hwm_divergence` (their errors included), `HeapClient.gc` on every
pim-style kind, and the port's own `core.oracle` (pure Python) against the
reference's on random streams. The same numpy-seeded inputs go through
both packages on the CPU; the tolerance is exact equality of every
returned pointer, response field, state leaf and report value.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import oracle as joracle
from repro.core import telemetry as jtel
from repro.kvcache import paged as jpaged

from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import heap as theap
from repro_torch.core import oracle as toracle
from repro_torch.core import system as tsys
from repro_torch.core import telemetry as ttel
from repro_torch.kvcache import paged as tpaged

from test_torch_heap import assert_state_equal

HEAP = 1 << 18
T = 4
# the reference's name for each port kind (else the same)
JKIND = {"fused": "pallas"}
PIM_KINDS = ("sw", "hwsw", "sanitizer", "arena", "tlregion", "fused")


def pair(kind="sw", **kw):
    j = japi.HeapClient(heap_bytes=HEAP, num_threads=T,
                        kind=JKIND.get(kind, kind), **kw)
    t = tapi.HeapClient(heap_bytes=HEAP, num_threads=T, kind=kind,
                        device="cpu", **kw)
    return j, t


def state_equal(t, j, msg=""):
    assert_state_equal(t.state, jax.tree.map(lambda x: np.asarray(x)[None],
                                             j.state), msg)


class Duck:
    """A legacy handle: ``cfg``, ``state`` and ``request()`` only."""

    def __init__(self, client):
        self.cfg, self._c = client.cfg, client
        if hasattr(client, "device"):
            self.device = client.device

    @property
    def state(self):
        return self._c.state

    def request(self, req):
        return self._c.request(req)


def test_wrap_three_forms_and_type_error():
    j, t = pair()
    assert tapi.HeapClient.wrap(t) is t
    made = tapi.HeapClient.wrap(lambda: t)
    assert made is t
    ad, jad = tapi.HeapClient.wrap(Duck(t)), japi.HeapClient.wrap(Duck(j))
    assert isinstance(ad, tapi.HeapClient) and type(ad).__name__ == \
        type(jad).__name__ == "_HandleAdapter"
    assert ad.device == torch.device("cpu") and ad.cfg is t.cfg
    # the adapter serves the whole surface through the handle
    for name, args in (("malloc", (100,)), ("calloc", (3, 40)),
                       ("malloc", (8192,))):
        assert getattr(ad, name)(*args, thread=1) == \
            getattr(jad, name)(*args, thread=1)
    p, jp = ad.malloc(64, thread=2), jad.malloc(64, thread=2)
    assert ad.realloc(p, 3000, thread=2) == jad.realloc(jp, 3000, thread=2)
    assert ad.stats == jad.stats and ad.last_info is t.last_info
    ad.gc()
    jad.gc()
    state_equal(t, j, "adapter")
    for bad in (3, "x", object(), lambda: 5):
        for cls in (tapi.HeapClient, japi.HeapClient):
            with pytest.raises(TypeError, match="cannot adapt"):
                cls.wrap(bad)


def test_table2_facade_matches_reference():
    a = tapi.initAllocator(HEAP, num_threads=T, kind="hwsw", device="cpu")
    ja = japi.initAllocator(HEAP, num_threads=T, kind="hwsw")
    assert isinstance(a, tapi.Allocator) and a.cfg.pm.size_classes == \
        tuple(ja.cfg.pm.size_classes)
    p, jp = a.pimMalloc(100), ja.pimMalloc(100)
    assert p == jp >= 0
    assert a.pimRealloc(p, 4000, thread=1) == ja.pimRealloc(jp, 4000,
                                                           thread=1)
    assert a.pimCalloc(8, 32, thread=2) == ja.pimCalloc(8, 32, thread=2)
    a.pimFree(p)
    ja.pimFree(jp)
    sizes = np.array([16, 300, 5000, 0], np.int32)
    got, want = a.pimMallocBatch(sizes), ja.pimMallocBatch(sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got2 = a.pimReallocBatch(got, np.array([32, 0, 100, 64], np.int32))
    want2 = ja.pimReallocBatch(want, jnp.array([32, 0, 100, 64], jnp.int32))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    got3 = a.pimCallocBatch(np.full(T, 4, np.int32), np.full(T, 64, np.int32))
    want3 = ja.pimCallocBatch(jnp.full(T, 4, jnp.int32),
                              jnp.full(T, 64, jnp.int32))
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))
    a.pimFreeBatch(got3)
    ja.pimFreeBatch(want3)
    assert a.stats == ja.stats
    state_equal(a, ja, "facade")
    assert tapi.initAllocator(HEAP, num_threads=T, device="cpu").kind == "sw"


def test_page_pool_alloc_hook_warns_and_serves():
    n_pages = 1 << 14
    t = tapi.HeapClient(heap_bytes=n_pages * tpaged.PAGE_UNIT,
                        num_threads=T, device="cpu")
    j = japi.HeapClient(heap_bytes=n_pages * jpaged.PAGE_UNIT,
                        num_threads=T)
    with pytest.warns(DeprecationWarning, match="alloc=.*deprecated"):
        pool = tpaged.PagePool(n_pages, num_threads=T, alloc=Duck(t))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jpool = jpaged.PagePool(n_pages, num_threads=T, alloc=Duck(j))
    assert pool.alloc is pool.client and pool.device == torch.device("cpu")
    ids, jids = pool.alloc_pages(3), jpool.alloc_pages(3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    mask = np.array([True, False, True, True])
    (b, _), (jb, _) = pool.alloc_page_batch(mask), \
        jpool.alloc_page_batch(jnp.asarray(mask))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    g, jg = pool.grow_extent(int(ids[0]), 8), jpool.grow_extent(
        int(jids[0]), 8)
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(jg[0]))
    assert g[1] == jg[1]
    state_equal(t, j, "pool")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(TypeError, match="either client= or"):
            tpaged.PagePool(n_pages, alloc=Duck(t), client=t)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(TypeError, match="cannot adapt"):
            tpaged.PagePool(n_pages, alloc=42)


def test_fleet_pressure_and_hwm_divergence_match_reference():
    rng = np.random.default_rng(0)
    cfg = tsys.SystemConfig(kind="sw", heap_bytes=HEAP, num_threads=T)
    sh = theap.ShardedHeap(cfg, num_ranks=3, num_cores=2, device="cpu")
    sh.malloc(rng.choice([16, 2048, 8192, 0], (3, 2, T)).astype(np.int32))
    got = ttel.fleet_pressure(sh.state)

    class JState:  # the reference reads state.telem only
        telem = jax.tree.map(lambda x: jnp.asarray(x.numpy()), sh.state.telem)

    want = jtel.fleet_pressure(JState)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int64
    for hwm in (got["rank_hwm"], [0, 0, 0], [5, 100, 1], [7], [0, 3],
                torch.tensor([4, 9, 2])):
        for ratio, floor in ((2.0, 1), (1.5, 50), (10.0, 1)):
            w = jtel.hwm_divergence(np.asarray(hwm), ratio, floor)
            assert ttel.hwm_divergence(hwm, ratio, floor) == w
    for mod in (ttel, jtel):
        with pytest.raises(ValueError, match="empty rank_hwm"):
            mod.hwm_divergence([])
    flat = tsys.system_init(cfg, num_cores=2, device="cpu")
    with pytest.raises(ValueError, match=r"\[R, C\] telemetry"):
        ttel.fleet_pressure(flat)  # a [C]-shaped state

    class JFlat:
        telem = jax.tree.map(lambda x: jnp.asarray(x.numpy()), flat.telem)

    with pytest.raises(ValueError, match=r"\[R, C\] telemetry"):
        jtel.fleet_pressure(JFlat)


@pytest.mark.parametrize("kind", PIM_KINDS)
def test_gc_on_every_pim_style_kind(kind):
    """Fill and empty the thread caches (through the backend on the arena
    kinds: sizes above the largest class and spills), then gc: the state
    equals the reference's, and the residual stays 0."""
    j, t = pair(kind)
    rng = np.random.default_rng(1)
    for r in range(3):
        sizes = rng.choice([16, 64, 512, 2048, 4096, 8192], T) \
            .astype(np.int32)
        rt, rj = t.malloc_batch(sizes), j.malloc_batch(jnp.asarray(sizes))
        np.testing.assert_array_equal(rt.ptr.numpy(), np.asarray(rj.ptr))
        t.free_batch(rt.ptr)
        j.free_batch(rj.ptr)
    t.gc()
    j.gc()
    state_equal(t, j, f"{kind} gc")
    assert t.telemetry()["conservation_residual"] == 0
    assert t.stats == j.stats


def test_strawman_gc_is_a_no_op():
    j, t = pair("strawman")
    t.malloc(100)
    before = [x.clone() for x in convert.leaves(t.state)]
    t.gc()
    for a, b in zip(convert.leaves(t.state), before):
        assert torch.equal(a, b)
    assert t.stats == j.stats == {}


def test_oracle_copy_matches_reference_oracle():
    """PyBuddy, PyPimMalloc (request and gc) and PyArena of the port's copy
    against the reference's, on one random stream each."""
    rng = np.random.default_rng(2)
    a, b = toracle.PyBuddy(1 << 16, 64), joracle.PyBuddy(1 << 16, 64)
    offs = []
    for _ in range(200):
        if offs and rng.random() < 0.4:
            o, s = offs.pop(int(rng.integers(len(offs))))
            assert a.free(o, s) == b.free(o, s)
        else:
            s = int(rng.choice([1, 64, 100, 4096, 70000]))
            o = a.alloc(s)
            assert o == b.alloc(s)
            if o >= 0:
                offs.append((o, s))
        assert a.free_bytes() == b.free_bytes()
    for make in (lambda m: m.PyPimMalloc(heap_bytes=HEAP, num_threads=T),
                 lambda m: m.PyArena(heap_bytes=HEAP, num_threads=T),
                 lambda m: m.PyArena(heap_bytes=HEAP, num_threads=T,
                                     tlregion=True)):
        p, q = make(toracle), make(joracle)
        live = []
        for r in range(40):
            op = rng.choice([1, 1, 2, 3, 4, 5 if r % 10 == 9 else 0], T)
            size = rng.choice([0, 16, 100, 2048, 3000, 9000], T)
            ptr = [live.pop(int(rng.integers(len(live))))
                   if o in (2, 3) and live else -1 for o in op]
            args = (op.tolist(), size.tolist(), ptr)
            want = q.request(*args)
            assert p.request(*args) == want
            live += [x for x in want["ptr"] if x >= 0]
        if isinstance(p, toracle.PyPimMalloc):
            p.gc()
            q.gc()
            assert p.stats == q.stats and p.stacks == q.stacks


def test_hwsw_matches_py_pim_malloc():
    """The port's hwsw against its own oracle, round by round, with the
    residual 0 after each (the reference's oracle differential)."""
    cfg = tsys.SystemConfig(kind="hwsw", heap_bytes=HEAP, num_threads=T)
    st = theap.init(cfg, device="cpu")
    py = toracle.PyPimMalloc(heap_bytes=HEAP, num_threads=T)
    rng = np.random.default_rng(4)
    live = []
    for r in range(24):
        op = rng.choice([1, 1, 2, 3, 4], T).astype(np.int32)
        size = rng.choice([16, 100, 2048, 4096, 9000, 0], T).astype(np.int32)
        ptr = np.array([live.pop(int(rng.integers(len(live))))
                        if o in (2, 3) and live else -1 for o in op],
                       np.int32)
        st, got = theap.step(cfg, st, theap.AllocRequest(
            *(torch.from_numpy(x)[None] for x in (op, size, ptr))))
        want = py.request(op.tolist(), size.tolist(), ptr.tolist())
        for f in ("ptr", "ok", "path", "moved"):
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                          want[f], err_msg=f"{r} {f}")
        live += [int(x) for x in got.ptr[0].tolist() if x >= 0]
        assert ttel.conservation_residuals(cfg, st).tolist() == [0]
