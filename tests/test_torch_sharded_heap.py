"""The port's sharded tier (`ShardedHeap`, `sharded_init` /
`sharded_step` / `sharded_inner`): the rank axis on one device, and the
objects it takes for a mesh (the tier across processes is
tests/test_torch_mesh.py).

R ranks of C cores fold onto the core axis, so the tier must equal
`MultiCoreHeap` per (rank, core) on every kind, and the reference's
``ShardedHeap(mesh=False)`` (its one-device path: its mesh path fails in
the reference, ROADMAP C). The inputs are numpy-seeded, each rank its own
stream; the tolerance is exact equality of every response field (float32
latencies bitwise) and every state leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import system as jsys

from repro_torch import convert
from repro_torch.core import heap as theap
from repro_torch.core import system as tsys
from repro_torch.core import telemetry as ttel

T = 4
HEAP = 1 << 18
R, C = 3, 2


def _tape(rounds=3):
    """[rounds, R, C, T] malloc sizes, distinct per (rank, core, thread)."""
    rng = np.random.RandomState(7)
    return rng.choice([16, 100, 256, 2048, 3000, 8192],
                      (rounds, R, C, T)).astype(np.int32)


def _cfg(kind="sw"):
    return tsys.SystemConfig(kind=kind, heap_bytes=HEAP, num_threads=T)


def _session(heap, sizes):
    """malloc, realloc (rolled sizes), free what survived; returns the
    three responses."""
    ra = heap.malloc(sizes)
    rr = heap.realloc(ra.ptr, np.roll(sizes, 1, axis=-1))
    live = torch.where(rr.ptr >= 0, rr.ptr, ra.ptr)
    return ra, rr, heap.free(live)


def _fields_equal(a, b, msg):
    for f in theap.AllocResponse._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)).reshape(-1),
            np.asarray(getattr(b, f)).reshape(-1), err_msg=f"{msg} {f}")


@pytest.mark.parametrize("kind", ["strawman", "sw", "hwsw", "sanitizer",
                                  "arena", "tlregion", "fused"])
def test_sharded_matches_multicore_per_rank_and_core(kind):
    cfg = _cfg(kind)
    sh = theap.ShardedHeap(cfg, num_ranks=R, num_cores=C, device="cpu")
    assert sh.mesh is None and sh.shape == (R, C, T)
    mc = theap.MultiCoreHeap(cfg, num_cores=R * C, device="cpu")
    for r, sizes in enumerate(_tape()):
        got = _session(sh, sizes)
        want = _session(mc, sizes.reshape(R * C, T))
        for g, w in zip(got, want):
            assert tuple(g.ptr.shape) == (R, C, T)
            _fields_equal(g, w, f"{kind} round={r}")
        for a, b in zip(convert.leaves(sh.state), convert.leaves(mc.state)):
            assert tuple(a.shape[:2]) == (R, C)
            assert torch.equal(a.reshape(b.shape), b), (kind, r)
    assert (ttel.conservation_residuals(cfg, sh.state) == 0).all()


def test_sharded_matches_reference_mesh_false():
    """Against the reference's one-device path on kind hwsw: every field
    and leaf, and `sharded_step` / `sharded_inner` called directly."""
    jcfg = jsys.SystemConfig(kind="hwsw", heap_bytes=HEAP, num_threads=T)
    js = jheap.ShardedHeap(jcfg, num_ranks=R, num_cores=C, mesh=False)
    ts = theap.ShardedHeap(_cfg("hwsw"), num_ranks=R, num_cores=C,
                           mesh=False, device="cpu")
    for r, sizes in enumerate(_tape()):
        ra = js.malloc(jnp.asarray(sizes))
        rr = js.realloc(ra.ptr, jnp.roll(jnp.asarray(sizes), 1, axis=-1))
        want = (ra, rr, js.free(jnp.where(rr.ptr >= 0, rr.ptr, ra.ptr)))
        for g, w in zip(_session(ts, sizes), want):
            _fields_equal(g, w, f"round={r}")
        for a, b in zip(convert.leaves(ts.state), jax.tree.leaves(js.state)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fn, mesh = theap.sharded_inner(_cfg("hwsw"), R, mesh=None)
    assert mesh is None
    st = theap.sharded_init(_cfg("hwsw"), R, C, device="cpu")
    req = theap.malloc_request(torch.full((R, C, T), 64, dtype=torch.int32))
    st, resp = fn(st, req)
    st2 = theap.sharded_init(_cfg("hwsw"), R, C, device="cpu")
    st2, resp2 = theap.sharded_step(_cfg("hwsw"), st2, req)
    _fields_equal(resp, resp2, "direct")
    jst = jheap.sharded_init(jcfg, R, C)
    jst, jresp = jheap.sharded_step(jcfg, jst, jheap.malloc_request(
        jnp.full((R, C, T), 64, jnp.int32)))
    _fields_equal(resp, jresp, "reference sharded_step")


def test_rank_and_grid_masks():
    """[R] masks select ranks and [R, C] masks cores, never thread slots
    (the reference's tests/test_heap_api.py case), equal to the
    reference's answers."""
    R2, C2 = 2, 2
    jcfg = jsys.SystemConfig(kind="sw", heap_bytes=HEAP, num_threads=T)
    js = jheap.ShardedHeap(jcfg, num_ranks=R2, num_cores=C2, mesh=False)
    ts = theap.ShardedHeap(_cfg("sw"), num_ranks=R2, num_cores=C2,
                           mesh=False, device="cpu")
    full = np.full((R2, C2, T), 64, np.int32)
    r0, j0 = ts.malloc(full), js.malloc(jnp.asarray(full))
    _fields_equal(r0, j0, "malloc")
    rank = np.array([True, False])
    r1 = ts.realloc(r0.ptr, np.full((R2, C2, T), 2048, np.int32),
                    active=rank)
    j1 = js.realloc(j0.ptr, jnp.full((R2, C2, T), 2048, jnp.int32),
                    active=jnp.asarray(rank))
    _fields_equal(r1, j1, "realloc [R]")
    assert bool(r1.moved[0].all()) and bool((r1.ptr[1] == -1).all())
    grid = np.array([[True, False], [False, True]])
    args = (np.full((R2, C2, T), 8, np.int32),
            np.full((R2, C2, T), 16, np.int32))
    r2 = ts.calloc(*args, active=grid)
    j2 = js.calloc(*map(jnp.asarray, args), active=jnp.asarray(grid))
    _fields_equal(r2, j2, "calloc [R, C]")
    np.testing.assert_array_equal((r2.ptr >= 0).all(-1).numpy(), grid)
    r3 = ts.free(r0.ptr, active=True)
    _fields_equal(r3, js.free(j0.ptr, active=True), "free scalar mask")


def test_donation_and_rank_independence():
    """donate=False leaves the old state tensors as they were and gives
    the same results; rank 0's requests never touch rank 1's heap."""
    cfg = _cfg("hwsw")
    a = theap.ShardedHeap(cfg, 2, C, donate=True, device="cpu")
    b = theap.ShardedHeap(cfg, 2, C, donate=False, device="cpu")
    before = [x.clone() for x in convert.leaves(b.state)]
    old = convert.leaves(b.state)
    sizes = np.zeros((2, C, T), np.int32)
    sizes[0] = 256
    ra, rb = a.malloc(sizes), b.malloc(sizes)
    _fields_equal(ra, rb, "donate")
    assert bool((ra.ptr[0] >= 0).all()) and bool((ra.ptr[1] == -1).all())
    for x, y in zip(old, before):
        assert torch.equal(x, y)
    for x, y, z in zip(convert.leaves(a.state), convert.leaves(b.state),
                       before):
        assert torch.equal(x, y)
        assert torch.equal(x[1], z[1])  # rank 1 untouched


def test_mesh_other_than_none_or_false_raises():
    """Anything but None, False or a 1-D DeviceMesh raises, and so does a
    mesh whose size does not divide R (a 3-process mesh of a fake
    4-process group, which needs no processes)."""
    for mesh in (True, object(), "ranks"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            theap.ShardedHeap(_cfg(), R, C, mesh=mesh, device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            theap.sharded_inner(_cfg(), R, mesh=mesh)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("ranks",))
        with pytest.raises(ValueError, match="num_ranks=3 not divisible"):
            theap.ShardedHeap(_cfg(), R, C, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            theap.sharded_inner(_cfg(), R, mesh=mesh)
        flat = DeviceMesh("cpu", [[0, 1], [2, 3]],
                          mesh_dim_names=("data", "model"))
        with pytest.raises(TypeError, match="1-D DeviceMesh"):
            theap.sharded_inner(_cfg(), 4, mesh=flat)
    finally:
        dist.destroy_process_group()


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theap.ShardedHeap(_cfg(), R, C)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theap.sharded_init(_cfg(), R, C)
