"""The port's region frontends ``arena`` and ``tlregion`` against the
reference's.

The same numpy-seeded inputs go through the reference (JAX on the CPU) and
the port (plain PyTorch on CPU tensors). The tolerance is exact equality
everywhere: the arena helpers' outputs (park slots included), every
response field and every state leaf (the placement map, the bump
pointers, the epoch, the spill backend, the metadata cache, the
telemetry) after every round of a multi-core closed-loop stream with
per-core epoch resets, the float32 latencies bitwise. The port's
``arena_inner="fused"`` (the fused round's plain version here) is held to
the reference's ``arena_inner="pallas"`` and to the port's own ``hwsw``
spill; the committed tapes' ``arena`` / ``tlregion`` blocks hold both; the
port's `PyArena` oracle holds the semantic fields on a random stream.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import pim_malloc as jpm
from repro.core import system as jsys
from repro.kernels import freelist as jfl

from repro_torch import convert
from repro_torch.core import arena as tarena
from repro_torch.core import heap as theap
from repro_torch.core import pim_malloc as tpm
from repro_torch.core import system as tsys
from repro_torch.core import telemetry as ttel
from repro_torch.core.oracle import PyArena
from repro_torch.kernels import freelist as tfl
from repro_torch.workloads import replay, trace

from test_torch_cuda import closed_loop
from test_torch_heap import assert_resp_equal, assert_state_equal

HEAP = 1 << 18
T = 4
C = 3
CAP = 256
TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")
# the port's spill backends and the reference's of the same function
INNERS = (("hwsw", "hwsw"), ("fused", "pallas"))


def cfg_pair(kind, inner, heap_bytes=HEAP, threads=T):
    jinner = dict(INNERS)[inner]
    jcfg = jsys.SystemConfig(
        kind=kind, heap_bytes=heap_bytes, num_threads=threads,
        arena_inner=jinner,
        pm=jpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                               cap=CAP))
    tcfg = tsys.SystemConfig(
        kind=kind, heap_bytes=heap_bytes, num_threads=threads,
        arena_inner=inner,
        pm=tpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                               cap=CAP))
    return jcfg, tcfg


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the five helpers, park slots included
# ---------------------------------------------------------------------------
def test_bump_helpers_match_reference():
    rng = np.random.default_rng(0)
    n, rg = 64, 16
    shared = jax.jit(jfl.arena_bump_shared, static_argnums=3)
    for _ in range(20):
        cand = rng.random((C, T)) < 0.7
        gneed = rng.choice([1, 2, 4, 8, 16, 40], (C, T)).astype(np.int32)
        bump = rng.integers(0, n, (C,)).astype(np.int32)
        want = [shared(jnp.int32(bump[c]), cand[c], gneed[c], n)
                for c in range(C)]
        got = tfl.arena_bump_shared(t32(bump), t32(cand), t32(gneed), n)
        for i in range(3):
            np.testing.assert_array_equal(
                got[i].numpy(), np.stack([np.asarray(w[i]) for w in want]))
        bump_tl = rng.integers(0, rg, (C, T)).astype(np.int32)
        want = [jfl.arena_bump_tl(bump_tl[c], cand[c], gneed[c], rg)
                for c in range(C)]
        got = tfl.arena_bump_tl(t32(bump_tl), t32(cand), t32(gneed), rg)
        for i in range(3):
            np.testing.assert_array_equal(
                got[i].numpy(), np.stack([np.asarray(w[i]) for w in want]))


@pytest.mark.parametrize("n", [8, 64])
def test_mark_hole_and_reset_match_reference(n):
    """Masked lanes aim at -1, n, far outside and at slots live lanes
    write: none of them may write (the reference's park slot)."""
    rng = np.random.default_rng(n)
    classes = np.array([16, 32, 64, 128, 256, 512, 1024, 2048], np.int32)
    for _ in range(30):
        m = rng.integers(-1, 8, (C, n)).astype(np.int32)
        g = rng.choice([-5, -1, 0, 1, n - 1, n, n + 7, 3], (C, T)) \
            .astype(np.int32)
        cls = rng.integers(0, 8, (C, T)).astype(np.int32)
        on = rng.random((C, T)) < 0.5
        # a live lane per core never shares its slot with another live lane
        # (the arena's placements are distinct); masked lanes may
        for c in range(C):
            live = np.flatnonzero(on[c])
            g[c, live] = rng.permutation(n)[:len(live)]
        want = np.stack([np.asarray(jfl.arena_mark(
            jnp.asarray(m[c]), g[c], cls[c], on[c])) for c in range(C)])
        got = tfl.arena_mark(t32(m.copy()), t32(g), t32(cls), t32(on))
        np.testing.assert_array_equal(got.numpy(), want)
        g2 = rng.choice([-1, 0, 2, n - 1, n, 99], (C, T)).astype(np.int32)
        want = np.stack([np.asarray(jfl.arena_hole(jnp.asarray(m[c]), g2[c],
                                                   on[c]))
                         for c in range(C)])
        got = tfl.arena_hole(t32(m.copy()), t32(g2), t32(on))
        np.testing.assert_array_equal(got.numpy(), want)
        mask = rng.random((C, n)) < 0.4
        mask[0] = True
        want = [jfl.arena_region_reset(jnp.asarray(m[c]), jnp.asarray(classes),
                                       mask[c]) for c in range(C)]
        got_map, freed = tfl.arena_region_reset(t32(m.copy()), t32(classes),
                                                t32(mask))
        np.testing.assert_array_equal(got_map.numpy(),
                                      np.stack([np.asarray(w[0])
                                                for w in want]))
        np.testing.assert_array_equal(freed.numpy(),
                                      [int(w[1]) for w in want])


def test_region_reset_on_thread_views():
    """The tlregion pass works on a [C, T, region] view with a [C, T, 1]
    mask; it equals the reference's dense per-granule mask."""
    rng = np.random.default_rng(2)
    classes = np.array([16, 32, 64, 128, 256, 512, 1024, 2048], np.int32)
    rg = 8
    m = rng.integers(-1, 8, (C, T * rg)).astype(np.int32)
    is_reset = rng.random((C, T)) < 0.5
    dense = np.repeat(is_reset, rg, axis=1)
    want = [jfl.arena_region_reset(jnp.asarray(m[c]), jnp.asarray(classes),
                                   dense[c]) for c in range(C)]
    tm = t32(m.copy())
    _, freed = tfl.arena_region_reset(tm.view(C, T, rg), t32(classes),
                                      t32(is_reset)[:, :, None])
    np.testing.assert_array_equal(tm.numpy(),
                                  np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(freed.numpy(), [int(w[1]) for w in want])


# ---------------------------------------------------------------------------
# the kinds against the reference's, over both spill backends
# ---------------------------------------------------------------------------
def track(live, op, resp):
    rp, rok = resp.ptr.numpy(), resp.ok.numpy()
    for c, t in np.ndindex(op.shape):
        if rok[c, t] and op[c, t] in (1, 3, 4) and rp[c, t] >= 0:
            live[c].append(int(rp[c, t]))


@pytest.mark.parametrize("inner", ["hwsw", "fused"])
@pytest.mark.parametrize("kind", ["arena", "tlregion"])
def test_kind_matches_reference_with_resets(kind, inner):
    jcfg, tcfg = cfg_pair(kind, inner)
    jh = jheap.MultiCoreHeap(jcfg, num_cores=C)
    th = theap.MultiCoreHeap(tcfg, num_cores=C, device="cpu")
    assert isinstance(th.state, tarena.ArenaSystemState)
    assert_state_equal(th.state, jh.state, "init")
    seen = np.zeros(4, np.int64)  # resets, bump-served, spills, moves
    for r, (op, size, ptr, live) in enumerate(closed_loop(1)):
        want = jh.step(jheap.AllocRequest(op, size, ptr))
        got = th.step(theap.AllocRequest(*map(t32, (op, size, ptr))))
        assert_resp_equal(got, want, f"{kind}/{inner} round={r}")
        assert_state_equal(th.state, jh.state, f"{kind}/{inner} round={r}")
        path, ok = got.path.numpy(), got.ok.numpy()
        seen += [(op == 5).sum(), ((op == 1) & (path == 0)).sum(),
                 ((op == 1) & (path == 2) & ok).sum(), got.moved.sum()]
        track(live, op, got)
    assert (seen > 0).all(), seen
    assert (ttel.conservation_residuals(tcfg, th.state) == 0).all()
    assert th.state.epoch.tolist() == np.asarray(jh.state.epoch).tolist()


@pytest.mark.parametrize("kind", ["arena", "tlregion"])
def test_fused_spill_equals_hwsw_spill(kind):
    """The seam: over the fused round equals over hwsw, every field and
    leaf, on the port alone (the pair the card holds at full width)."""
    a = theap.MultiCoreHeap(cfg_pair(kind, "hwsw")[1], num_cores=C,
                            device="cpu")
    b = theap.MultiCoreHeap(cfg_pair(kind, "fused")[1], num_cores=C,
                            device="cpu")
    for r, (op, size, ptr, live) in enumerate(closed_loop(5, rounds=17)):
        req = theap.AllocRequest(*map(t32, (op, size, ptr)))
        ra, rb = a.step(req), b.step(req)
        for f in theap.AllocResponse._fields:
            assert torch.equal(getattr(ra, f), getattr(rb, f)), (r, f)
        for x, y in zip(convert.leaves(a.state), convert.leaves(b.state)):
            assert torch.equal(x, y), r
        track(live, op, ra)


@pytest.mark.parametrize("inner", ["hwsw", "fused"])
@pytest.mark.parametrize("kind", ["arena", "tlregion"])
@pytest.mark.parametrize("name", NAMES)
def test_tape_reproduces_committed_block(name, kind, inner):
    tape = trace.Trace.load(str(TAPES / f"{name}.json"))
    resps, state, report = replay.replay(tape, kind, device="cpu",
                                         arena_inner=inner)
    assert replay.check_trace(tape, results={kind: report}) == []
    assert report["digest_full"] == tape.expect[kind]["digest_full"]
    assert report["telemetry"]["conservation_residual"] == 0
    assert report["stats_dropped_frees"] == report["dropped_frees"]


def test_pointer_edges_floor_semantics():
    """ptr = -1, -16, heap end, the arena's end and misaligned pointers:
    both sides take floor `//` and `%` and guard with in_range."""
    ab = HEAP // 2
    edges = np.array([[-1, -16, HEAP, ab], [ab - 16, 8, -17, 2 ** 31 - 1],
                      [0, 16, -32, ab + 16]], np.int32)
    for kind in ("arena", "tlregion"):
        jcfg, tcfg = cfg_pair(kind, "hwsw")
        jh = jheap.MultiCoreHeap(jcfg, num_cores=C)
        th = theap.MultiCoreHeap(tcfg, num_cores=C, device="cpu")
        sizes = np.full((C, T), 32, np.int32)
        for build, args in (("malloc", (sizes,)), ("free", (edges,)),
                            ("realloc", (edges, sizes)),
                            ("realloc", (edges, np.zeros_like(sizes))),
                            ("realloc", (edges, np.full_like(sizes, 8192)))):
            want = getattr(jh, build)(*args)
            got = getattr(th, build)(*args)
            assert_resp_equal(got, want, f"{kind} {build}")
            assert_state_equal(th.state, jh.state, f"{kind} {build}")


@pytest.mark.parametrize("kind", ["arena", "tlregion"])
def test_same_round_double_free_is_served_twice(kind):
    """A reference quirk kept on purpose: two threads free one arena
    pointer in one round; both see it owned, both are served and counted
    in frees_small, and live bytes fall twice, leaving a conservation
    residual of the block's size."""
    jcfg, tcfg = cfg_pair(kind, "hwsw", threads=T)
    jh = jheap.MultiCoreHeap(jcfg, num_cores=1)
    th = theap.MultiCoreHeap(tcfg, num_cores=1, device="cpu")
    sizes = np.array([[100, 0, 0, 0]], np.int32)
    want, got = jh.malloc(sizes), th.malloc(sizes)
    assert_resp_equal(got, want, "malloc")
    p = int(got.ptr[0, 0])
    assert 0 <= p < HEAP // 2 and int(got.path[0, 0]) == 0
    ptrs = np.array([[p, p, -1, -1]], np.int32)
    want, got = jh.free(ptrs), th.free(ptrs)
    assert_resp_equal(got, want, "double free")
    assert_state_equal(th.state, jh.state, "double free")
    assert got.ok[0, :2].all() and got.path[0, :2].tolist() == [0, 0]
    assert int(th.state.alloc.stats.frees_small[0]) == 2
    assert int(th.state.telem.live_bytes[0]) == -128
    assert ttel.conservation_residuals(tcfg, th.state).tolist() == [128]


def test_carve_lands_at_offset_zero_and_fresh_state():
    for kind in ("arena", "tlregion"):
        cfg = cfg_pair(kind, "hwsw")[1]
        st = tsys.system_init(cfg, num_cores=2, device="cpu")
        assert tuple(st.cls_map.shape) == (2, tarena.n_granules(cfg))
        assert tuple(st.bump.shape) == (2, T if kind == "tlregion" else 1)
        assert int(st.alloc.buddy.longest[0, 2]) == 0  # left half carved
        assert int(st.alloc.counts.sum()) == 0
        assert (ttel.conservation_residuals(cfg, st) == 0).all()
        assert tarena.arena_live_bytes(cfg, st.cls_map).tolist() == [0, 0]


@pytest.mark.parametrize("kind", ["arena", "tlregion"])
def test_kind_matches_py_arena_oracle(kind):
    """The port's `PyArena` (its own copy of the reference's oracle) on a
    random stream with reset rounds and stale frees: the semantic fields
    equal and the residual 0 after every round, on two cores each held to
    its own oracle."""
    cfg = cfg_pair(kind, "hwsw")[1]
    cores = 2
    th = theap.MultiCoreHeap(cfg, num_cores=cores, device="cpu")
    pys = [PyArena(heap_bytes=HEAP, num_threads=T, cap=CAP,
                   tlregion=kind == "tlregion") for _ in range(cores)]
    rng = np.random.default_rng(3)
    live = [[] for _ in range(cores)]
    sizes = (16, 48, 100, 256, 1024, 2047, 2048, 2049, 4096, 12000)
    for r in range(30):
        op = np.zeros((cores, T), np.int32)
        size = np.zeros_like(op)
        ptr = np.full_like(op, -1)
        for c in range(cores):
            if r % 9 == 8:
                op[c, rng.random(T) < 0.6] = 5  # stale frees stay in live
                continue
            for t in range(T):
                u = rng.random()
                if u < 0.45 or not live[c]:
                    op[c, t] = int(rng.choice((1, 4)))
                    size[c, t] = int(rng.choice(sizes))
                elif u < 0.7:
                    op[c, t] = 2
                    ptr[c, t] = live[c].pop(int(rng.integers(len(live[c]))))
                else:
                    op[c, t] = 3
                    size[c, t] = int(rng.choice((0, 16, 100, 1024, 8192)))
                    if rng.random() < 0.8:
                        ptr[c, t] = live[c].pop(int(rng.integers(
                            len(live[c]))))
        got = th.step(theap.AllocRequest(*map(t32, (op, size, ptr))))
        for c in range(cores):
            want = pys[c].request(op[c].tolist(), size[c].tolist(),
                                  ptr[c].tolist())
            for f in ("ptr", "ok", "path", "moved"):
                np.testing.assert_array_equal(
                    getattr(got, f)[c].numpy(), want[f],
                    err_msg=f"{kind} round {r} core {c}: {f}")
            live[c] += [int(p) for p in got.ptr[c].tolist() if p >= 0]
        assert (ttel.conservation_residuals(cfg, th.state) == 0).all(), r
