"""The port's ``sanitizer`` kind against the reference's.

Each case of the reference's tests/test_sanitizer.py (double free,
use-after-free through a stale realloc pointer, realloc-after-free, wild
and misaligned pointers, the quarantine's delay, FIFO eviction with
conservation, epoch-stale ops, the `report()` schema) runs through the
reference (JAX on the CPU, one core) and the port (plain PyTorch on CPU
tensors, a core axis of 1) with the same requests, and keeps the
reference's own assertions. The tolerance is exact equality: every
response field (the float32 latencies bitwise) and every state leaf (the
shadow map, the quarantine ring, the tags, the reports, the wrapped hwsw
state, the telemetry) after every round, and `report()` itself. A
multi-core stream and the committed tapes' ``sanitizer`` blocks close it.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import sanitizer as jsan
from repro.core import system as jsys

from repro_torch.core import heap as theap
from repro_torch.core import sanitizer as tsan
from repro_torch.core import system as tsys
from repro_torch.core import telemetry as ttel
from repro_torch.workloads import replay, trace

from test_torch_heap import assert_resp_equal, assert_state_equal

T = 4
HEAP = 1 << 18
TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("decode_serve", "graph_churn", "hashtable", "kv_paged")


class Pair:
    """One core of the reference's sanitizer and the port's, stepped in
    lockstep; every round is held field for field and leaf for leaf."""

    def __init__(self, kind="sanitizer"):
        self.jcfg = jsys.SystemConfig(kind=kind, heap_bytes=HEAP,
                                      num_threads=T)
        self.tcfg = tsys.SystemConfig(kind=kind, heap_bytes=HEAP,
                                      num_threads=T)
        self.jst = jheap.init(self.jcfg)
        self.tst = theap.init(self.tcfg, device="cpu")
        self.check("init")

    def check(self, msg):
        want = jax.tree.map(lambda x: np.asarray(x)[None], self.jst)
        assert_state_equal(self.tst, want, msg)

    def step(self, build, *args, msg=""):
        jreq = getattr(jheap, build)(*(jnp.asarray(a, jnp.int32)
                                       for a in args))
        treq = getattr(theap, build)(*(torch.tensor(a, dtype=torch.int32)
                                       for a in args))
        self.jst, want = jheap.step(self.jcfg, self.jst, jreq)
        self.tst, got = theap.step(self.tcfg, self.tst, theap.AllocRequest(
            *(x[None] for x in treq)))
        want = jax.tree.map(lambda x: np.asarray(x)[None], want)
        assert_resp_equal(got, want, f"{build} {msg}")
        self.check(f"{build} {msg}")
        return jheap.AllocResponse(*(np.asarray(getattr(got, f)[0])
                                     for f in theap.AllocResponse._fields))

    def malloc(self, sizes):
        return self.step("malloc_request", sizes)

    def free(self, ptrs):
        return self.step("free_request", ptrs)

    def realloc(self, ptrs, sizes):
        return self.step("realloc_request", ptrs, sizes)

    def reset(self):
        jreq = jheap.epoch_reset_request(T)
        treq = theap.epoch_reset_request(T, device="cpu")
        self.jst, want = jheap.step(self.jcfg, self.jst, jreq)
        self.tst, got = theap.step(self.tcfg, self.tst, theap.AllocRequest(
            *(x[None] for x in treq)))
        assert_resp_equal(got, jax.tree.map(lambda x: np.asarray(x)[None],
                                            want), "reset")
        self.check("reset")

    @property
    def st(self):
        return self.tst

    def report(self):
        want = jsan.report(self.jst)
        got = tsan.report(self.tst)
        assert got == want
        return got


def test_registered_and_state_layout():
    assert "sanitizer" in theap.kinds()
    p = Pair()
    assert isinstance(p.st, tsan.SanitizerState)
    assert ttel.snapshot(p.tcfg, p.st)["conservation_residual"] == 0
    assert tuple(p.st.shadow.shape) == (1, HEAP // tsan.GRANULE)
    assert p.st.shadow.dtype == torch.int8
    assert tuple(p.st.q_ptr.shape) == (1, tsan.quarantine_slots(T))
    for name in ("SHADOW_FREE", "SHADOW_LIVE", "SHADOW_QUAR", "SHADOW_MOVED",
                 "SHADOW_STALE", "TAG_DOUBLE_FREE", "TAG_USE_AFTER_FREE",
                 "TAG_REALLOC_AFTER_FREE", "TAG_WILD", "TAG_EPOCH_STALE"):
        assert getattr(tsan, name) == getattr(jsan, name)
    assert tsan.TAG_NAMES == jsan.TAG_NAMES
    assert tsan.SanReports._fields == jsan.SanReports._fields


def test_double_free_is_tagged_deterministically():
    p = Pair()
    r = p.malloc([32, 256, 2048, 64])
    rf = p.free(r.ptr)
    assert rf.ok.all() and (rf.path == 0).all()
    rd = p.free(r.ptr)          # every thread frees again
    assert not rd.ok.any() and (rd.path == 2).all() and (rd.ptr == -1).all()
    assert (p.st.tags[0].numpy() == tsan.TAG_DOUBLE_FREE).all()
    assert int(p.st.reports.double_free[0]) == T
    assert int(p.st.alloc.stats.dropped_frees[0]) == T
    p.report()


def test_use_after_free_via_stale_realloc_pointer():
    p = Pair()
    r = p.malloc([64, 0, 0, 0])
    p0 = int(r.ptr[0])
    rr = p.realloc([p0, -1, -1, -1], [8192, 0, 0, 0])
    assert rr.moved[0] and int(rr.ptr[0]) != p0
    rf = p.free([p0, -1, -1, -1])   # the stale pre-realloc pointer
    assert not rf.ok[0] and int(rf.path[0]) == 2
    assert int(p.st.tags[0, 0]) == tsan.TAG_USE_AFTER_FREE
    assert int(p.st.reports.use_after_free[0]) == 1
    rf2 = p.free([int(rr.ptr[0]), -1, -1, -1])
    assert rf2.ok[0]


def test_realloc_after_free_is_tagged():
    p = Pair()
    r = p.malloc([64, 128, 0, 0])
    p.free([int(r.ptr[0]), -1, -1, -1])
    rr = p.realloc([int(r.ptr[0]), -1, -1, -1], [128, 0, 0, 0])
    assert not rr.ok[0] and int(rr.path[0]) == 3 and int(rr.ptr[0]) == -1
    assert int(p.st.tags[0, 0]) == tsan.TAG_REALLOC_AFTER_FREE
    assert int(p.st.reports.realloc_after_free[0]) == 1
    assert int(p.st.alloc.stats.fails[0]) >= 1
    rf = p.free([-1, int(r.ptr[1]), -1, -1])
    assert rf.ok[1]


def test_wild_and_misaligned_pointers_are_tagged():
    p = Pair()
    r = p.malloc([64, 0, 0, 0])
    p0 = int(r.ptr[0])
    # out of range, unmapped in range, interior (misaligned), NULL
    rf = p.free([HEAP + 8, 131072 + 16, p0 + 4, -1])
    assert (rf.path[:3] == 2).all() and int(rf.path[3]) == -1
    assert (p.st.tags[0, :3].numpy() == tsan.TAG_WILD).all()
    assert int(p.st.reports.wild_ops[0]) == 3
    assert int(p.st.alloc.stats.dropped_frees[0]) == 3
    # negative and far pointers through free and realloc (floor // and %)
    p.free([-16, -17, 2 ** 31 - 1, HEAP])
    p.realloc([-16, HEAP - 16, 2 ** 31 - 1, p0 + 8], [64, 64, 64, 64])


def test_quarantine_delays_pointer_reuse():
    """hwsw recycles a freed small block LIFO on the next malloc; the
    sanitizer parks it in the quarantine ring instead."""
    p, h = Pair(), Pair("hwsw")
    r, rh = p.malloc([64, 0, 0, 0]), h.malloc([64, 0, 0, 0])
    assert int(r.ptr[0]) == int(rh.ptr[0])  # the same inner allocator
    p.free([int(r.ptr[0]), -1, -1, -1])
    h.free([int(rh.ptr[0]), -1, -1, -1])
    r2, rh2 = p.malloc([64, 0, 0, 0]), h.malloc([64, 0, 0, 0])
    assert int(rh2.ptr[0]) == int(rh.ptr[0])   # hwsw: immediate reuse
    assert int(r2.ptr[0]) != int(r.ptr[0])     # sanitizer: still parked
    assert int(p.st.q_len[0]) == 1
    assert int(p.st.reports.quarantined[0]) == 1


def test_quarantine_overflow_evicts_fifo_and_conserves():
    """Past capacity the OLDEST entry goes to the real free path, in the
    order the ring took them; conservation holds throughout, and a
    released granule is unmapped again (a later free of it is wild)."""
    p = Pair()
    Q = tsan.quarantine_slots(T)
    rounds = Q // T + 2
    ptrs = [p.malloc([2048] * T).ptr.copy() for _ in range(rounds)]
    assert all((x >= 0).all() for x in ptrs)
    first = int(ptrs[0][0])
    for x in ptrs:
        rf = p.free(x)
        assert rf.ok.all()
        assert ttel.snapshot(p.tcfg, p.st)["conservation_residual"] == 0
    assert int(p.st.reports.quarantined[0]) == rounds * T
    assert int(p.st.reports.evicted[0]) == rounds * T - Q
    assert int(p.st.q_len[0]) == Q
    # FIFO: the ring holds the newest Q pointers, oldest at q_head
    ring = p.st.q_ptr[0].numpy()
    head = int(p.st.q_head[0])
    order = np.concatenate(ptrs)[-Q:]
    np.testing.assert_array_equal(np.roll(ring, -head), order)
    assert int(p.st.shadow[0, first // tsan.GRANULE]) == tsan.SHADOW_FREE
    p.free([first, -1, -1, -1])
    assert int(p.st.tags[0, 0]) == tsan.TAG_WILD  # released, not double


def test_epoch_reset_retires_live_starts():
    p = Pair()
    r = p.malloc([64, 2048, 8192, 0])
    p.reset()
    assert int(p.st.reports.epoch_resets[0]) == 1
    g = int(r.ptr[0]) // tsan.GRANULE
    assert int(p.st.shadow[0, g]) == tsan.SHADOW_STALE
    p.free([int(r.ptr[0]), -1, -1, -1])
    assert int(p.st.tags[0, 0]) == tsan.TAG_EPOCH_STALE
    p.realloc([-1, int(r.ptr[1]), -1, -1], [0, 4096, 0, 0])
    assert int(p.st.tags[0, 1]) == tsan.TAG_EPOCH_STALE
    assert int(p.st.reports.epoch_stale[0]) == 2
    assert p.report()["epoch_stale"] == 2


def test_report_schema():
    p = Pair()
    r = p.malloc([64, 0, 0, 0])
    p.free(r.ptr)
    rep = p.report()
    assert set(rep) == {"double_free", "use_after_free",
                        "realloc_after_free", "wild_ops", "quarantined",
                        "evicted", "epoch_resets", "epoch_stale",
                        "last_round_tags", "quarantine_backlog"}
    assert rep["last_round_tags"] == ["none"] * T
    assert rep["quarantine_backlog"] == 1


def test_multicore_misuse_stream_matches_reference():
    """Three cores, each its own misuse mix per round, through both
    `MultiCoreHeap`s: double frees, stale realloc pointers, wild pointers
    and per-core resets, every field and leaf equal every round."""
    from test_torch_arena import t32
    from test_torch_cuda import closed_loop
    cfg = dict(kind="sanitizer", heap_bytes=HEAP, num_threads=T)
    jh = jheap.MultiCoreHeap(jsys.SystemConfig(**cfg), num_cores=3)
    th = theap.MultiCoreHeap(tsys.SystemConfig(**cfg), num_cores=3,
                             device="cpu")
    rng = np.random.default_rng(9)
    dead = [[] for _ in range(3)]
    for r, (op, size, ptr, live) in enumerate(closed_loop(4, rounds=20)):
        for c in range(3):  # re-free a pointer already released
            if dead[c] and rng.random() < 0.5 and op[c, 0] != 5:
                op[c, 0], ptr[c, 0] = 2, dead[c].pop()
        want = jh.step(jheap.AllocRequest(op, size, ptr))
        got = th.step(theap.AllocRequest(*map(t32, (op, size, ptr))))
        assert_resp_equal(got, want, f"round={r}")
        assert_state_equal(th.state, jh.state, f"round={r}")
        for c, t in np.ndindex(op.shape):
            if op[c, t] == 2 and ptr[c, t] >= 0 and got.ok[c, t]:
                dead[c].append(int(ptr[c, t]))
            if got.ok[c, t] and op[c, t] in (1, 3, 4) and got.ptr[c, t] >= 0:
                live[c].append(int(got.ptr[c, t]))
    tags = th.state.reports
    assert int(tags.double_free.sum()) > 0 and int(tags.wild_ops.sum()) > 0
    assert int(tags.epoch_resets.sum()) > 0
    assert (ttel.conservation_residuals(th.cfg, th.state) == 0).all()


@pytest.mark.parametrize("name", NAMES)
def test_tape_reproduces_committed_block(name):
    tape = trace.Trace.load(str(TAPES / f"{name}.json"))
    _, state, report = replay.replay(tape, "sanitizer", device="cpu")
    assert replay.check_trace(tape, results={"sanitizer": report}) == []
    assert report["telemetry"]["conservation_residual"] == 0
    assert tsan.report(state)["double_free"] == 0
