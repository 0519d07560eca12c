"""The port's ``strawman`` kind (buddy_alloc_PIM_DRAM: one buddy tree of
32 B leaves over the whole heap, the coarse SW metadata buffer) against
the reference's, on the CPU.

The same seeded ``[C, T]`` stream as the ``sw`` / ``hwsw`` differential
(`test_torch_scan_pim.stream`) goes through both `MultiCoreHeap`s; every
response field and every state leaf (the tree, the int8 leaf table, the
SW buffer, the telemetry) must be equal after every round, float32
latencies bitwise. Then the straw-man primitives on their own, with their
events, and the round drivers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import heap as jheap
from repro.core import system as jsys

from repro_torch.core import heap as theap
from repro_torch.core import system as tsys

from test_torch_cuda import C, T
from test_torch_scan_pim import (assert_resp_equal, assert_state_equal,
                                 cfg_pair, run_differential)


def test_strawman_matches_reference():
    jh, th = run_differential("strawman", seed=5)
    assert th.state.alloc.leaf_log2.dtype == torch.int8


def _events_equal(got, want, msg):
    for f, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{msg} {f}")


def test_strawman_primitives_match_reference():
    """strawman_malloc / strawman_free / the realloc meta, with their
    events (path, backend order, levels, traces): two threads freeing one
    block, NULL, garbage and untracked frees, sizes 0, above the heap and
    above 2^30."""
    jcfg, tcfg = cfg_pair("strawman")
    jst = jheap.multicore_init(jcfg, C).alloc
    tst = theap.multicore_init(tcfg, C, device="cpu").alloc
    sizes = np.array([[32, 0, 1000, 4096], [17, 2 ** 30 + 5, 40000, -3],
                      [64, 64, 64, jcfg.heap_bytes + 1]], np.int32)
    active = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 0, 1, 1]], bool)
    jm = jax.vmap(functools.partial(jsys.strawman_malloc, jcfg.straw))
    jst, jp, jev = jm(jst, jnp.asarray(sizes), jnp.asarray(active))
    tst, tp, tev = tsys.strawman_malloc(tcfg.straw, tst,
                                        torch.from_numpy(sizes),
                                        torch.from_numpy(active))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _events_equal(tev, jev, "malloc")
    ptrs = np.asarray(jp).copy()
    ptrs[0, 1] = ptrs[0, 0]        # freed twice in one round
    ptrs[1, 3] = 40                # inside a live block, not its base
    ptrs[2, 3] = -9                # garbage
    sizes2 = np.array([[100, 0, 4096, 8], [17, 64, 0, 70000],
                       [2 ** 31 - 1, 32, 33, 1]], np.int32)
    meta_j = jax.vmap(functools.partial(jsys._strawman_realloc_meta,
                                        jcfg.straw))(
        jst, jnp.asarray(ptrs), jnp.asarray(sizes2))
    meta_t = tsys._strawman_realloc_meta(tcfg.straw, tst,
                                         torch.from_numpy(ptrs),
                                         torch.from_numpy(sizes2))
    _events_equal(meta_t, meta_j, "realloc meta")
    jf = jax.vmap(functools.partial(jsys.strawman_free, jcfg.straw))
    jst, jfev = jf(jst, jnp.asarray(ptrs), jnp.ones((C, T), bool))
    tst, tfev = tsys.strawman_free(tcfg.straw, tst, torch.from_numpy(ptrs))
    _events_equal(tfev, jfev, "free")
    for g, w in zip((tst.buddy.longest, tst.leaf_log2),
                    (jst.buddy.longest, jst.leaf_log2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_round_drivers_match_reference():
    """malloc_round / free_round / run_alloc_rounds /
    run_alloc_free_rounds, whose RoundInfo equals the reference's, and
    heap.run_alloc_free_rounds, whose responses carry the same RoundInfo
    fields."""
    jcfg, tcfg = cfg_pair("strawman")
    rng = np.random.default_rng(4)
    sizes = rng.choice([0, 16, 300, 5000, 70000], size=(3, C, T)) \
        .astype(np.int32)
    jvm = jax.jit(jax.vmap(functools.partial(jsys.run_alloc_free_rounds,
                                             jcfg), in_axes=(0, 1)))
    jst, ja, jf = jvm(jheap.multicore_init(jcfg, C), jnp.asarray(sizes))
    tst, ta, tf = tsys.run_alloc_free_rounds(
        tcfg, theap.multicore_init(tcfg, C, device="cpu"),
        torch.from_numpy(sizes))
    for g, w in ((ta, ja), (tf, jf)):
        for f in g._fields:  # the reference's leaves are [C, R, T]
            np.testing.assert_array_equal(
                getattr(g, f).numpy(),
                np.swapaxes(np.asarray(getattr(w, f)), 0, 1), err_msg=f)
    assert_state_equal(tst, jst, "run_alloc_free_rounds")
    jvm = jax.jit(jax.vmap(functools.partial(jsys.run_alloc_rounds, jcfg),
                           in_axes=(0, 1)))
    jst, jp, ji = jvm(jst, jnp.asarray(sizes))
    tst, tp, ti = tsys.run_alloc_rounds(tcfg, tst, torch.from_numpy(sizes))
    np.testing.assert_array_equal(tp.numpy(),
                                  np.swapaxes(np.asarray(jp), 0, 1))
    for f in ti._fields:
        np.testing.assert_array_equal(
            getattr(ti, f).numpy(),
            np.swapaxes(np.asarray(getattr(ji, f)), 0, 1), err_msg=f)
    # heap.run_alloc_free_rounds from a fresh state serves the same rounds
    _, hra, hrf = theap.run_alloc_free_rounds(
        tcfg, theap.multicore_init(tcfg, C, device="cpu"),
        torch.from_numpy(sizes))
    for g, w in ((hra, ja), (hrf, jf)):
        for f in w._fields:
            np.testing.assert_array_equal(
                getattr(g, f).numpy(),
                np.swapaxes(np.asarray(getattr(w, f)), 0, 1), err_msg=f)
    # malloc_round / free_round on the multicore step
    jst2, jp2, ji2 = jax.jit(jax.vmap(functools.partial(
        jsys.malloc_round, jcfg)))(jst, jnp.asarray(sizes[0]))
    tst2, tp2, ti2 = tsys.malloc_round(tcfg, tst, torch.from_numpy(sizes[0]))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
    jst3, jif = jax.jit(jax.vmap(functools.partial(jsys.free_round,
                                                   jcfg)))(jst2, jp2)
    tst3, tif = tsys.free_round(tcfg, tst2, tp2)
    for g, w in ((ti2, ji2), (tif, jif)):
        for f in g._fields:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)), f)
    assert_state_equal(tst3, jst3, "malloc_round + free_round")
    assert isinstance(ti2, tsys.RoundInfo)
    res = theap.multicore_step(tcfg, tst3, theap.malloc_request(
        torch.from_numpy(sizes[1])))
    want = jheap.multicore_step(jcfg, jst3, jax.vmap(jheap.malloc_request)(
        jnp.asarray(sizes[1])))
    assert_resp_equal(res[1], want[1], "multicore_step")


def test_strawman_client_matches_reference():
    """`HeapClient(kind="strawman")`: the same pointers and latencies, no
    counters (stats {}), gc a no-op, the same telemetry (the frontend
    holds 0 bytes)."""
    from repro.core import api as japi
    from repro_torch.core import api as tapi
    jc = japi.HeapClient(heap_bytes=1 << 18, kind="strawman")
    tc = tapi.HeapClient(heap_bytes=1 << 18, kind="strawman", device="cpu")
    sizes = np.array([0, 16, 33, 4096, 5000, 70000, 100, 1 << 17, 1, 2, 3,
                      2 ** 30 + 1, 64, 64, 64, 64], np.int32)
    want = jc.malloc_batch(jnp.asarray(sizes))
    got = tc.malloc_batch(sizes)
    assert_resp_equal(got, want, "malloc_batch")
    assert tc.realloc(int(got.ptr[3]), 9000, thread=2) == \
        jc.realloc(int(want.ptr[3]), 9000, thread=2)
    jc.gc()
    tc.gc()
    assert tc.stats == jc.stats == {}
    assert tc.telemetry() == jc.telemetry()
    assert tc.telemetry()["cached_frontend_bytes"] == 0
