"""The port's scan-based ``sw`` and ``hwsw`` kinds against the reference's.

`repro_torch.core.heap.MultiCoreHeap` (plain PyTorch on CPU tensors) and
the reference's `MultiCoreHeap` (``jax.vmap`` of its per-core step) serve
the same seeded ``[C, T]`` stream: allocs of every size regime, calloc
overflow, NULL, garbage and double frees, reallocs into, out of and
within bypass, size 0, sizes above 2^30 and REALLOC of INT32_MAX. Every
response field and every state leaf (allocator, metadata cache,
telemetry) must be equal after every round; float32 fields bitwise. On
the same stream the port's ``fused`` kind must equal its ``hwsw``, and
`HeapClient.gc` must leave the reference's state.
"""
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import pim_malloc as jpm
from repro.core import system as jsys

from repro_torch import convert
from repro_torch.core import heap as theap
from repro_torch.core import pim_malloc as tpm
from repro_torch.core import system as tsys

from test_torch_cuda import C, CAP, HEAP, T, mixed_round
from test_torch_heap import _track as track
from test_torch_heap import assert_resp_equal, assert_state_equal

ROUNDS = 12


def port_cfg(kind, heap_bytes=HEAP, threads=T, cap=CAP):
    return tsys.SystemConfig(
        kind=kind, heap_bytes=heap_bytes, num_threads=threads,
        pm=tpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                               cap=cap))


def cfg_pair(kind, heap_bytes=HEAP, threads=T, cap=CAP):
    jcfg = jsys.SystemConfig(
        kind=kind, heap_bytes=heap_bytes, num_threads=threads,
        pm=jpm.PimMallocConfig(heap_bytes=heap_bytes, num_threads=threads,
                               cap=cap))
    return jcfg, port_cfg(kind, heap_bytes, threads, cap)


def stream(seed, rounds=ROUNDS, plant=True):
    """The seeded mixed rounds; with `plant`, one pointer freed by two
    threads in round 5 (a same-round race: the reference's ``pallas`` and
    ``hwsw`` kinds answer it differently, each held to its own)."""
    rng = np.random.default_rng(seed)
    live = [[] for _ in range(C)]
    for r in range(rounds):
        op, size, ptr = mixed_round(rng, live)
        if plant and r == 5 and live[0]:
            p = live[0][0]
            op[0, :2], ptr[0, :2], size[0, :2] = 2, p, 0
        yield op, size, ptr, live


def run_differential(kind, seed=7):
    jcfg, tcfg = cfg_pair(kind)
    jh = jheap.MultiCoreHeap(jcfg, num_cores=C)
    th = theap.MultiCoreHeap(tcfg, num_cores=C, device="cpu")
    assert_state_equal(th.state, jh.state, "init")
    for r, (op, size, ptr, live) in enumerate(stream(seed)):
        req = jheap.AllocRequest(op, size, ptr)
        want = jh.step(req)
        got = th.step(theap.AllocRequest(*map(torch.from_numpy, req)))
        assert_resp_equal(got, want, f"{kind} round={r}")
        assert_state_equal(th.state, jh.state, f"{kind} round={r}")
        track(live, req, got)
    return jh, th


@pytest.mark.parametrize("kind", ["sw", "hwsw"])
def test_scan_kind_matches_reference(kind):
    jh, th = run_differential(kind)
    # the builders with a [C] core mask, as the reference vmaps them
    rng = np.random.default_rng(3)
    sizes = rng.choice([16, 100, 2048, 8192], size=(C, T)).astype(np.int32)
    for name, args in [("malloc", (sizes,)),
                       ("calloc", (np.full((C, T), 70000, np.int32),
                                   np.full((C, T), 40000, np.int32))),
                       ("realloc", (np.full((C, T), -1, np.int32), sizes)),
                       ("free", (np.full((C, T), -7, np.int32),))]:
        want = getattr(jh, name)(*args, active=np.array([1, 0, 1], bool))
        got = getattr(th, name)(*args, active=np.array([1, 0, 1], bool))
        assert_resp_equal(got, want, name)
    assert_state_equal(th.state, jh.state, "builders")


def test_fused_equals_hwsw_on_the_stream():
    h = theap.MultiCoreHeap(port_cfg("hwsw"), num_cores=C, device="cpu")
    f = theap.MultiCoreHeap(port_cfg("fused"), num_cores=C, device="cpu")
    for r, (op, size, ptr, live) in enumerate(stream(11, plant=False)):
        req = theap.AllocRequest(*map(torch.from_numpy, (op, size, ptr)))
        want = h.step(req)
        got = f.step(req)
        for fld in theap.AllocResponse._fields:
            assert torch.equal(getattr(got, fld), getattr(want, fld)), \
                (r, fld)
        for a, b in zip(convert.leaves(f.state), convert.leaves(h.state)):
            assert torch.equal(a, b), r
        track(live, (op, size, ptr), got)


def test_new_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without device="cpu", the entry points of the
    scan-based kinds raise; they never fall back to the CPU."""
    from pathlib import Path
    from repro_torch.core import api, buddy_cache
    from repro_torch.kvcache import paged
    from repro_torch.workloads import replay, trace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tape = trace.Trace.load(str(Path(__file__).resolve().parents[1] /
                                "benchmarks/tapes/decode_serve.json"))
    for make in (
            lambda: theap.multicore_init(port_cfg("sw"), 2),
            lambda: theap.init(port_cfg("strawman")),
            lambda: tsys.system_init(port_cfg("hwsw")),
            lambda: tsys.strawman_init(tsys.StrawmanConfig()),
            lambda: buddy_cache.sw_buffer_init(buddy_cache.SWBufferConfig()),
            lambda: port_cfg("sw").cache_init(),
            lambda: replay.replay(tape, "strawman"),
            lambda: replay.replay_all_kinds(tape),
            lambda: replay.attach_expectations(tape),
            lambda: api.HeapClient(kind="hwsw"),
            lambda: paged.PagePool(1 << 16, kind="strawman")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tsys.SystemConfig().kind == api.HeapClient.__init__.__defaults__[
        -2] == "sw"
    assert theap.multicore_init(port_cfg("sw"), 2, device="cpu").cache \
        .tags.shape == (2, 8)
