"""The port's ``fused`` heap step against the reference's ``hwsw`` kind.

`repro_torch.core.heap.MultiCoreHeap` (kind ``fused``, plain PyTorch on
CPU tensors) and the reference's `MultiCoreHeap` (kind ``hwsw``, which the
reference pins bitwise to its ``pallas`` kind) serve the same [C, T]
request stream. All nine response fields, every state leaf and the
telemetry must be equal. The tolerance is exact equality: the integer
fields are int32, and every float32 cycle term is an integer or a half far
below 2^24, so the float32 sums are exact in any order.
"""
from pathlib import Path

import jax
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

INT32_MAX = 2 ** 31 - 1


def _cfgs():
    jcfg = jsys.SystemConfig(
        kind="hwsw", heap_bytes=HEAP, num_threads=T,
        pm=jpm.PimMallocConfig(heap_bytes=HEAP, num_threads=T, cap=CAP))
    tcfg = tsys.SystemConfig(
        kind="fused", heap_bytes=HEAP, num_threads=T,
        pm=tpm.PimMallocConfig(heap_bytes=HEAP, num_threads=T, cap=CAP))
    return jcfg, tcfg


def assert_resp_equal(got, want, msg=""):
    for f in theap.AllocResponse._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"{msg} field={f}")


def assert_state_equal(got, want, msg=""):
    g, w = convert.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{msg} leaf={i}")


def _track(live, req, resp):
    op, size, ptr = (np.asarray(x) for x in req)
    rptr = resp.ptr.numpy()
    for c, t in np.ndindex(op.shape):
        if rptr[c, t] >= 0 and op[c, t] in (1, 3, 4):
            live[c].append(int(rptr[c, t]))
        elif op[c, t] == 3 and size[c, t] > 0 and ptr[c, t] >= 0:
            live[c].append(int(ptr[c, t]))  # failed realloc: old intact


def test_fused_step_matches_hwsw():
    """Raw mixed rounds plus the four builders through both heaps; the
    port's state and telemetry after every round equal the reference's."""
    jcfg, tcfg = _cfgs()
    jh = jheap.MultiCoreHeap(jcfg, num_cores=C)
    th = theap.MultiCoreHeap(tcfg, num_cores=C, device="cpu")
    assert_state_equal(th.state, jh.state, "init")
    rng = np.random.default_rng(7)
    live = [[] for _ in range(C)]
    for r in range(24):
        op, size, ptr = mixed_round(rng, live)
        req = jheap.AllocRequest(op, size, ptr)
        want = jh.step(req)
        got = th.step(theap.AllocRequest(*map(torch.from_numpy, req)))
        assert_resp_equal(got, want, f"round={r}")
        assert_state_equal(th.state, jh.state, f"round={r}")
        _track(live, req, got)
    assert tsys.fleet_accounting(
        theap.AllocRequest(*map(torch.from_numpy, req)), got) == \
        jsys.fleet_accounting(req, want)
    sizes = rng.choice([16, 100, 2048, 8192], size=(C, T)).astype(np.int32)
    for name, args in [("malloc", (sizes,)),
                       ("calloc", (np.full((C, T), 70000, np.int32),
                                   np.full((C, T), 40000, np.int32))),
                       ("realloc", (np.full((C, T), -1, np.int32), sizes)),
                       ("free", (np.full((C, T), -7, np.int32),))]:
        want = getattr(jh, name)(*args, active=np.array([1, 0, 1], bool))
        got = getattr(th, name)(*args, active=np.array([1, 0, 1], bool))
        assert_resp_equal(got, want, name)
        assert not got.ok[1].any(), "a [C] mask masks whole cores"
    assert_state_equal(th.state, jh.state, "builders")


@pytest.mark.parametrize("builder,args", [
    ("malloc_request", ([0, 16, -3, 4096],)),
    ("free_request", ([-1, 0, -9, HEAP + 3],)),
    ("realloc_request", ([-1, 64, 64, -1], [100, 0, -5, 0])),
    ("realloc_request", ([128, -1, 4096, 7], [INT32_MAX, 8, 2048, 1])),
    ("calloc_request", ([3, 65536, -1, 0], [16, 65536, 8, 4])),
])
def test_request_builders_match_reference(builder, args):
    """C-semantics guards: realloc(NULL, n), realloc(p, 0), negative sizes,
    calloc overflow, garbage frees — identical requests on both sides."""
    want = getattr(jheap, builder)(*(np.asarray(a, np.int32) for a in args))
    got = getattr(theap, builder)(*(torch.tensor(a, dtype=torch.int32)
                                    for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_calloc_bytes_match_reference():
    n = np.array([0, 1, 3, 65536, 46341, -2, 2 ** 30], np.int32)
    s = np.array([5, 0, 7, 65536, 46341, 4, 2], np.int32)
    np.testing.assert_array_equal(
        tpm.total_calloc_bytes(torch.from_numpy(n), torch.from_numpy(s))
        .numpy(), np.asarray(jpm.total_calloc_bytes(n, s)))


def test_run_rounds_matches_single_steps():
    _, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    reqs = [mixed_round(rng, [[] for _ in range(C)]) for _ in range(3)]
    tape = theap.AllocRequest(*(torch.from_numpy(np.stack(x))
                                for x in zip(*reqs)))
    st, resps = theap.run_rounds(tcfg, theap.init(tcfg, num_cores=C,
                                                  device="cpu"), tape)
    st2 = theap.init(tcfg, num_cores=C, device="cpu")
    for r in range(3):
        st2, resp = theap.step(tcfg, st2, theap.AllocRequest(
            *(x[r] for x in tape)))
        for f in theap.AllocResponse._fields:
            assert torch.equal(getattr(resps, f)[r], getattr(resp, f))
    for a, b in zip(convert.leaves(st), convert.leaves(st2)):
        assert torch.equal(a, b)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without device="cpu", the entry points and every
    public state or request constructor raise; they never fall back to the
    CPU."""
    from repro_torch.core import buddy as tbuddy
    from repro_torch.core import buddy_cache as tcache
    from repro_torch.workloads import replay, trace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    tape = trace.Trace.load(str(Path(__file__).resolve().parents[1] /
                                "benchmarks/tapes/decode_serve.json"))
    for make in (lambda: theap.init(tcfg),
                 lambda: theap.MultiCoreHeap(tcfg, num_cores=2),
                 lambda: replay.replay(tape),
                 lambda: tsys.system_init(tcfg),
                 lambda: tpm.init(tcfg.pm),
                 lambda: tbuddy.init(tcfg.pm.buddy_cfg),
                 lambda: tcache.buddy_cache_init(tcfg.bc),
                 lambda: theap.noop_request(T),
                 lambda: theap.epoch_reset_request(T)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert theap.init(tcfg, device="cpu").alloc.counts.device.type == "cpu"
    assert tsys.system_init(tcfg, device="cpu").telem.live_bytes.device \
        .type == "cpu"


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone_tree(x) for x in tree))


def _kernel_leaves(st):
    al, ca = st.alloc, st.cache
    return (al.buddy.longest, al.counts, al.stacks, al.block_cls,
            al.block_free, al.big_log2, ca.tags, ca.last_used, ca.clock)


def test_fused_step_consumes_state_on_cpu():
    """`heap.step` has one contract on both devices: the state's allocator
    and cache tensors are updated in place and returned, so the old state
    does not survive the step unless the caller cloned it."""
    _, tcfg = _cfgs()
    st = theap.init(tcfg, num_cores=C, device="cpu")
    snap = _clone_tree(st)
    req = theap.AllocRequest(*map(torch.from_numpy, mixed_round(
        np.random.default_rng(2), [[] for _ in range(C)])))
    new, resp = theap.step(tcfg, st, req)
    for old_leaf, new_leaf in zip(_kernel_leaves(st), _kernel_leaves(new)):
        assert new_leaf is old_leaf
    assert any(not torch.equal(a, b) for a, b in
               zip(_kernel_leaves(st), _kernel_leaves(snap))), \
        "the stepped-from state was not updated"
    # a clone taken before the step replays the same round
    again, resp2 = theap.step(tcfg, snap, req)
    for a, b in zip(convert.leaves(again), convert.leaves(new)):
        assert torch.equal(a, b)
    assert_resp_equal(resp2, resp, "replayed from the clone")


def test_thread_count_builders_and_epoch_reset_round():
    """noop and epoch-reset requests match the reference; the fused kind
    serves an EPOCH_RESET round as idle, exactly as hwsw does."""
    for name in ("noop_request", "epoch_reset_request"):
        want = getattr(jheap, name)(T)
        got = getattr(theap, name)(T, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jheap.epoch_reset_request(T, active=np.array([1, 0, 1, 1], bool))
    got = theap.epoch_reset_request(T, active=np.array([1, 0, 1, 1], bool),
                                    device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jcfg, tcfg = _cfgs()
    jh = jheap.MultiCoreHeap(jcfg, num_cores=C)
    th = theap.MultiCoreHeap(tcfg, num_cores=C, device="cpu")
    req = [np.broadcast_to(np.asarray(x), (C, T)).copy() for x in want]
    resp = th.step(theap.AllocRequest(*map(torch.from_numpy, req)))
    assert_resp_equal(resp, jh.step(jheap.AllocRequest(*req)), "reset")
    assert not resp.ok.any() and (resp.path == -1).all()
    assert_state_equal(th.state, jh.state, "reset")
