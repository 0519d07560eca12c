"""The port's batched run-carve refill against the reference's.

The reference's fused round serves a round whose backend ops all allocate
exactly one block with one run-carve (`buddy_traverse.leftmost_block`,
`run_blocks_free`, `carve_run`), a bulk freelist refill
(`freelist.bulk_refill`) and a replay of the serial walks' LRU accesses.
The port's counterparts take an explicit leading core axis; here each is
held against the reference's under `jax.vmap` on seeded NumPy inputs, and
the round as a whole through `heap.step` against the reference's
``pallas`` (interpret mode) and ``hwsw`` kinds. The tolerance is exact
equality: every value is int32 (and the priced latencies, float32 sums of
integers and halves, are exact in any order).

At the small geometry of tests/test_torch_heap_step.py: heap 2^18 with
4 KiB blocks (nb=64, depth 6), T=4, C=3, CAP=256.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.core import pim_malloc as jpm
from repro.core import system as jsys
from repro.kernels import buddy_traverse as jbt
from repro.kernels import freelist as jfl
from repro.kernels import heap_step as jhs

from repro_torch.core import buddy as tbuddy
from repro_torch.core import heap as theap
from repro_torch.core import pim_malloc as tpm
from repro_torch.core import system as tsys
from repro_torch.kernels import buddy_traverse as tbt
from repro_torch.kernels import freelist as tfl
from repro_torch.kernels import heap_step as ths

from test_torch_cuda import BLOCK, C, CAP, GEOM, HEAP, T
from test_torch_heap import assert_resp_equal, assert_state_equal

NB = HEAP // BLOCK
DEPTH = NB.bit_length() - 1
KW = dict(heap_bytes=HEAP, block_bytes=BLOCK)


def random_trees(seed, cores=C, heap=HEAP, block=BLOCK, rounds=6):
    """[C, 2nb] trees after seeded alloc / free batches of mixed sizes:
    partly full, with stale leaves below ancestors carved as bigger blocks
    and free runs of several lengths."""
    rng = np.random.default_rng(seed)
    cfg = tbuddy.BuddyConfig(heap_bytes=heap, min_block=block)
    st = tbuddy.BuddyState(tbuddy.init(cfg, device="cpu").longest
                           .repeat(cores, 1))
    live = [[] for _ in range(cores)]
    for _ in range(rounds):
        sizes = rng.choice([block, block, 2 * block, 4 * block, 16 * block],
                           (cores, 4)).astype(np.int32)
        st, offs, _ = tbuddy.alloc_batch(cfg, st, torch.from_numpy(sizes))
        for c, b in np.ndindex(sizes.shape):
            if int(offs[c, b]) >= 0:
                live[c].append((int(offs[c, b]), int(sizes[c, b])))
        frees = np.full((cores, 3), -1, np.int32)
        fsz = np.zeros((cores, 3), np.int32)
        for c in range(cores):
            for k in range(3):
                if live[c] and rng.random() < 0.6:
                    frees[c, k], fsz[c, k] = live[c].pop(
                        rng.integers(len(live[c])))
        st, _ = tbuddy.free_batch(cfg, st, torch.from_numpy(frees),
                                  torch.from_numpy(fsz))
    return st.longest


def vmapped(fn, **kw):
    return jax.jit(jax.vmap(functools.partial(fn, **kw)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_leftmost_block_matches_reference(seed):
    tree = random_trees(seed)
    got = tbt.leftmost_block(tree, depth=DEPTH, **KW)
    want = vmapped(jbt.leftmost_block, depth=DEPTH, **KW)(tree.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ok = tree[:, 1] >= BLOCK
    assert bool(ok.any()) and (got[ok] >= 0).all() and (got < NB).all()


@pytest.mark.parametrize("window", [1, 4, 8, 32])
def test_run_blocks_free_matches_reference(window):
    """Runs from random starts and the leftmost free block, of every length
    up to the window, some past the last block (ancestors clamped)."""
    rng = np.random.default_rng(window)
    fn = vmapped(jbt.run_blocks_free, window=window, **KW)
    seen = set()
    for seed in range(4):
        tree = random_trees(10 + seed)
        lm = tbt.leftmost_block(tree, depth=DEPTH, **KW)
        for trial in range(6):
            n = rng.integers(0, window + 1, C).astype(np.int32)
            b0 = rng.integers(0, NB, C).astype(np.int32)
            if trial == 0:
                b0 = lm.numpy().astype(np.int32)
            if trial == 1:
                b0 = np.full(C, NB - 1, np.int32)  # runs that hit nb
                n = np.full(C, min(window, 3), np.int32)
            got = tbt.run_blocks_free(tree, torch.from_numpy(b0),
                                      torch.from_numpy(n), window=window, **KW)
            want = fn(tree.numpy(), b0, n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            seen.update(got.tolist())
    assert seen == {True, False}


@pytest.mark.parametrize("window", [1, 4, 8, 32])
def test_carve_run_matches_reference(window):
    """Carves of free runs from the leftmost free block (the fast path's
    use), and of runs from random starts, empty runs and runs past nb
    (writes there dropped), on trees with stale leaves."""
    rng = np.random.default_rng(100 + window)
    fn = vmapped(jbt.carve_run, window=window, **KW)
    for seed in range(4):
        tree = random_trees(20 + seed)
        lm = tbt.leftmost_block(tree, depth=DEPTH, **KW).numpy()
        for trial in range(5):
            n = rng.integers(0, window + 1, C).astype(np.int32)
            b0 = lm.astype(np.int32) if trial < 2 else \
                rng.integers(0, NB, C).astype(np.int32)
            if trial == 4:
                b0 = np.full(C, NB - 2, np.int32)
                n = np.full(C, min(window, 5), np.int32)
            before = tree.clone()
            got = tbt.carve_run(tree, torch.from_numpy(b0),
                                torch.from_numpy(n), window=window, **KW)
            assert torch.equal(tree, before), "carve_run leaves its input"
            want = fn(tree.numpy(), b0, n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_carve_run_equals_serial_walks():
    """On a free run from the leftmost free block, the carve is what n
    serial leftmost walks of one block give (the reason it is exact)."""
    cfg = tbuddy.BuddyConfig(heap_bytes=HEAP, min_block=BLOCK)
    tree = random_trees(5)
    b0 = tbt.leftmost_block(tree, depth=DEPTH, **KW)
    # the longest free run from b0 on each core, up to the window
    n = torch.zeros(C, dtype=torch.int32)
    for k in range(1, T + 1):
        kk = torch.full((C,), k, dtype=torch.int32)
        n = torch.where(tbt.run_blocks_free(tree, b0, kk, window=T, **KW)
                        & (b0 + k <= NB), kk, n)
    assert (n >= 1).all() and (n > 1).any(), n
    got = tbt.carve_run(tree, b0, n, window=T, **KW)
    for c in range(C):
        sizes = torch.full((1, int(n[c])), BLOCK, dtype=torch.int32)
        st, offs, _ = tbuddy.alloc_batch(
            cfg, tbuddy.BuddyState(tree[c:c + 1].clone()), sizes)
        assert offs[0].tolist() == [(int(b0[c]) + k) * BLOCK
                                    for k in range(int(n[c]))]
        assert torch.equal(got[c], st.longest[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_refill_matches_reference(seed):
    """Rows narrower than CAP into random threads and classes; only the
    first `width` slots of a selected row and its count change."""
    rng = np.random.default_rng(seed)
    NC, width = 8, 64
    stacks = rng.integers(-1, 1 << 18, (C, T, NC, CAP)).astype(np.int32)
    counts = rng.integers(0, CAP + 1, (C, T, NC)).astype(np.int32)
    sel = rng.random((C, T)) < 0.6
    cls = rng.integers(0, NC, (C, T)).astype(np.int32)
    rows = rng.integers(-1, 1 << 18, (C, T, width)).astype(np.int32)
    newc = rng.integers(0, width, (C, T)).astype(np.int32)
    got = tfl.bulk_refill(*(torch.from_numpy(a) for a in
                            (stacks, counts, sel, cls, rows, newc)))
    want = jax.vmap(jfl.bulk_refill)(stacks, counts, sel, cls, rows, newc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[0].numpy(), stacks)
    np.testing.assert_array_equal(got[0].numpy()[..., width:],
                                  stacks[..., width:])


# ---------------------------------------------------------------------------
# the round through heap.step: every branch of the three-way switch
# ---------------------------------------------------------------------------
@pytest.fixture
def branch_log(monkeypatch):
    """Records, for every core of every round the plain version serves,
    which backend path it took: "skip", "carve-refill", "carve-bypass",
    "carve-mixed" or "serial"."""
    log = []
    real = ths.backend_branch

    def spy(need, bypass, msizes, longest, **kw):
        out = real(need, bypass, msizes, longest, **kw)
        refill = need & ~bypass
        for c, b in enumerate(out[0].tolist()):
            if b == 1:
                kind = {(True, False): "carve-refill",
                        (False, True): "carve-bypass"}.get(
                    (bool(refill[c].any()), bool(bypass[c].any())),
                    "carve-mixed")
            else:
                kind = "skip" if b == 0 else "serial"
            log.append(kind)
        return out

    monkeypatch.setattr(ths, "backend_branch", spy)
    return log


def _heaps():
    def jcfg(kind, **kw):
        return jsys.SystemConfig(
            kind=kind, heap_bytes=HEAP, num_threads=T,
            pm=jpm.PimMallocConfig(heap_bytes=HEAP, num_threads=T, cap=CAP),
            **kw)

    def tcfg(batch):
        return tsys.SystemConfig(
            kind="fused", heap_bytes=HEAP, num_threads=T,
            pm=tpm.PimMallocConfig(heap_bytes=HEAP, num_threads=T, cap=CAP),
            kernel_batch_refill=batch)

    refs = [jheap.MultiCoreHeap(jcfg("pallas", kernel_batch_refill=True),
                                num_cores=C),
            jheap.MultiCoreHeap(jcfg("hwsw"), num_cores=C)]
    ports = [theap.MultiCoreHeap(tcfg(b), num_cores=C, device="cpu")
             for b in (True, False)]
    return refs, ports


def test_batched_refill_covers_all_backend_branches(branch_log):
    """Crafted rounds through `heap.step` of kind fused with the batched
    refill on and off, against the reference's pallas and hwsw kinds:
    an all-hit round (skip), block bypasses and class refills (run-carve,
    both flavours and mixed), an odd bypass class (serial fallback), and
    the backend frees. Every response and state leaf is equal, and a count
    shows that every branch was reached."""
    refs, ports = _heaps()
    frees = {"backend": 0}

    def check(name, *args):
        want = [getattr(h, name)(*args) for h in refs]
        got = [getattr(h, name)(*args) for h in ports]
        assert_resp_equal(got[0], want[0], name + " (on vs pallas)")
        assert_resp_equal(got[1], want[1], name + " (off vs hwsw)")
        assert_resp_equal(got[0], got[1], name + " (on vs off)")
        for h in ports:
            assert_state_equal(h.state, refs[0].state, name + " state")
        if name == "free":
            frees["backend"] += int((got[0].path == 1).sum())
        return got[0]

    def rows(*sizes):
        return np.tile(np.array(sizes, np.int32), (C, 1))

    check("malloc", rows(*[32] * T))                 # prepopulated: all hit
    blocks = check("malloc", rows(*[BLOCK] * T))     # block bypasses
    cls256 = (256).bit_length() - (16).bit_length()
    while int(ports[0].state.alloc.counts[0, 0, cls256]):  # drain a class
        check("malloc", rows(*[256] * T))
    check("malloc", rows(256, BLOCK, 256, BLOCK))    # mixed refill + bypass
    check("malloc", rows(0, 256, 0, 256))            # class refills
    check("malloc", rows(2 * BLOCK, 256, 2 * BLOCK, 16))  # odd class: serial
    check("free", blocks.ptr.numpy())                # backend frees
    n = {k: branch_log.count(k) for k in
         ("skip", "carve-refill", "carve-bypass", "carve-mixed", "serial")}
    assert all(n.values()), n
    assert frees["backend"] >= C * T, frees


def test_mixed_stream_reaches_the_run_carve():
    """The seeded mixed stream of test_torch_heap_step.py takes every
    branch, so its equality test covers the run-carve too."""
    from test_torch_cuda import initial_state, mixed_round, track_live
    rng = np.random.default_rng(11)
    state = [torch.from_numpy(x) for x in initial_state()]
    live = [[] for _ in range(C)]
    taken = set()
    for _ in range(40):
        op, size, ptr = mixed_round(rng, live)
        req = [torch.from_numpy(a) for a in (op, size, ptr)]
        pre = state[0].clone()
        out = ths.fused_heap_step(*req, *state, batch_refill=True, **GEOM)
        need = (out.m_refill | out.m_bypass).bool()
        branch = ths.backend_branch(need, out.m_bypass.bool(), req[1], pre,
                                    **KW)[0]
        taken.update(branch.tolist())
        track_live(live, op, size, ptr, out)
    assert taken == {0, 1, 2}


def test_batch_refill_resolves_as_the_reference(monkeypatch):
    """PIM_MALLOC_BATCH_REFILL sets the default (on unless 0 / false /
    off), as the reference's `_batch_refill_default`; an explicit setting
    wins, and the config's None defers to the environment."""
    for env in (None, "0", "off", "false", "1", "on", "yes"):
        if env is None:
            monkeypatch.delenv("PIM_MALLOC_BATCH_REFILL", raising=False)
        else:
            monkeypatch.setenv("PIM_MALLOC_BATCH_REFILL", env)
        assert ths.batch_refill_default() is jhs._batch_refill_default()
    assert tsys.SystemConfig().kernel_batch_refill is None
    calls = []
    real = ths.backend_branch
    monkeypatch.setattr(ths, "backend_branch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from test_torch_cuda import initial_state
    args = [torch.from_numpy(np.full((C, T), v, np.int32))
            for v in (1, BLOCK, -1)]
    for env, explicit, want in (("0", None, 0), ("1", None, 1),
                                ("0", True, 1), ("1", False, 0)):
        monkeypatch.setenv("PIM_MALLOC_BATCH_REFILL", env)
        calls.clear()
        state = [torch.from_numpy(x) for x in initial_state()]
        ths.fused_heap_step(*args, *state, batch_refill=explicit, **GEOM)
        assert len(calls) == want, (env, explicit)
