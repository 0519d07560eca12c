"""The port's buddy allocator (`repro_torch.core.buddy`) against the
reference's (`repro.core.buddy`), bit for bit: offsets, trees, free bytes
and every `BuddyEvent` field (ok, levels_down, levels_up, trace).

The reference is `vmap`ped over cores; the port takes the core axis
explicitly. Inputs are made with numpy from a seed and go to both sides.
The streams reach exhaustion, sizes 0, negative and above 2^30 (the int32
`next_pow2` wrap: such a size gets a `min_block` block), and frees at -1,
at and beyond the heap, and double frees.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buddy as jbuddy
from repro_torch.core import buddy as tbuddy

GEOMS = [(1 << 14, 32), (1 << 16, 64), (1 << 18, 4096)]
INT32_MAX = 2 ** 31 - 1
ODD_SIZES = (0, -5, -(2 ** 31), 2 ** 30 + 1, INT32_MAX)


@functools.lru_cache(maxsize=None)
def ref_fns(heap, min_block):
    """The reference's functions for one geometry, vmapped over cores."""
    cfg = jbuddy.BuddyConfig(heap_bytes=heap, min_block=min_block)
    st = jbuddy.BuddyState

    def alloc(tree, size):
        s, off, ev = jbuddy.alloc(cfg, st(tree), size)
        return s.longest, off, ev

    def free(tree, off, size):
        s, ev = jbuddy.free(cfg, st(tree), off, size)
        return s.longest, ev

    def alloc_batch(tree, sizes):
        s, offs, ev = jbuddy.alloc_batch(cfg, st(tree), sizes)
        return s.longest, offs, ev

    def free_batch(tree, offs, sizes):
        s, ev = jbuddy.free_batch(cfg, st(tree), offs, sizes)
        return s.longest, ev

    return {
        "alloc": jax.jit(jax.vmap(alloc)),
        "free": jax.jit(jax.vmap(free)),
        "alloc_batch": jax.jit(jax.vmap(alloc_batch)),
        "free_batch": jax.jit(jax.vmap(free_batch)),
        "free_bytes": jax.jit(jax.vmap(
            lambda t: jbuddy.free_bytes(cfg, st(t)))),
        "init": lambda C: np.tile(np.asarray(jbuddy.init(cfg).longest),
                                  (C, 1)),
    }


def port_cfg(heap, min_block):
    return tbuddy.BuddyConfig(heap_bytes=heap, min_block=min_block)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def assert_same(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


def assert_events(ev_t, ev_j, what):
    for name in tbuddy.BuddyEvent._fields:
        assert_same(getattr(ev_t, name), getattr(ev_j, name),
                    f"{what}: event field {name}")


def request_sizes(rng, heap, min_block, shape):
    """Sizes from min_block / 2 to heap / 2 (log-uniform), with ~8 % each
    of the odd sizes (0, negative, above 2^30)."""
    lo, hi = np.log(max(min_block // 2, 1)), np.log(heap // 2)
    sizes = np.exp(rng.uniform(lo, hi, size=shape)).astype(np.int64)
    odd = rng.random(shape) < 0.25
    sizes[odd] = rng.choice(ODD_SIZES, size=int(odd.sum()))
    return sizes.astype(np.int32)


def test_config_and_init_match():
    for heap, mb in GEOMS:
        cfg, jcfg = port_cfg(heap, mb), jbuddy.BuddyConfig(heap, mb)
        assert (cfg.depth, cfg.n_leaf, cfg.n_nodes, cfg.trace_len) == \
            (jcfg.depth, jcfg.n_leaf, jcfg.n_nodes, jcfg.trace_len)
        assert_same(tbuddy.init(cfg, device="cpu").longest,
                    jbuddy.init(jcfg).longest, "init")


@pytest.mark.parametrize("heap,min_block", GEOMS)
@pytest.mark.parametrize("cores", [1, 4])
def test_batches_match_reference(heap, min_block, cores):
    """alloc_batch, then free_batch of a permutation of what was allocated
    plus invalid and double frees, then alloc_batch again; free_bytes
    after each; the trees exhaust."""
    rng = np.random.default_rng(heap + cores)
    cfg = port_cfg(heap, min_block)
    ref = ref_fns(heap, min_block)
    tree = ref["init"](cores)
    B = 24
    sizes = request_sizes(rng, heap, min_block, (cores, B))
    tree_j, offs_j, ev_j = ref["alloc_batch"](jnp.asarray(tree),
                                              jnp.asarray(sizes))
    st, offs_t, ev_t = tbuddy.alloc_batch(
        cfg, tbuddy.BuddyState(t(tree)), t(sizes))
    assert_same(offs_t, offs_j, "alloc_batch offsets")
    assert_same(st.longest, tree_j, "alloc_batch tree")
    assert_events(ev_t, ev_j, "alloc_batch")
    assert_same(tbuddy.free_bytes(cfg, st), ref["free_bytes"](tree_j),
                "free_bytes after alloc")
    assert bool((offs_t[sizes <= 0] >= 0).any()), "size <= 0 allocates"

    # frees: the allocations in a shuffled order, each live block twice
    # (the second a double free), plus -1, heap and heap + min_block
    offs = np.asarray(offs_j)
    f_off = np.full((cores, 2 * B + 3), -1, np.int32)
    f_size = np.zeros_like(f_off)
    for c in range(cores):
        order = rng.permutation(B)
        o = np.concatenate([offs[c, order], offs[c, order[:B]],
                            [-1, heap, heap + min_block]])
        s = np.concatenate([sizes[c, order], sizes[c, order[:B]],
                            [min_block, min_block, 3 * min_block]])
        f_off[c], f_size[c] = o, s
    tree2_j, fev_j = ref["free_batch"](tree_j, jnp.asarray(f_off),
                                       jnp.asarray(f_size))
    st2, fev_t = tbuddy.free_batch(cfg, st, t(f_off), t(f_size))
    assert_same(st2.longest, tree2_j, "free_batch tree")
    assert_events(fev_t, fev_j, "free_batch")
    assert_same(tbuddy.free_bytes(cfg, st2), ref["free_bytes"](tree2_j),
                "free_bytes after free")
    assert not bool(fev_t.ok[:, B:].any()), "double or invalid free served"
    assert bool((tbuddy.free_bytes(cfg, st2) == heap).all())

    # refill until exhaustion: requests of heap / 8 at 12 per core
    sizes3 = np.full((cores, 12), heap // 8, np.int32)
    sizes3[:, 3] = 0
    tree3_j, offs3_j, ev3_j = ref["alloc_batch"](tree2_j,
                                                 jnp.asarray(sizes3))
    st3, offs3_t, ev3_t = tbuddy.alloc_batch(cfg, st2, t(sizes3))
    assert_same(offs3_t, offs3_j, "exhaustion offsets")
    assert_same(st3.longest, tree3_j, "exhaustion tree")
    assert_events(ev3_t, ev3_j, "exhaustion")
    # the size-0 request takes min_block out of one eighth: 8 of 12 fit
    assert int((offs3_t < 0).sum()) == 4 * cores
    assert_same(tbuddy.free_bytes(cfg, st3), ref["free_bytes"](tree3_j),
                "free_bytes at exhaustion")


@pytest.mark.parametrize("heap,min_block", GEOMS)
def test_single_ops_match_reference(heap, min_block):
    """alloc and free one request per core, each core a different case:
    odd sizes, a whole-heap request, a too-big one, and frees of live,
    stale, misaligned and out-of-range offsets."""
    cfg = port_cfg(heap, min_block)
    ref = ref_fns(heap, min_block)
    cores = 8
    tree = ref["init"](cores)
    sizes = np.array([0, -5, 2 ** 30 + 1, INT32_MAX, heap, heap + 1,
                      min_block, 3 * min_block], np.int32)
    tree_j, off_j, ev_j = ref["alloc"](jnp.asarray(tree), jnp.asarray(sizes))
    st, off_t, ev_t = tbuddy.alloc(cfg, tbuddy.BuddyState(t(tree)), t(sizes))
    assert_same(off_t, off_j, "alloc offsets")
    assert_same(st.longest, tree_j, "alloc tree")
    assert_events(ev_t, ev_j, "alloc")
    assert off_t.tolist()[:5] == [0, 0, 0, 0, 0] and off_t[5] == -1

    off = np.asarray(off_j).copy()
    off[1] += min_block       # misaligned within the block: not allocated
    off[3] = -1
    off[4] = heap
    off[5] = -heap - 7        # a negative node: JAX reads from the end
    off[6] = 2 ** 30          # far past the tree: the read is clamped
    fsize = sizes.copy()
    fsize[7] = min_block      # wrong size: another node
    tree2_j, fev_j = ref["free"](tree_j, jnp.asarray(off), jnp.asarray(fsize))
    st2, fev_t = tbuddy.free(cfg, st, t(off), t(fsize))
    assert_same(st2.longest, tree2_j, "free tree")
    assert_events(fev_t, fev_j, "free")
    assert fev_t.ok.tolist() == [True, False, True, False, False, False,
                                 False, False]
    # the input states are left as they were
    assert_same(st.longest, tree_j, "alloc input kept")


def test_alloc_host_is_the_serial_walk():
    """`alloc_host`, the prepopulate carve's walk, equals `alloc` on one
    core."""
    cfg = port_cfg(1 << 16, 64)
    st1 = tbuddy.init(cfg, device="cpu")
    st = tbuddy.BuddyState(st1.longest[None])
    for size in (64, 100, 4096, 64, 1 << 15, 1 << 14, 1 << 16):
        st1, off1 = tbuddy.alloc_host(cfg, st1, size)
        st, off, _ = tbuddy.alloc(cfg, st, torch.tensor([size],
                                                        dtype=torch.int32))
        assert off1 == int(off[0])
        assert torch.equal(st1.longest, st.longest[0])
