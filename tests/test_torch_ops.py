"""The port's kernel entry point (`repro_torch.kernels.ops`) against the
reference's (`repro.kernels.ops`) on the CPU.

Each port op runs its plain PyTorch version here (CPU tensors); it is held
against the reference's op with the Pallas kernel in interpret mode, and
each port oracle against the reference's oracle. Inputs are made with
numpy from a seed and go to both sides. The sweeps are those of
tests/test_kernels.py, plus batches that are not a multiple of 128, odd
sizes and classes, and the three reference quirks the port reproduces on
purpose (ROADMAP §C):

1. the buddy kernel fails a size <= 0; its oracle serves it as min_block;
2. `next_pow2` wraps to INT32_MIN above 2^30 on both sides, so such a size
   gets a min_block block;
3. for a class >= NC the freelist kernel updates class NC-1; the oracle
   drops the write (ptr_out agrees).

Tolerances: the integer ops bit for bit; attention at the reference's own
bounds (paged 2e-5 / 2e-2, flash 3e-5 / 2.5e-2 for fp32 / bf16, atol =
rtol): fp32 sums in another order, one bf16 rounding of the output.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buddy as jbuddy
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

GEOMS = [(1 << 14, 32), (1 << 16, 64), (1 << 18, 4096)]
INT32_MAX = 2 ** 31 - 1
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(x, dtype=None):
    """A JAX or numpy array as a torch tensor (bf16 exactly, via fp32)."""
    a = np.asarray(x.astype(jnp.float32) if dtype is not None else x)
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out.to(dtype) if dtype is not None else out


def same(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


def close(port, ref, tol, what):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def test_entry_points_take_the_reference_arguments():
    for name in ("buddy_alloc_batch", "freelist_op", "paged_attention_op",
                 "flash_attention_op", "buddy_alloc_batch_ref",
                 "freelist_op_ref", "paged_attention_ref"):
        want = [p for p in inspect.signature(getattr(jops, name)).parameters
                if p != "interpret"]
        got = list(inspect.signature(getattr(tops, name)).parameters)
        assert got == want, name


# ------------------------------------------------------------ buddy_traverse
def fresh_trees(heap, min_block, cores):
    cfg = jbuddy.BuddyConfig(heap_bytes=heap, min_block=min_block)
    return np.tile(np.asarray(jbuddy.init(cfg).longest), (cores, 1))


def check_buddy(tree, sizes, heap, min_block):
    """Port op == reference op (interpret) and port oracle == reference
    oracle, offsets and trees bit for bit; returns the port's results."""
    kw = dict(heap_bytes=heap, min_block=min_block)
    offs_j, tree_j = jops.buddy_alloc_batch(jnp.asarray(tree),
                                            jnp.asarray(sizes),
                                            interpret=True, **kw)
    offs_t, tree_t = tops.buddy_alloc_batch(t(tree), t(sizes), **kw)
    same(offs_t, offs_j, "op offsets")
    same(tree_t, tree_j, "op tree")
    roffs_j, rtree_j = jops.buddy_alloc_batch_ref(jnp.asarray(tree),
                                                  jnp.asarray(sizes), **kw)
    roffs_t, rtree_t = tops.buddy_alloc_batch_ref(t(tree), t(sizes), **kw)
    same(roffs_t, roffs_j, "oracle offsets")
    same(rtree_t, rtree_j, "oracle tree")
    return offs_t, tree_t, roffs_t, rtree_t


@pytest.mark.parametrize("heap,min_block", GEOMS)
@pytest.mark.parametrize("cores,batch", [(1, 8), (4, 16), (2, 130)])
def test_buddy_alloc_batch_matches_reference(heap, min_block, cores, batch):
    """tests/test_kernels.py's sweep, and a batch of 130 (not a multiple of
    128) with odd sizes (0, negative, above 2^30) mixed in."""
    rng = np.random.RandomState(0)
    sizes = rng.choice([min_block, min_block * 2, min_block * 7, heap // 8],
                       size=(cores, batch)).astype(np.int32)
    if batch % 128:
        odd = rng.random_sample((cores, batch)) < 0.1
        sizes[odd] = rng.choice([0, -5, 2 ** 30 + 1, INT32_MAX],
                                size=int(odd.sum()))
    check_buddy(fresh_trees(heap, min_block, cores), sizes, heap, min_block)


def test_buddy_alloc_batch_exhaustion():
    heap, mb = 1 << 12, 32
    sizes = np.full((1, 40), 128, np.int32)  # 40 * 128 > 4096: some fail
    offs, _, roffs, _ = check_buddy(fresh_trees(heap, mb, 1), sizes, heap,
                                    mb)
    assert int((offs >= 0).sum()) == heap // 128
    assert bool((offs[0, heap // 128:] == -1).all())
    assert torch.equal(offs, roffs)


def test_finding1_buddy_size_le_0():
    """The kernel fails a size <= 0; the oracle serves it as min_block."""
    sizes = np.array([[0, -5, 64, 2 ** 30 + 1, 100, INT32_MAX]], np.int32)
    offs, _, roffs, _ = check_buddy(fresh_trees(1 << 16, 64, 1), sizes,
                                    1 << 16, 64)
    assert offs.tolist() == [[-1, -1, 0, 64, 128, 256]]
    assert roffs.tolist() == [[0, 64, 128, 192, 256, 384]]


def test_finding2_next_pow2_wraps_to_min_block():
    """Above 2^30 the int32 next_pow2 wraps to INT32_MIN on both sides (in
    the op and in the oracle), so the request gets one min_block block."""
    from repro_torch.core import buddy as tbuddy
    x = np.array([1, 3, 2 ** 30, 2 ** 30 + 1, INT32_MAX, 0, -9], np.int32)
    same(tbuddy.next_pow2(t(x)), jbuddy.next_pow2(jnp.asarray(x)),
         "next_pow2")
    assert tbuddy.next_pow2(t(x)).tolist()[3:5] == [-2 ** 31, -2 ** 31]
    heap, mb = 1 << 14, 32
    sizes = np.array([[2 ** 30 + 1, INT32_MAX, 2 ** 30]], np.int32)
    offs, tree, roffs, rtree = check_buddy(fresh_trees(heap, mb, 1), sizes,
                                           heap, mb)
    # two min_block blocks side by side; 2^30 itself exceeds the heap
    assert offs.tolist() == roffs.tolist() == [[0, mb, -1]]
    assert torch.equal(tree, rtree)
    assert int(tree[0, 1]) == heap // 2  # the left half holds both blocks


# ------------------------------------------------------------------ freelist
def check_freelist(stacks, counts, op, cls, ptr):
    """Port op == reference op (interpret), port oracle == reference
    oracle, bit for bit; returns both port results."""
    args = [jnp.asarray(a) for a in (stacks, counts, op, cls, ptr)]
    targs = [t(a) for a in (stacks, counts, op, cls, ptr)]
    got = tops.freelist_op(*targs)
    for name, a, b in zip(("ptr_out", "counts", "stacks"), got,
                          jops.freelist_op(*args, interpret=True)):
        same(a, b, f"op {name}")
    rgot = tops.freelist_op_ref(*targs)
    for name, a, b in zip(("ptr_out", "counts", "stacks"), rgot,
                          jops.freelist_op_ref(*args)):
        same(a, b, f"oracle {name}")
    return got, rgot


@pytest.mark.parametrize("T,NC,CAP", [(4, 8, 64), (8, 4, 128)])
def test_freelist_op_matches_reference(T, NC, CAP):
    """tests/test_kernels.py's sweep (three chained ops), with classes -1
    and NC, and one round on counts outside [0, CAP] (a negative position
    counts from the end, then is clamped in the op and dropped in the
    oracle)."""
    rng = np.random.RandomState(1)
    counts = rng.randint(0, CAP, size=(T, NC)).astype(np.int32)
    stacks = rng.randint(0, 1 << 20, size=(T, NC, CAP)).astype(np.int32)
    op_state = ref_state = (stacks, counts)
    for trial in range(4):
        op = rng.randint(-1, 2, size=(T,)).astype(np.int32)
        cls = rng.randint(-1, NC + 1, size=(T,)).astype(np.int32)
        ptr = rng.randint(0, 1 << 20, size=(T,)).astype(np.int32)
        if trial == 3:
            cnt = np.array([-1, -CAP - 2, CAP + 3, -CAP, CAP, 0, 1, 2],
                           np.int32)[:T]
            op[:] = 1 - (np.arange(T) % 2)  # push, pop, ...
            cls[:] = 0
            op_state = (op_state[0], op_state[1].copy())
            op_state[1][:, 0] = cnt
            ref_state = (ref_state[0], ref_state[1].copy())
            ref_state[1][:, 0] = cnt
        got, _ = check_freelist(*op_state, op, cls, ptr)
        _, rgot = check_freelist(*ref_state, op, cls, ptr)
        op_state = (got[2].numpy(), got[1].numpy())
        ref_state = (rgot[2].numpy(), rgot[1].numpy())


def test_freelist_pop_empty_and_push_full():
    T, NC, CAP = 2, 2, 4
    counts = np.array([[0, 4], [1, 4]], np.int32)
    stacks = np.arange(T * NC * CAP, dtype=np.int32).reshape(T, NC, CAP)
    op = np.array([0, 1], np.int32)      # pop empty class, push full class
    cls = np.array([0, 1], np.int32)
    ptr = np.array([111, 222], np.int32)
    (pk, ck, sk), _ = check_freelist(stacks, counts, op, cls, ptr)
    assert int(pk[0]) == -1
    assert int(ck[0, 0]) == 0
    assert np.array_equal(sk[1, 1].numpy(), stacks[1, 1])


def test_finding3_freelist_class_past_nc():
    """T=3, NC=2, CAP=4: a pop on class 2 with counts[0] = [1, 2]. The op
    pops class 1 and writes its count; the oracle reads class 1 but drops
    the write. A push on class 2 likewise lands in the op's stacks only."""
    T, NC, CAP = 3, 2, 4
    stacks = (np.arange(T * NC * CAP, dtype=np.int32) + 100).reshape(
        T, NC, CAP)
    counts = np.array([[1, 2], [0, 1], [2, 2]], np.int32)
    op = np.array([0, 1, -1], np.int32)
    cls = np.array([2, 2, 2], np.int32)
    ptr = np.array([7, 8, 9], np.int32)
    (p, c, s), (rp, rc, rs) = check_freelist(stacks, counts, op, cls, ptr)
    assert p.tolist() == rp.tolist() == [stacks[0, 1, 1], -1, -1]
    assert c[0].tolist() == [1, 1] and rc[0].tolist() == [1, 2]
    assert c[1].tolist() == [0, 2] and rc[1].tolist() == [0, 1]
    assert int(s[1, 1, 1]) == 8 and np.array_equal(rs.numpy(), stacks)


# ------------------------------------------------------------ paged attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,D,pages,page_size", [
    (2, 4, 2, 128, 4, 128),
    (1, 8, 1, 128, 2, 128),   # MQA
    (3, 6, 6, 128, 3, 128),   # MHA
])
def test_paged_attention_op_matches_reference(B, H, KVH, D, pages,
                                              page_size, dtype):
    rng = np.random.RandomState(2)
    N = pages * B + 2
    jd, td = JDT[dtype], TDT[dtype]
    q = jnp.asarray(rng.randn(B, H, D), jd) * 0.1
    kp = jnp.asarray(rng.randn(N, page_size, KVH, D), jd) * 0.1
    vp = jnp.asarray(rng.randn(N, page_size, KVH, D), jd) * 0.1
    pt = rng.permutation(N)[:B * pages].reshape(B, pages).astype(np.int32)
    sl = rng.randint(1, pages * page_size, size=(B,)).astype(np.int32)
    targs = [t(q, td), t(kp, td), t(vp, td), t(pt), t(sl)]
    jargs = [q, kp, vp, jnp.asarray(pt), jnp.asarray(sl)]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    close(tops.paged_attention_op(*targs),
          jops.paged_attention_op(*jargs, interpret=True), tol, "op")
    close(tops.paged_attention_ref(*targs), jops.paged_attention_ref(*jargs),
          tol, "oracle")


def test_paged_attention_op_respects_page_table():
    rng = np.random.RandomState(3)
    H, KVH, D, page = 2, 2, 128, 128
    q = rng.randn(1, H, D).astype(np.float32)
    q2 = np.concatenate([q, q])
    kp = rng.randn(6, page, KVH, D).astype(np.float32)
    vp = rng.randn(6, page, KVH, D).astype(np.float32)
    pt = np.array([[0, 1], [2, 3]], np.int32)
    sl = np.array([2 * page, 2 * page], np.int32)
    out = tops.paged_attention_op(t(q2), t(kp), t(vp), t(pt), t(sl))
    out_sw = tops.paged_attention_op(t(q2), t(kp), t(vp),
                                     t(pt[::-1].copy()), t(sl))
    jout = jops.paged_attention_op(*(jnp.asarray(a) for a in
                                     (q2, kp, vp, pt, sl)), interpret=True)
    close(out, jout, 2e-5, "op")
    torch.testing.assert_close(out[0], out_sw[1], atol=1e-6, rtol=0)
    assert not torch.allclose(out[0], out[1])


# ------------------------------------------------------------ flash attention
def flash_case(seed, B, S, T, H, KVH, hd, dtype, mag):
    rng = np.random.RandomState(seed)
    jd = JDT[dtype]
    return [jnp.asarray(rng.randn(B, n, h, hd), jd) * mag
            for n, h in ((S, H), (T, KVH), (T, KVH))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KVH,hd,causal,window", [
    (2, 256, 256, 4, 2, 128, True, 0),
    (1, 512, 512, 4, 1, 128, True, 128),   # MQA + sliding window
    (2, 128, 384, 6, 6, 128, False, 0),    # MHA, cross-shaped (S != T)
    (1, 96, 320, 4, 2, 64, False, 100),    # window without causal, S != T
])
def test_flash_attention_op_matches_reference(B, S, T, H, KVH, hd, causal,
                                              window, dtype):
    jargs = flash_case(7, B, S, T, H, KVH, hd, dtype, 0.2)
    targs = [t(a, TDT[dtype]) for a in jargs]
    kw = dict(causal=causal, window=window, block_q=128, block_kv=128)
    got = tops.flash_attention_op(*targs, **kw)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, hd)
    tol = 2.5e-2 if dtype == "bfloat16" else 3e-5
    close(got, jops.flash_attention_op(*jargs, interpret=True, **kw), tol,
          "flash op")


def test_flash_attention_op_odd_blocks():
    """Block sizes that do not divide S: the reference fits 96-row blocks;
    the port's function does not depend on them."""
    jargs = flash_case(8, 1, 192, 192, 2, 2, 64, "float32", 0.3)
    targs = [t(a) for a in jargs]
    want = jops.flash_attention_op(*jargs, causal=True, block_q=128,
                                   block_kv=128, interpret=True)
    for bq, bkv in ((128, 128), (512, 64), (7, 1000)):
        got = tops.flash_attention_op(*targs, causal=True, block_q=bq,
                                      block_kv=bkv)
        close(got, want, 3e-5, f"blocks {bq}/{bkv}")


# ------------------------------------------------------------ routing rule
def test_ops_raise_off_cuda_and_cpu():
    tree = torch.zeros((1, 1024), dtype=torch.int32, device="meta")
    sizes = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.buddy_alloc_batch(tree, sizes, heap_bytes=1 << 14, min_block=32)
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.freelist_op(torch.zeros((2, 2, 4), **i32),
                         torch.zeros((2, 2), **i32),
                         *(torch.zeros(2, **i32) for _ in range(3)))
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention_op(q, q, q)
    cpu = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="block"):
        tops.flash_attention_op(cpu, cpu, cpu, block_q=0)
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention_op(cpu, cpu, cpu, window=-1)
    with pytest.raises(ValueError, match="tree must be"):
        tops.buddy_alloc_batch(torch.zeros((1, 512), dtype=torch.int32),
                               torch.zeros((1, 4), dtype=torch.int32),
                               heap_bytes=1 << 14, min_block=32)
