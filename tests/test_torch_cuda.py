"""The CUDA kernels against their plain PyTorch versions, on the card, and
the heap kinds on the card against the CPU.

This file imports nothing of JAX or of the reference, so that it runs on a
GPU machine that has neither; on a machine without a GPU its card tests
skip with a reason. It also holds the seeded mixed-op stream, the
closed-loop stream with epoch resets and the paged-attention sweep that
the CPU differential tests (test_torch_heap_step.py,
test_torch_paged_attention.py, test_torch_arena.py,
test_torch_sanitizer.py) share.

The heap-step kernel's tolerance is exact equality: all 31 outputs of a
round are int32. The paged-attention kernel's are stated at `TOL`.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke

from repro_torch.core import heap, pim_malloc, system  # noqa: E402
from repro_torch.kernels import heap_step as ths  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

HEAP = 1 << 18
BLOCK = 4096
T = 4
C = 3
CAP = 256
CLASSES = (16, 32, 64, 128, 256, 512, 1024, 2048)
INT32_MAX = 2 ** 31 - 1
GEOM = dict(heap_bytes=HEAP, block_bytes=BLOCK, size_classes=CLASSES)

pytestmark = pytest.mark.cuda  # every test here runs on the card

SIZES = (16, 48, 100, 256, 2048, 3000, 4096, 8192, 65536, HEAP + 1)
RE_SIZES = (0, 16, 100, 128, 2048, 3000, 8192, INT32_MAX)
GARBAGE = (-1, -7, HEAP, HEAP + BLOCK, INT32_MAX)


def small_cfg(threads=T, heap_bytes=HEAP):
    return system.SystemConfig(
        kind="fused", heap_bytes=heap_bytes, num_threads=threads,
        pm=pim_malloc.PimMallocConfig(heap_bytes=heap_bytes,
                                      num_threads=threads, cap=CAP))


def initial_state(num_cores=C, threads=T, heap_bytes=HEAP):
    """The prepopulated state as [C]-stacked NumPy leaves, in
    `ths.FusedRoundOut` state order."""
    st = heap.init(small_cfg(threads, heap_bytes), num_cores=num_cores,
                   device="cpu")
    al, ca = st.alloc, st.cache
    return [x.numpy() for x in (al.buddy.longest, al.counts, al.stacks,
                                al.block_cls, al.block_free, al.big_log2,
                                ca.tags, ca.last_used, ca.clock)]


def mixed_round(rng, live, threads=T, heap_bytes=HEAP):
    """One [C, T] round of raw protocol ops reaching every path: allocs of
    every size regime (hit, refill, bypass, too big, exhaustion), calloc
    with an overflowed size, frees of live, NULL and garbage pointers to
    any thread of the core (so freelists overflow), reallocs of every
    kind. `live[c]` is the core's pool of live pointers; a popped pointer
    is never used twice in one round."""
    cores = len(live)
    op = np.zeros((cores, threads), np.int32)
    size = np.zeros((cores, threads), np.int32)
    ptr = np.full((cores, threads), -1, np.int32)
    block_round = rng.random() < 0.15  # all-block rounds: batched fast path
    for c in range(cores):
        pool = live[c]
        for t in range(threads):
            r = rng.random()

            def take():
                if pool and rng.random() < 0.85:
                    return pool.pop(rng.integers(len(pool)))
                return int(rng.choice(GARBAGE))

            if block_round:
                op[c, t], size[c, t] = 1, BLOCK
            elif r < 0.35:
                op[c, t], size[c, t] = 1, min(rng.choice(SIZES),
                                              heap_bytes + 1)
            elif r < 0.45:
                op[c, t], size[c, t] = 4, rng.choice((48, 100, INT32_MAX))
            elif r < 0.7:
                op[c, t], ptr[c, t] = 2, take()
            elif r < 0.92:
                op[c, t], ptr[c, t] = 3, take()
                size[c, t] = rng.choice(RE_SIZES)
    return op, size, ptr


def track_live(live, op, size, ptr, out):
    """Update the per-core live pools from one round's records."""
    m_ptr, in_place, moved = (np.asarray(getattr(out, f)) for f in
                              ("m_ptr", "in_place", "moved_raw"))
    for c, t in np.ndindex(op.shape):
        o = op[c, t]
        if o in (1, 4) and m_ptr[c, t] >= 0:
            live[c].append(int(m_ptr[c, t]))
        elif o == 3 and size[c, t] > 0:
            if in_place[c, t]:
                live[c].append(int(ptr[c, t]))
            elif moved[c, t] and m_ptr[c, t] >= 0:
                live[c].append(int(m_ptr[c, t]))
            elif ptr[c, t] >= 0:
                live[c].append(int(ptr[c, t]))  # failed realloc: old intact


def assert_outputs_equal(got, want, msg):
    for f, g, w in zip(ths.FusedRoundOut._fields, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} field={f}")


def coverage(tally, op, size, ptr, out, heap_bytes=HEAP):
    o = {f: np.asarray(getattr(out, f)) for f in ths.FusedRoundOut._fields}
    need = (o["m_refill"] | o["m_bypass"]).astype(bool)
    for key, hits in {
        "hit": o["m_hit"], "refill": o["m_refill"], "bypass": o["m_bypass"],
        "fail_exhausted": need & (o["m_okb"] == 0),
        "fail_too_big": ((op == 1) | (op == 4)) & (size > heap_bytes),
        "free_small": o["f_push"], "free_big": o["f_big"],
        "free_dropped_full": o["f_over"],
        "realloc_in_place": o["in_place"],
        "realloc_moved": o["moved_raw"].astype(bool) & (o["m_ptr"] >= 0)
        & o["valid_old"].astype(bool),
        "realloc_size0": (op == 3) & (size == 0) & (ptr >= 0),
        "realloc_int32_max": (op == 3) & (size == INT32_MAX),
        "calloc_overflow": (op == 4) & (size == INT32_MAX),
        "free_null": (op == 2) & (ptr == -1),
        "free_garbage": (op == 2) & ((ptr < -1) | (ptr >= heap_bytes)),
    }.items():
        tally[key] = tally.get(key, 0) + int(np.sum(hits))


def drive(run_ref, run_new, rounds, seed, threads=T, heap_bytes=HEAP):
    """Feed both rounds the same NumPy inputs for `rounds` rounds; the state
    carried forward is `run_new`'s. Returns the path coverage tally."""
    rng = np.random.default_rng(seed)
    state = initial_state(threads=threads, heap_bytes=heap_bytes)
    live = [[] for _ in range(C)]
    tally = {}
    for r in range(rounds):
        op, size, ptr = mixed_round(rng, live, threads, heap_bytes)
        args = [op, size, ptr] + state
        want = run_ref(*args)
        got = run_new(args)
        assert_outputs_equal(got, want, f"seed={seed} round={r}")
        out = ths.FusedRoundOut(*(x.cpu().numpy() for x in got))
        coverage(tally, op, size, ptr, out, heap_bytes)
        track_live(live, op, size, ptr, out)
        state = [np.ascontiguousarray(x) for x in out[:ths.N_STATE]]
    return tally


def geom(heap_bytes):
    return dict(GEOM, heap_bytes=heap_bytes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card; see README)")
    return torch.device("cuda")


@pytest.mark.parametrize("batch_refill", [True, False])
@pytest.mark.parametrize("threads,heap_bytes", [
    (T, HEAP), (16, 1 << 20),  # trees of 7 and 9 levels
    (16, 1 << 25)])            # 14 levels: the paper's 32 MiB heap
def test_kernel_matches_plain_on_card(cuda, threads, heap_bytes,
                                      batch_refill):
    """The kernel against the plain version on the card, bit for bit, on
    the mixed stream, with the batched refill on and off; every path of
    the round is reached. At 32 MiB the walks are the paper's depth:
    descents, up-walks and big frees of 4 and 8 KiB blocks run through all
    14 levels of the tree."""
    def run_kernel(args):
        ts = [torch.from_numpy(np.array(a)).to(cuda) for a in args]
        return ths.fused_heap_step(*ts, **geom(heap_bytes),
                                   batch_refill=batch_refill)

    def run_plain(*args):
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
              for a in args]
        return ths.protocol_round(*ts, **geom(heap_bytes),
                                  batch_refill=batch_refill)

    launches = ths.fused_heap_step.launches
    tally = drive(run_plain, run_kernel, rounds=30, seed=5, threads=threads,
                  heap_bytes=heap_bytes)
    assert ths.fused_heap_step.launches == launches + 30
    assert tally["free_big"] and tally["refill"] and tally["realloc_moved"]


def test_kernel_takes_every_backend_branch_on_card(cuda, monkeypatch):
    """Crafted rounds through `heap.step` (kind fused) on the card with
    the batched refill on and off, against the plain version's heaps on
    the host: an all-hit round (skip), block bypasses and class refills
    (run-carve of both flavours, and mixed), an odd bypass class (serial
    walk), backend frees. Responses and state equal after every round, and
    a count of the branches the host's batched round took (the kernel's
    outputs equal it bit for bit) shows every branch, the run-carve of
    each flavour on every core."""
    from repro_torch import convert

    def heaps(device):
        return [heap.MultiCoreHeap(
            system.SystemConfig(
                kind="fused", heap_bytes=HEAP, num_threads=T,
                pm=pim_malloc.PimMallocConfig(heap_bytes=HEAP, num_threads=T,
                                              cap=CAP),
                kernel_batch_refill=b), num_cores=C, device=device)
            for b in (True, False)]

    card, host = heaps(cuda), heaps("cpu")
    kinds = {}
    real = ths.backend_branch

    def spy(need, bypass, msizes, longest, **kw):
        out = real(need, bypass, msizes, longest, **kw)
        if longest.device.type == "cpu":
            refill = need & ~bypass
            for c, b in enumerate(out[0].tolist()):
                kind = ("skip", None, "serial")[b] if b != 1 else {
                    (True, False): "carve-refill",
                    (False, True): "carve-bypass"}.get(
                    (bool(refill[c].any()), bool(bypass[c].any())),
                    "carve-mixed")
                kinds[kind] = kinds.get(kind, 0) + 1
        return out

    monkeypatch.setattr(ths, "backend_branch", spy)

    def check(name, *args):
        got = [getattr(h, name)(*args) for h in card]
        want = [getattr(h, name)(*args) for h in host]
        for g, w in zip(got, want):
            for f in heap.AllocResponse._fields:
                assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), \
                    f"{name}: {f}"
        for hc, hh in zip(card, host):
            for a, b in zip(convert.leaves(hc.state), convert.leaves(hh.state)):
                assert torch.equal(a.cpu(), b), name
        if name == "free":
            kinds["free-backend"] = kinds.get("free-backend", 0) + int(
                (got[0].path == 1).sum())
        return got[0]

    def rows(*sizes):
        return np.tile(np.array(sizes, np.int32), (C, 1))

    check("malloc", rows(*[32] * T))
    blocks = check("malloc", rows(*[BLOCK] * T))
    cls256 = (256).bit_length() - (16).bit_length()
    while int(card[0].state.alloc.counts[0, 0, cls256]):
        check("malloc", rows(*[256] * T))
    check("malloc", rows(256, BLOCK, 256, BLOCK))
    check("malloc", rows(0, 256, 0, 256))
    check("malloc", rows(2 * BLOCK, 256, 2 * BLOCK, 16))
    check("free", blocks.ptr.cpu().numpy())
    for k in ("skip", "carve-refill", "carve-bypass", "carve-mixed",
              "serial"):
        assert kinds.get(k, 0) >= C, kinds
    assert kinds["free-backend"] >= C * T, kinds


def test_kernel_updates_state_in_place(cuda):
    """On the card the returned state leaves are the tensors passed in."""
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in
            list(mixed_round(rng, [[] for _ in range(C)])) + initial_state()]
    out = ths.fused_heap_step(*args, **GEOM)
    for a, b in zip(out[:ths.N_STATE], args[3:]):
        assert a.data_ptr() == b.data_ptr()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in
            list(mixed_round(np.random.default_rng(0), [[] for _ in range(C)]))
            + initial_state()]
    bad = list(args)
    bad[4] = bad[4].to(torch.int64)  # counts of the wrong dtype
    with pytest.raises(ValueError, match="counts"):
        ths.fused_heap_step(*bad, **GEOM)
    bad = list(args)
    bad[3] = bad[3][:, :-1].contiguous()  # longest of the wrong shape
    with pytest.raises(ValueError, match="longest"):
        ths.fused_heap_step(*bad, **GEOM)


def test_kernel_same_round_double_free_on_card(cuda):
    """Two threads free one bypass block in one round: the kernel's second
    backend walk (a 1-byte free after big_log2 was cleared) equals the
    plain version's."""
    state = initial_state()
    op = np.zeros((C, T), np.int32)
    size = np.zeros((C, T), np.int32)
    ptr = np.full((C, T), -1, np.int32)
    op[:, 0], size[:, 0] = 1, 8192
    out = ths.fused_heap_step(
        *(torch.from_numpy(a).to(cuda) for a in [op, size, ptr] + state),
        **GEOM)
    op[:, :2], size[:, 0] = 2, 0
    ptr[:, 0] = ptr[:, 1] = out.m_ptr[:, 0].cpu().numpy()
    args = [torch.from_numpy(a).to(cuda) for a in (op, size, ptr)] + [
        x.clone() for x in out[:ths.N_STATE]]
    want = ths.protocol_round(*args, **GEOM)
    got = ths.fused_heap_step(*args, **GEOM)
    assert_outputs_equal(got, want, "double free")
    assert bool(got.f_big[:, :2].all())


# ---------------------------------------------------------------------------
# paged attention: the seeded sweep (shared with the CPU differential test,
# test_torch_paged_attention.py) and the kernel against its plain version
# ---------------------------------------------------------------------------
PAGE = 16
PAGES = 4
# (H, KVH, D): MHA, GQA with G = 4, MQA, at head_dim 32 and 128
HEADS = [(4, 4, 32), (8, 2, 32), (4, 1, 32),
         (4, 4, 128), (8, 2, 128), (4, 1, 128)]
# seq_len 0, 1, a page boundary, one past it, and full
SEQ_LENS = (0, 1, PAGE, PAGE + 1, PAGE * PAGES)
# fp32: reordered fp32 sums; bf16: one rounding of the output (the
# reference's own tolerances, tests/test_kernels.py)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def paged_case(seed, H, KVH, D, page=PAGE, pages=PAGES, seq_lens=SEQ_LENS):
    """NumPy inputs of one paged-attention call: q [B, H, D], pools
    [N, page, KVH, D] (N = B * pages + 3), a permuted page table with -1
    entries (past the end of sequence 1, and one inside the valid range of
    the last sequence, which reads page 0), and `seq_lens`."""
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    N = B * pages + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((N, page, KVH, D)).astype(np.float32)
    v = rng.standard_normal((N, page, KVH, D)).astype(np.float32)
    pt = rng.permutation(N)[:B * pages].reshape(B, pages).astype(np.int32)
    pt[1, 1:] = -1
    pt[-1, 1] = -1
    return q, k, v, pt, np.asarray(seq_lens, np.int32)


def to_torch(case, dtype, device):
    q, k, v, pt, sl = case
    f = [torch.from_numpy(x).to(device=device, dtype=dtype) for x in (q, k, v)]
    return f + [torch.from_numpy(x).to(device) for x in (pt, sl)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", HEADS)
def test_paged_attention_kernel_matches_plain_on_card(cuda, H, KVH, D,
                                                      dtype):
    args = to_torch(paged_case(11, H, KVH, D), dtype, cuda)
    n = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == n + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert not got[0].any()  # seq_len 0 gives zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_serving_shapes_on_card(cuda, dtype):
    """granite-3-8b's decode shape (B=8, H=32, KVH=8, D=128, page 128,
    P=6, seq 513-576) and stablelm-12b's head_dim 160."""
    for H, KVH, D, lens in ((32, 8, 128, (513, 540, 576, 128, 1, 600, 700,
                                          768)),
                            (32, 8, 160, (1, 128, 129, 768))):
        args = to_torch(paged_case(12, H, KVH, D, page=128, pages=6,
                                   seq_lens=lens), dtype, cuda)
        got = tpa.paged_attention(*args)
        want = tpa.paged_attention_plain(*args)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_paged_attention_kernel_respects_page_table_on_card(cuda):
    q, k, v, _, _ = paged_case(13, 2, 2, 128, page=128, pages=2,
                               seq_lens=(256, 256))
    q2 = np.concatenate([q[:1], q[:1]])
    pt = np.array([[0, 1], [2, 3]], np.int32)
    sl = np.array([256, 256], np.int32)
    a = to_torch((q2, k, v, pt, sl), torch.float32, cuda)
    b = to_torch((q2, k, v, pt[::-1].copy(), sl), torch.float32, cuda)
    out, out_sw = tpa.paged_attention(*a), tpa.paged_attention(*b)
    torch.testing.assert_close(out[0], out_sw[1], atol=1e-6, rtol=0)
    assert not torch.allclose(out[0], out[1])


def test_attend_kernel_launches_the_kernel_on_card(cuda):
    """`kvcache.paged.attend(impl="kernel")` on CUDA tensors reaches the
    kernel (its counter moves) and equals the plain batched gather."""
    from repro_torch.kvcache import paged
    rng = np.random.default_rng(14)
    B, P, page, KVH, hd, H = 3, 3, 16, 2, 32, 8
    kp = torch.from_numpy(rng.standard_normal(
        (B, P, page, KVH, hd)).astype(np.float32)).to(cuda)
    vp = torch.from_numpy(rng.standard_normal(
        (B, P, page, KVH, hd)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).to(cuda)
    pt = torch.tensor([[2, 0, 1], [0, 1, 2], [1, 2, 0]], dtype=torch.int32,
                      device=cuda)
    sl = torch.tensor([1, 17, 48], dtype=torch.int32, device=cuda)
    n = tpa.paged_attention.launches
    got = paged.attend(q, kp, vp, pt, sl, impl="kernel")
    assert tpa.paged_attention.launches == n + 1
    want = paged.attend(q, kp, vp, pt, sl, impl="ref")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (32, 1, 128),
                                     (16, 4, 160)])
def test_paged_attention_kernel_long_sequences_on_card(cuda, H, KVH, D,
                                                       dtype):
    """80 pages of 16 per sequence, split over CTAs as `split_plan` says:
    lengths 0, on a split boundary, one past one, one short of one, and
    full; GQA, MQA (all 32 query heads on one CTA's K/V) and head_dim 160."""
    page, pages, B = 16, 80, 5
    pps, splits = tpa.split_plan(B * KVH, pages, tpa.sm_count(cuda))
    assert splits > 1
    run = pps * page
    lens = (0, run, 3 * run + 1, 5 * run - 1, pages * page)
    args = to_torch(paged_case(16, H, KVH, D, page=page, pages=pages,
                               seq_lens=lens), dtype, cuda)
    n = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == n + 1  # calls, not kernels
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_one_split_on_card(cuda, dtype):
    """Enough (sequence, KV head) rows to fill the card with one split
    each: the split kernel writes the output itself, with no merge."""
    sms = tpa.sm_count(cuda)
    KVH, pages = 8, 3
    B = -(-2 * sms // KVH)
    assert tpa.split_plan(B * KVH, pages, sms) == (pages, 1)
    lens = tuple((0, 1, 16, 17, 48)[i % 5] for i in range(B))
    args = to_torch(paged_case(17, 16, KVH, 64, pages=pages, seq_lens=lens),
                    dtype, cuda)
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not got[0].any()


def test_paged_attention_launch_error_raises_on_card(cuda):
    """A launch the card refuses (here: more shared memory than a CTA may
    have, for 256 query heads on one KV head at head_dim 256 in fp32)
    raises; nothing falls back to the plain version."""
    args = to_torch(paged_case(18, 256, 1, 256, pages=2,
                               seq_lens=(1, 2, 3)), torch.float32, cuda)
    n = tpa.paged_attention.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == n


def test_paged_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = to_torch(paged_case(15, 4, 2, 32), torch.float32, cuda)
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(*bad)
    bad = list(args)
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="share"):
        tpa.paged_attention(*bad)
    bad = list(args)
    bad[0] = bad[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(*bad)


# ---------------------------------------------------------------------------
# the kernels reached through kernels.ops: buddy batch, freelist op, flash
# attention. Buddy and freelist: exact equality (int32); flash: the
# reference's bounds, FLASH_TOL.
# ---------------------------------------------------------------------------
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 2.5e-2}


def buddy_case(seed, heap, min_block, cores, batch):
    """Fresh trees and sizes from min_block / 2 to heap / 2, with 0,
    negative and above-2^30 sizes mixed in."""
    from repro_torch.core import buddy
    rng = np.random.default_rng(seed)
    cfg = buddy.BuddyConfig(heap_bytes=heap, min_block=min_block)
    tree = buddy.init(cfg, device="cpu").longest.repeat(cores, 1)
    lo, hi = np.log(max(min_block // 2, 1)), np.log(heap // 2)
    sizes = np.exp(rng.uniform(lo, hi, (cores, batch))).astype(np.int64)
    odd = rng.random((cores, batch)) < 0.1
    sizes[odd] = rng.choice([0, -5, 2 ** 30 + 1, INT32_MAX], int(odd.sum()))
    return tree, torch.from_numpy(sizes.astype(np.int32))


@pytest.mark.parametrize("heap,min_block,cores,batch", [
    (1 << 14, 32, 1, 8), (1 << 16, 64, 4, 16), (1 << 18, 4096, 4, 130),
    (1 << 25, 4096, 3, 200), (1 << 20, 64, 2, 64),
    (1 << 25, 4096, 4, 1), (1 << 25, 4096, 4, 128),  # phase 8's B=1, B=128
    (1 << 16, 64, 2, 600),  # a long batch
    (64, 64, 3, 5), (128, 64, 3, 5)])  # 2 nodes (8 B): copied by the warp
def test_buddy_kernel_matches_plain_on_card(cuda, heap, min_block, cores,
                                            batch):
    """Three chained batches per geometry, up to the allocator's (32 MiB,
    4 KiB: a 64 KiB tree, above the 48 KiB default shared memory, copied
    in five level chunks) and the largest tree the kernel takes (2^15
    nodes), down to trees of 2 and 4 nodes."""
    from repro_torch.kernels import buddy_traverse as bt
    tree, sizes = buddy_case(21, heap, min_block, cores, batch)
    tree = tree.to(cuda)
    kw = dict(heap_bytes=heap, min_block=min_block)
    n = bt.buddy_alloc_batch_kernel.launches
    for r in range(3):
        s = sizes.roll(r, dims=1).contiguous().to(cuda)
        offs, new = bt.buddy_alloc_batch_kernel(tree, s, **kw)
        woffs, wnew = bt.buddy_alloc_batch_plain(tree, s, **kw)
        torch.cuda.synchronize()
        assert torch.equal(offs, woffs), f"batch {r}: offsets"
        assert torch.equal(new, wnew), f"batch {r}: tree"
        tree = new
    assert bt.buddy_alloc_batch_kernel.launches == n + 3


def test_buddy_kernel_copies_a_misaligned_tree_on_card(cuda):
    """Trees whose rows do not start on 16 bytes (a view one int into its
    storage) take the warp's copy instead of the bulk copy; same result."""
    from repro_torch.kernels import buddy_traverse as bt
    heap, mb = 1 << 20, 4096
    tree, sizes = buddy_case(26, heap, mb, 3, 40)
    store = torch.zeros(tree.numel() + 1, dtype=torch.int32, device=cuda)
    odd = store[1:].view(tree.shape)
    odd.copy_(tree.to(cuda))
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    kw = dict(heap_bytes=heap, min_block=mb)
    offs, new = bt.buddy_alloc_batch_kernel(odd, sizes.to(cuda), **kw)
    woffs, wnew = bt.buddy_alloc_batch_plain(tree, sizes, **kw)
    assert torch.equal(offs.cpu(), woffs) and torch.equal(new.cpu(), wnew)


def test_buddy_kernel_quirk_rows_on_card(cuda):
    """Sizes <= 0 fail; above 2^30 they wrap to min_block (findings 1-2)."""
    from repro_torch.kernels import ops
    tree, _ = buddy_case(0, 1 << 16, 64, 1, 1)
    sizes = torch.tensor([[0, -5, 64, 2 ** 30 + 1, 100, INT32_MAX]],
                         dtype=torch.int32, device=cuda)
    offs, _ = ops.buddy_alloc_batch(tree.to(cuda), sizes, heap_bytes=1 << 16,
                                    min_block=64)
    assert offs.tolist() == [[-1, -1, 0, 64, 128, 256]]


def test_buddy_free_bytes_on_card(cuda):
    """`core.buddy.free_bytes` on the card equals the host's on trees the
    kernel filled, and heap minus the blocks served (the tree depth of
    every node is exact on the card)."""
    from repro_torch.core import buddy
    from repro_torch.kernels import ops
    heap, mb = 1 << 25, 4096
    cfg = buddy.BuddyConfig(heap_bytes=heap, min_block=mb)
    tree, sizes = buddy_case(25, heap, mb, 8, 48)
    sizes = sizes.clamp(max=1 << 20)
    offs, new = ops.buddy_alloc_batch(tree.to(cuda), sizes.to(cuda),
                                      heap_bytes=heap, min_block=mb)
    got = buddy.free_bytes(cfg, buddy.BuddyState(new))
    want = buddy.free_bytes(cfg, buddy.BuddyState(new.cpu()))
    assert torch.equal(got.cpu(), want)
    r = torch.clamp(buddy.next_pow2(sizes), min=mb)
    served = torch.where(offs.cpu() >= 0, r, 0).sum(1)
    assert torch.equal(want, (heap - served).to(torch.int32))


def test_buddy_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import buddy_traverse as bt
    tree, sizes = buddy_case(0, 1 << 14, 32, 2, 4)
    tree, sizes = tree.to(cuda), sizes.to(cuda)
    kw = dict(heap_bytes=1 << 14, min_block=32)
    with pytest.raises(ValueError, match="int32"):
        bt.buddy_alloc_batch_kernel(tree.long(), sizes, **kw)
    with pytest.raises(ValueError, match="sizes must be"):
        bt.buddy_alloc_batch_kernel(tree, sizes[:1].contiguous(), **kw)
    with pytest.raises(ValueError, match="sizes is on"):
        bt.buddy_alloc_batch_kernel(tree, sizes.cpu(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bt.buddy_alloc_batch_kernel(tree, sizes.t().contiguous().t(), **kw)
    with pytest.raises(ValueError, match="tree must be"):
        bt.buddy_alloc_batch_kernel(tree[:, :-2].contiguous(), sizes, **kw)
    big = torch.zeros((1, 1 << 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        bt.buddy_alloc_batch_kernel(big, sizes[:1].contiguous(),
                                    heap_bytes=1 << 15, min_block=1)


def freelist_case(seed, T, NC, CAP):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, CAP + 1, (T, NC)).astype(np.int32)
    counts[:, 0] = 0
    counts[:, -1] = CAP
    stacks = rng.integers(0, 1 << 20, (T, NC, CAP)).astype(np.int32)
    return torch.from_numpy(stacks), torch.from_numpy(counts), rng


@pytest.mark.parametrize("T,NC,CAP", [(4, 8, 64), (8, 4, 128), (1000, 3, 5),
                                      (8192, 8, 64)])
def test_freelist_kernel_matches_plain_on_card(cuda, T, NC, CAP):
    """Five chained ops with classes -1 and NC, pops of empty and pushes
    onto full classes, and counts outside [0, CAP] in the last op; CAP 5
    takes the kernel's unaligned copy."""
    from repro_torch.kernels import freelist as fl
    stacks, counts, rng = freelist_case(22, T, NC, CAP)
    stacks, counts = stacks.to(cuda), counts.to(cuda)
    n = fl.freelist_op_kernel.launches
    for r in range(5):
        if r == 4:
            counts[:, 1] = torch.from_numpy(rng.choice(
                [-1, -CAP - 2, CAP + 3, INT32_MAX, -2 ** 31],
                T).astype(np.int32)).to(cuda)
        op, cls, ptr = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in
                        (rng.integers(-1, 2, T), rng.integers(-1, NC + 1, T),
                         rng.integers(0, 1 << 20, T)))
        got = fl.freelist_op_kernel(stacks, counts, op, cls, ptr)
        want = fl.freelist_op_plain(stacks, counts, op, cls, ptr)
        torch.cuda.synchronize()
        for name, a, b in zip(("ptr_out", "counts", "stacks"), got, want):
            assert torch.equal(a, b), f"op {r}: {name}"
        _, counts, stacks = got
    assert fl.freelist_op_kernel.launches == n + 5


def test_freelist_kernel_quirk_row_on_card(cuda):
    """A class >= NC pops and counts class NC-1 (finding 3)."""
    from repro_torch.kernels import ops
    stacks = (torch.arange(24, dtype=torch.int32) + 100).reshape(3, 2, 4)
    counts = torch.tensor([[1, 2], [0, 1], [2, 2]], dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=cuda)
    p, c, _ = ops.freelist_op(stacks.to(cuda), counts.to(cuda),
                              torch.tensor([0, -1, -1], **i32),
                              torch.tensor([2, 0, 0], **i32),
                              torch.zeros(3, **i32))
    assert p.tolist() == [105, -1, -1] and c[0].tolist() == [1, 1]


def test_freelist_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import freelist as fl
    stacks, counts, _ = freelist_case(0, 4, 2, 8)
    i32 = dict(dtype=torch.int32, device=cuda)
    args = [stacks.to(cuda), counts.to(cuda), torch.zeros(4, **i32),
            torch.zeros(4, **i32), torch.zeros(4, **i32)]
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="counts must be int32"):
        fl.freelist_op_kernel(*bad)
    bad = list(args)
    bad[2] = bad[2][:3]
    with pytest.raises(ValueError, match="op must be"):
        fl.freelist_op_kernel(*bad)
    bad = list(args)
    bad[1] = bad[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        fl.freelist_op_kernel(*bad)
    bad = list(args)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError, match="ptr_in is on"):
        fl.freelist_op_kernel(*bad)


FLASH_CASES = [  # B, S, T, H, KVH, hd, causal, window
    (2, 192, 192, 4, 2, 64, True, 0),       # GQA, S not a tile multiple
    (1, 1000, 1000, 4, 1, 128, True, 128),  # MQA, sliding window
    (2, 192, 1000, 6, 6, 256, False, 0),    # MHA, S != T, hd 256
    (1, 1000, 192, 8, 2, 256, True, 64),    # causal, S > T, window
    (1, 1000, 1000, 4, 4, 160, False, 300),  # window without causal
    (1, 192, 192, 2, 2, 32, True, 0),
]


def flash_inputs(seed, B, S, T, H, KVH, hd, dtype, device, mag=0.2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((B, n, h, hd)) * mag)
                             .astype(np.float32)).to(device=device,
                                                     dtype=dtype)
            for n, h in ((S, H), (T, KVH), (T, KVH))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    B, S, T, H, KVH, hd, causal, window = case
    q, k, v = flash_inputs(23, B, S, T, H, KVH, hd, dtype, cuda)
    n = fa.flash_attention_kernel.launches
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_kernel.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def test_flash_kernel_rows_that_see_no_key_are_zero_on_card(cuda):
    """Non-causal with a window and S > T: rows past T + window see no
    key and give 0, as the reference's acc / max(l, 1e-30) does."""
    from repro_torch.kernels import ops
    q, k, v = flash_inputs(24, 1, 300, 64, 2, 1, 64, torch.float32, cuda)
    got = ops.flash_attention_op(q, k, v, causal=False, window=100)
    assert not bool(got[:, 64 + 100:].any())
    assert bool(got[:, :64].abs().sum(-1).gt(0).all())


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(0, 1, 64, 64, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="share"):
        fa.flash_attention_kernel(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="share"):
        fa.flash_attention_kernel(*(x.half() for x in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_kernel(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention_kernel(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_kernel(q[:, :, :3].contiguous(), k, v)
    big = flash_inputs(0, 1, 8, 8, 1, 1, 320, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_kernel(*big)


TC_CASES = [  # B, S, T, H, KVH, hd, causal, window
    (2, 200, 200, 4, 2, 64, True, 0),      # hd 64, S not a tile multiple
    (1, 333, 333, 4, 1, 128, True, 100),   # hd 128, sliding window
    (2, 130, 400, 4, 4, 256, False, 0),    # hd 256, S != T
    (1, 500, 130, 8, 2, 128, True, 0),     # causal, S > T
    (1, 300, 300, 2, 2, 256, False, 70),   # window without causal
    (1, 190, 190, 4, 2, 32, True, 0),      # hd 32, padded to 64
    (1, 190, 190, 4, 2, 160, True, 0),     # hd 160, padded to 256
    (1, 150, 150, 2, 1, 36, True, 0),      # hd 36: copied element-wise
]


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_bf16_takes_the_tensor_core_route_on_card(cuda, case):
    """bf16 goes through the tensor-core kernel at every head_dim, and on
    unit-scale inputs meets chip_smoke phase 10's limits: 2.5e-2 and two
    bf16 steps of every element."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    B, S, T, H, KVH, hd, causal, window = case
    q, k, v = flash_inputs(25, B, S, T, H, KVH, hd, torch.bfloat16, cuda,
                           mag=1.0)
    before = dict(fa.flash_attention_kernel.route_launches)
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa.flash_attention_kernel.route_launches
    assert after["bf16_tensor_cores"] == before["bf16_tensor_cores"] + 1
    assert after["fp32_cuda_cores"] == before["fp32_cuda_cores"]
    chip_smoke.flash_check(got, want, f"bf16 {case}")


def test_flash_fp32_takes_the_cuda_core_route_on_card(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(26, 1, 100, 100, 4, 2, 64, torch.float32, cuda)
    before = dict(fa.flash_attention_kernel.route_launches)
    got = fa.flash_attention_kernel(q, k, v)
    after = fa.flash_attention_kernel.route_launches
    assert after["fp32_cuda_cores"] == before["fp32_cuda_cores"] + 1
    assert after["bf16_tensor_cores"] == before["bf16_tensor_cores"]
    want = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention"])
def test_attention_wrappers_raise_on_a_launch_error_on_card(cuda, kernel,
                                                            monkeypatch):
    """A launcher that reports an error makes the wrapper raise and count
    nothing: no fallback to the plain version or another kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    monkeypatch.setitem(_build._LOADED, kernel, Refusing())
    if kernel == "flash_attention":
        fn, args = fa.flash_attention_kernel, flash_inputs(
            27, 1, 64, 64, 2, 1, 64, torch.bfloat16, cuda)
    else:
        fn, args = tpa.paged_attention, to_torch(
            paged_case(27, 4, 2, 32), torch.bfloat16, cuda)
    n = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*args)
    assert fn.launches == n


# ---------------------------------------------------------------------------
# the scan-based design points (strawman, sw, hwsw): plain PyTorch rounds
# ---------------------------------------------------------------------------
def scan_session(device, kinds, cores, rounds, seed=0):
    """The first `rounds` rounds of chip_smoke's session stream at the
    paper's width through `kinds` in lockstep, each kind resolving its own
    slots; asserts `chip_smoke.scan_mismatches` finds nothing after every
    round. Returns the final states and configs."""
    import chip_smoke as cs
    cfgs = {k: cs.paper_cfg(k) for k in kinds}
    tape = cs.session_tape(np.random.default_rng(seed), rounds, cores,
                           cfgs[kinds[0]].num_threads)
    states = {k: heap.init(cfgs[k], num_cores=cores, device=device)
              for k in kinds}
    sess = {k: cs.slot_file(tape, device) for k in kinds}
    for r in range(rounds):
        resps = {}
        for k in kinds:
            req = sess[k].request(r)
            states[k], resps[k] = heap.step(cfgs[k], states[k], req)
            sess[k].record(r, req, resps[k])
        assert cs.scan_mismatches(r, resps, states) == []
    return states, cfgs


def test_hwsw_equals_fused_and_sw_equals_hwsw_at_paper_width_on_card(cuda):
    """512 cores of 32 MiB heaps, T=16: hwsw == fused on every response
    field and state leaf, sw == hwsw on the semantic fields and the
    allocator state, residual 0 on every core."""
    from repro_torch.core import telemetry
    states, cfgs = scan_session(cuda, ("hwsw", "fused", "sw"), 512, 3)
    for k, st in states.items():
        assert not np.any(telemetry.conservation_residuals(cfgs[k], st)), k


def test_strawman_residual_zero_at_paper_width_on_card(cuda):
    """The straw-man heap at 512 cores (2^21-node trees: 4 GiB): two
    rounds of the session stream leave every core's residual 0."""
    from repro_torch.core import telemetry
    states, cfgs = scan_session(cuda, ("strawman",), 512, 2)
    resid = telemetry.conservation_residuals(cfgs["strawman"],
                                             states["strawman"])
    assert resid.shape == (512,) and not np.any(resid)


def test_cache_tie_rules_on_card(cuda):
    """The LRU cache's tie rules on the card equal the CPU's (first
    matching entry, first entry of least last_used), and so does the
    trace sim."""
    from repro_torch.core import buddy_cache as bc
    tags = torch.tensor([[-1, -1, -1, -1], [3, 5, 3, 7], [2, 9, 4, 6],
                         [-1, 8, -1, 1]], dtype=torch.int32)
    lu = torch.tensor([[-1, -1, -1, -1], [4, 1, 1, 0], [2, 2, 2, 2],
                       [-1, 5, -1, 3]], dtype=torch.int32)
    clock = torch.tensor([0, 5, 3, 6], dtype=torch.int32)
    rng = np.random.default_rng(0)
    tr = torch.from_numpy(np.where(rng.random((4, 5, 9)) < 0.3, -1,
                                   rng.integers(0, 200, (4, 5, 9)))
                          .astype(np.int32))
    cfg = bc.BuddyCacheConfig(n_entries=4)
    outs = {}
    for dev in ("cpu", cuda):
        st = bc.BuddyCacheState(tags.to(dev), lu.to(dev), clock.to(dev))
        node = torch.tensor([48, 50, 33, 0], dtype=torch.int32, device=dev)
        st1, hit, dram = bc.buddy_cache_access(cfg, st, node)
        st2, stats = bc.simulate_traces(
            lambda s, n: bc.buddy_cache_access(cfg, s, n), st1, tr.to(dev))
        outs[str(dev)] = [x.cpu() for x in (*st1, hit, dram, *st2, *stats)]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert torch.equal(a, b)
    # word 3 sits in entries 0 and 2 of core 1: the hit takes entry 0
    assert outs["cpu"][1][1, 0] == 5


@pytest.mark.parametrize("kind", ["strawman", "sw", "hwsw"])
def test_scan_kind_on_card_equals_cpu(cuda, kind):
    """The mixed stream of the kernel tests through a scan-based kind on
    the card and on the CPU: every response field and state leaf equal."""
    from repro_torch import convert
    cfg = system.SystemConfig(
        kind=kind, heap_bytes=HEAP, num_threads=T,
        pm=pim_malloc.PimMallocConfig(heap_bytes=HEAP, num_threads=T,
                                      cap=CAP))
    hs = {d: heap.MultiCoreHeap(cfg, C, device=d) for d in ("cpu", cuda)}
    rng = np.random.default_rng(9)
    live = [[] for _ in range(C)]
    for r in range(12):
        op, size, ptr = mixed_round(rng, live)
        resps = {d: h.step(heap.AllocRequest(*(torch.from_numpy(x)
                                               for x in (op, size, ptr))))
                 for d, h in hs.items()}
        for f in heap.AllocResponse._fields:
            assert torch.equal(getattr(resps["cpu"], f),
                               getattr(resps[cuda], f).cpu()), (r, f)
        for a, b in zip(convert.leaves(hs["cpu"].state),
                        convert.leaves(hs[cuda].state)):
            assert torch.equal(a, b.cpu()), r
        got = resps["cpu"]
        for c, t in np.ndindex(op.shape):
            p = int(got.ptr[c, t])
            if p >= 0 and op[c, t] in (1, 3, 4):
                live[c].append(p)


# ---------------------------------------------------------------------------
# the region frontends, the sanitizer and the sharded tier: plain PyTorch
# rounds (the arena kinds' spills launch the heap kernel over ``fused``)
# ---------------------------------------------------------------------------
def closed_loop(seed, rounds=24, cores=C, threads=T, heap_bytes=HEAP):
    """[C, T] rounds of a closed loop: malloc / calloc / free / realloc of
    every size regime (arena-sized, spills, 0), NULL and garbage pointers
    (-16, heap end, misaligned); every 8th round resets on some cores (all
    or some of their threads), and a core that resets drops its live
    pointers, as the reference's conformance stream does."""
    rng = np.random.default_rng(seed)
    live = [[] for _ in range(cores)]
    for r in range(rounds):
        op = np.zeros((cores, threads), np.int32)
        size = np.zeros_like(op)
        ptr = np.full_like(op, -1)
        for c in range(cores):
            if r % 8 == 7 and rng.random() < 0.7:
                op[c] = np.where(rng.random(threads) < 0.7, 5, 0)
                live[c].clear()
                continue
            for t in range(threads):
                k = int(rng.choice([1, 1, 2, 3, 4]))
                op[c, t] = k
                size[c, t] = rng.choice([16, 48, 200, 2048, 4096, 8192, 0])
                if k in (2, 3):
                    if live[c] and rng.random() < 0.9:
                        ptr[c, t] = live[c].pop(int(rng.integers(
                            len(live[c]))))
                    else:
                        ptr[c, t] = rng.choice([-1, -16, heap_bytes, 8, 24])
        yield op, size, ptr, live


def region_cfg(kind, inner="hwsw", heap_bytes=HEAP, threads=T):
    return system.SystemConfig(
        kind=kind, heap_bytes=heap_bytes, num_threads=threads,
        arena_inner=inner,
        pm=pim_malloc.PimMallocConfig(heap_bytes=heap_bytes,
                                      num_threads=threads, cap=CAP))


@pytest.mark.parametrize("kind,inner", [
    ("sanitizer", "hwsw"), ("arena", "hwsw"), ("arena", "fused"),
    ("tlregion", "hwsw"), ("tlregion", "fused")])
def test_new_kind_on_card_equals_cpu(cuda, kind, inner):
    """The closed-loop stream with per-core resets, NULL and garbage
    pointers through each new kind at C=8 on the card and on the CPU:
    every response field and state leaf equal every round."""
    from repro_torch import convert
    cfg = region_cfg(kind, inner)
    hs = {d: heap.MultiCoreHeap(cfg, 8, device=d) for d in ("cpu", cuda)}
    for r, (op, size, ptr, live) in enumerate(closed_loop(6, cores=8)):
        resps = {d: h.step(heap.AllocRequest(*(torch.from_numpy(x)
                                               for x in (op, size, ptr))))
                 for d, h in hs.items()}
        for f in heap.AllocResponse._fields:
            assert torch.equal(getattr(resps["cpu"], f),
                               getattr(resps[cuda], f).cpu()), (r, f)
        for a, b in zip(convert.leaves(hs["cpu"].state),
                        convert.leaves(hs[cuda].state)):
            assert torch.equal(a, b.cpu()), r
        got = resps["cpu"]
        for c, t in np.ndindex(op.shape):
            if got.ok[c, t] and op[c, t] in (1, 3, 4) and got.ptr[c, t] >= 0:
                live[c].append(int(got.ptr[c, t]))


def test_arena_fused_equals_hwsw_at_paper_width_on_card(cuda):
    """512 cores of 32 MiB heaps, T=16, chip_smoke's stream with a reset
    every 2nd round: arena and tlregion over fused (the heap kernel) ==
    over hwsw on every field and leaf every round; residual 0."""
    import chip_smoke as cs
    from repro_torch.core import telemetry
    from repro_torch.kernels import heap_step
    rounds = 3
    tape = cs.session_tape(np.random.default_rng(0), rounds, 512, 16,
                           reset_every=2)
    for kind in ("arena", "tlregion"):
        cfgs = {i: cs.paper_cfg(kind, arena_inner=i) for i in cs.INNERS}
        states = {i: heap.init(cfgs[i], num_cores=512, device=cuda)
                  for i in cs.INNERS}
        sess = {i: cs.slot_file(tape, cuda) for i in cs.INNERS}
        n = heap_step.fused_heap_step.launches
        for r in range(rounds):
            resps = {}
            for i in cs.INNERS:
                req = sess[i].request(r)
                states[i], resps[i] = heap.step(cfgs[i], states[i], req)
                sess[i].record(r, req, resps[i])
            assert cs.pair_mismatches(r, "fused", "hwsw", resps["fused"],
                                      resps["hwsw"], states["fused"],
                                      states["hwsw"]) == []
        assert heap_step.fused_heap_step.launches - n == rounds
        for i in cs.INNERS:
            assert not np.any(telemetry.conservation_residuals(cfgs[i],
                                                               states[i]))
        del states


def test_sanitizer_tags_on_the_misuse_stream_on_card(cuda):
    """chip_smoke's misuse stream at 64 cores over 32 rounds, reset at
    round 24: the reports equal the generator's counts on every core (the
    quarantine's evictions, and frees of evicted blocks, included), the
    quarantine evicts in FIFO order, residual 0; the first 8 cores on the
    card == on the CPU."""
    import chip_smoke as cs
    from repro_torch.core import sanitizer, telemetry
    cfg = cs.paper_cfg("sanitizer")
    tape, want, targets = cs.misuse_tape(np.random.default_rng(1), 32, 64,
                                         16, cfg.heap_bytes, reset_round=24)
    model = cs.QuarantineModel(64, sanitizer.quarantine_slots(16))
    state, _ = cs.run_stream(cfg, tape, cuda, 32, model=model)
    assert sum(int(v.sum()) for v in targets.values()) > 64
    assert int(want["evicted"].sum()) > 0
    assert int(targets["evicted_free"].sum()) > 0
    assert cs.san_mismatches(state.reports, want) == []
    assert model.check(state) == []
    assert not np.any(telemetry.conservation_residuals(cfg, state))
    cs.check_devices(cfg, tape, cuda, torch.device("cpu"), 32, 8)


def test_sharded_equals_multicore_on_card(cuda):
    """ShardedHeap(R=4, C=16) == MultiCoreHeap(C=64) per (rank, core) on
    hwsw and fused, through chip_smoke's check."""
    import chip_smoke as cs
    out = cs.sharded_phase(0, cuda, cores=64, ranks=4, rounds=3)
    assert set(out) == {"hwsw", "fused"}


@pytest.mark.parametrize("name", ["graph_churn", "kv_paged", "hashtable",
                                  "decode_serve"])
def test_fused_recording_on_card_equals_cpu(cuda, name):
    """A `RecordingAllocator(kind="fused")` on the card (the heap kernel
    once a round) records the same tape as on the CPU."""
    from repro_torch.kernels import heap_step
    from repro_torch.workloads.scenarios import SCENARIOS
    heap_step.fused_heap_step.launches = 0
    got = SCENARIOS[name](kind="fused", device=cuda)
    launches = heap_step.fused_heap_step.launches
    want = SCENARIOS[name](kind="fused", device="cpu")
    assert got.to_json() == want.to_json()
    assert launches == (0 if name == "decode_serve" else got.rounds)


def test_decode_serve_on_card_equals_cpu(cuda):
    """A small DecodeServe session on the card: its report and responses
    equal the CPU's, fused equals hwsw, residual 0."""
    from repro_torch.launch.serve_decode import DecodeServe, DecodeTraffic
    tc = DecodeTraffic(seed=29, rounds=24, session_rate=3.0, num_tenants=16,
                       queue_cap=16)
    out = {}
    for kind in ("hwsw", "fused"):
        cfg = system.SystemConfig(kind=kind, heap_bytes=1 << 20,
                                  num_threads=T)
        for dev in (cuda, torch.device("cpu")):
            eng = DecodeServe(cfg, 2, 2, traffic=tc, device=dev)
            plan = eng.plan()
            state, resps = eng.run(plan)
            out[kind, dev.type] = (eng.report(plan, resps, state),
                                   [x.cpu() for x in resps])
    base_rep, base_resps = out["hwsw", "cpu"]
    assert base_rep["conservation_residual"] == 0
    for rep, resps in out.values():
        assert rep == base_rep
        for a, b in zip(resps, base_resps):
            assert torch.equal(a, b)


def test_scan_engine_refuses_a_mesh_on_card(cuda):
    from repro_torch.launch.serving import ScanEngine
    cfg = system.SystemConfig(kind="fused", heap_bytes=1 << 20,
                              num_threads=T)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ScanEngine(cfg, 2, 2, mesh=object(), device=cuda)
    assert ScanEngine(cfg, 2, 2, mesh=False, device=cuda).mesh is None
