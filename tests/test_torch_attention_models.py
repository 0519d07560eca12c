"""Plain-PyTorch models of the two attention kernels' arithmetic, on the CPU.

* Flash attention, bf16 route: the kernel's products are bf16 tensor-core
  products with fp32 sums, and p.v keeps p's fp32 value as p_hi + p_lo
  (two bf16 terms). `flash_tiles` repeats that arithmetic tile by tile
  (64 keys, online softmax) at a reduced-head version of chip_smoke phase
  10's unit-scale inputs. Held to the plain version by phase 10's own
  limits (`chip_smoke.flash_reading`): the hi/lo split stays within two
  bf16 steps of every element and within 3e-5 in fp32, where p rounded to
  bf16 does not.
* Paged attention: the kernel splits each sequence into runs of pages
  (`split_plan`) and merges the splits' (m, l, acc). `split_merge` repeats
  that arithmetic and is held to the reference's oracle
  `repro.kernels.ref.paged_attention_ref` at 2e-5 (fp32; the reference's
  tolerance) at the edge cases: a split with no valid token, seq_len 0 and
  1, lengths on a split boundary, -1 page entries, MQA and head_dim 160.
  The two merge mutants of tools/flash_mutants.py fail it by >= 2x.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

from test_torch_cuda import HEADS, paged_case, to_torch  # noqa: E402

NEG_INF = -1e30


# ------------------------------------------------------------ flash, hi/lo
def flash_tiles(q, k, v, *, causal=True, p_mode="hilo", bn=64):
    """The bf16 kernel's arithmetic in fp32: per tile of `bn` keys,
    s = q.k * scale, online softmax, then acc += p.v with p kept in fp32
    ("fp32"), split into bf16 hi + lo ("hilo") or rounded to bf16 ("bf16").
    q [B, S, H, hd]; k, v [B, T, KVH, hd]. Returns fp32 [B, S, H, hd]."""
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / hd ** 0.5
    qf = q.float().reshape(B, S, KVH, G, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KVH, G, S), NEG_INF)
    l = torch.zeros((B, KVH, G, S))
    acc = torch.zeros((B, KVH, G, S, hd))
    qpos = torch.arange(S)[:, None]
    for t0 in range(0, T, bn):
        kt, vt = kf[:, t0:t0 + bn], vf[:, t0:t0 + bn]
        s = torch.einsum("bskgd,btkd->bkgst", qf, kt) * scale
        vis = torch.ones((S, kt.shape[1]), dtype=torch.bool)
        if causal:
            vis &= qpos >= torch.arange(t0, t0 + kt.shape[1])[None, :]
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)  # from fp32 p
        if p_mode == "hilo":
            hi = p.bfloat16().float()
            terms = (hi, (p - hi).bfloat16().float())
        elif p_mode == "bf16":
            terms = (p.bfloat16().float(),)
        else:
            terms = (p,)
        acc = acc * alpha[..., None] + sum(
            torch.einsum("bkgst,btkd->bkgsd", t, vt) for t in terms)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def unit_inputs(seed, B=1, S=512, H=4, KVH=1, hd=128):
    """Phase 10's unit-scale randn inputs at reduced heads, bf16 values."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, hd)).astype(
        np.float32)).bfloat16() for h in (H, KVH, KVH)]


@pytest.fixture(scope="module")
def flash_case():
    q, k, v = unit_inputs(10)
    want16 = fa.flash_attention_plain(q, k, v, causal=True)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    want32 = fa.flash_attention_plain(q32, k32, v32, causal=True)
    return q, k, v, want16, want32


def test_p_split_stays_within_phase_10_limits(flash_case):
    q, k, v, want16, want32 = flash_case
    got = flash_tiles(q, k, v, p_mode="hilo")
    _, share16 = chip_smoke.flash_reading(got.bfloat16(), want16)
    _, share32 = chip_smoke.flash_reading(got, want32)
    assert share16 <= 1.0 and share32 <= 1.0, (share16, share32)
    # the same model with p in fp32 agrees with the hi/lo split far inside
    # the fp32 limit: the split loses ~2^-17 of p
    exact = flash_tiles(q, k, v, p_mode="fp32")
    assert chip_smoke.flash_reading(got, exact)[1] <= 0.25


def test_p_rounded_to_bf16_fails_phase_10_limits(flash_case):
    q, k, v, want16, want32 = flash_case
    got = flash_tiles(q, k, v, p_mode="bf16")
    _, share32 = chip_smoke.flash_reading(got, want32)
    _, share16 = chip_smoke.flash_reading(got.bfloat16(), want16)
    assert share32 > 2.0, share32
    assert share16 > 1.0, share16


# ------------------------------------------------------ paged, split + merge
def split_merge(q, k_pages, v_pages, page_table, seq_lens, pps, *,
                drop=None, rescale=True):
    """The split kernel and the merge in fp32: split i of a sequence takes
    pages [i * pps, (i + 1) * pps) of its valid tokens and gives
    (m_i, l_i, acc_i) (m_i = -1e30, l_i = 0, acc_i = 0 with no valid
    token); out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30) with
    w_i = exp(m_i - max m). `drop` leaves split `drop` out of the sums and
    `rescale=False` takes w_i = 1 (the two merge mutants)."""
    B, H, D = q.shape
    N, page, KVH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KVH
    splits = -(-P // pps)
    L = pps * page
    pt = page_table.long().clamp(0, N - 1)

    def gather(pool):
        x = pool[pt].reshape(B, P * page, KVH, D).float()
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0,
                                           splits * L - P * page))

    k, v = gather(k_pages), gather(v_pages)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KVH, G, D).float(),
                     k) / D ** 0.5
    n_tok = torch.clamp(seq_lens.long(), 0, P * page)
    valid = torch.arange(splits * L)[None, :] < n_tok[:, None]
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF).reshape(B, KVH, G, splits, L)
    valid = valid.reshape(B, 1, 1, splits, L)
    m_i = s.amax(-1)  # -1e30 where the split has no valid token
    p = torch.where(valid, torch.exp(s - m_i[..., None]), 0.0)
    l_i = p.sum(-1)
    acc_i = torch.einsum("bkgil,bilkd->bkgid", p,
                         v.reshape(B, splits, L, KVH, D))
    w = torch.exp(m_i - m_i.amax(-1, keepdim=True)) if rescale else \
        torch.ones_like(m_i)
    if drop is not None:
        w[..., drop] = 0.0
    out = (w[..., None] * acc_i).sum(-2) / torch.clamp(
        (w * l_i).sum(-1), min=1e-30)[..., None]
    return out.reshape(B, H, D)


def oracle(case):
    q, k, v, pt, sl = case
    return torch.from_numpy(np.array(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(sl)), np.float32))


# seq_len 0 (every split empty), 1 (splits 1.. empty), a split boundary
# (2 pages x 16), one past it, and full; page 16, 8 pages, 2 pages a split
EDGE_LENS = (0, 1, 32, 33, 128)
PAGED_HEADS = HEADS + [(8, 2, 160), (16, 1, 64)]


@pytest.mark.parametrize("H,KVH,D", PAGED_HEADS)
def test_split_merge_matches_reference_oracle(H, KVH, D):
    case = paged_case(31, H, KVH, D, page=16, pages=8, seq_lens=EDGE_LENS)
    args = to_torch(case, torch.float32, "cpu")
    got = split_merge(*args, pps=2)
    want = oracle(case)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[0].any()  # seq_len 0 gives zeros
    # the port's plain version, the kernel's yardstick, agrees too
    torch.testing.assert_close(tpa.paged_attention_plain(*args), want,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mutant", [dict(drop=1), dict(rescale=False)])
def test_merge_mutants_fail_the_tolerance(mutant):
    case = paged_case(32, 8, 2, 128, page=16, pages=8, seq_lens=EDGE_LENS)
    args = to_torch(case, torch.float32, "cpu")
    _, share = chip_smoke.pa_reading(split_merge(*args, pps=2, **mutant),
                                     oracle(case), 2e-5)
    assert share >= 2.0, share


@pytest.mark.parametrize("rows,pages,sms,want", [
    (64, 6, 132, (1, 6)),     # granite-3-8b serving: B=8 x KVH=8, P=6
    (8, 64, 132, (1, 64)),    # chip_smoke's long case: B=1, 8192 tokens
    (64, 64, 132, (12, 6)),
    (400, 6, 132, (6, 1)),    # enough rows: one split, no merge
    (1, 1, 132, (1, 1)),
])
def test_split_plan(rows, pages, sms, want):
    assert tpa.split_plan(rows, pages, sms) == want


@pytest.mark.parametrize("sms", [1, 132])
def test_split_plan_covers_the_table_and_fills_the_card(sms):
    for rows in (1, 2, 7, 64, 300, 1000):
        for pages in (1, 2, 5, 64, 200, 5000):
            pps, splits = tpa.split_plan(rows, pages, sms)
            assert pps >= 1 and (splits - 1) * pps < pages <= splits * pps
            assert rows * splits >= min(rows * pages, 2 * sms)
            assert splits <= 65535
