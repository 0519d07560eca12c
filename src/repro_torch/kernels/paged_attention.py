"""Single-token decode attention over a paged KV pool: the CUDA kernel and
its plain PyTorch version.

The port of `repro.kernels.paged_attention.paged_attention_kernel` (the
TPU kernel) and of its oracle `repro.kernels.ref.paged_attention_ref`.
For every sequence b and query head h = kvh * G + g:

    out[b, h] = softmax_t(q[b, h] . k[t] / sqrt(D)) . v[t]

over the tokens t < seq_lens[b] of the pages ``page_table[b]`` names in
the pool ``[N, page, KVH, D]`` (a -1 entry reads page 0), in fp32, the
output in q's dtype. A sequence of length 0 gives zeros.

`paged_attention_plain` is the plain version (the twin of the oracle: a
dense gather and a masked softmax). `paged_attention` is the wrapper the
serving path calls: for CUDA tensors it launches
``csrc/paged_attention.cu`` (each sequence split over `split_plan`'s CTAs,
online softmax over each split's pages, then a merge of the splits), for
CPU tensors it runs the plain version. The CUDA launch is the operator
``repro_torch::paged_attention`` (`_library`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _library

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
CTAS_PER_SM = 2  # the split grid's target occupancy


def split_plan(rows: int, pages: int, sms: int) -> tuple[int, int]:
    """(pages per split, splits) of the kernel's grid (rows x splits): each
    of the `rows` (sequence, KV head) pairs is split into runs of
    consecutive pages, enough of them that the grid has at least
    `CTAS_PER_SM` CTAs per SM where `pages` allows."""
    want = min(pages, -(-CTAS_PER_SM * sms // rows))
    pps = max(1, pages // max(want, 1))
    return pps, -(-pages // pps)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens):
    """Dense gather + masked softmax in fp32 (as `ref.paged_attention_ref`).

    q [B, H, D]; k_pages / v_pages [N, page, KVH, D]; page_table int32
    [B, P]; seq_lens int32 [B]. Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    N, page, KVH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    # -1 reads page 0; an id past the pool reads its last page, as the
    # reference's clamped gather does
    pt = page_table.long().clamp(0, N - 1)
    S = P * page
    k = k_pages[pt].reshape(B, S, KVH, D).float()
    v = v_pages[pt].reshape(B, S, KVH, D).float()
    qh = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k) * scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = pos < seq_lens.to(q.device)[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, seq_lens):
    """Raise on what the kernel does not take (pointers are passed raw)."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, H, D] and the pools [N, page, KVH, D]")
    B, H, D = q.shape
    N, page, KVH, Dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or Dk != D:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q's D={D}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise ValueError(f"q and the pools must share one of "
                         f"{tuple(_DTYPES)}; got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_table and seq_lens must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(seq_lens.shape) != (B,):
        raise ValueError(f"page_table must be [B={B}, P] and seq_lens [B]")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, N, page, page_table.shape[1]) == 0:
        raise ValueError("empty batch, pool or page table")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    """Decode attention of one new token per sequence against paged KV.

    q [B, H, D] (H = KVH * G); k_pages / v_pages [N, page, KVH, D];
    page_table int32 [B, P] physical page ids (-1 = unmapped, reads page
    0); seq_lens int32 [B]. fp32 or bf16. Returns [B, H, D] in q's dtype.

    For CUDA tensors this calls the operator
    ``torch.ops.repro_torch.paged_attention``, whose CUDA implementation
    launches the hand-written kernels (``csrc/paged_attention.cu``: the
    split kernel, then the merge unless there is one split) on the current
    stream; a build or launch error raises. For CPU tensors it runs
    `paged_attention_plain`. Any other device raises.
    `paged_attention.launches` counts the calls that launched the
    kernels."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k_pages, v_pages, page_table, seq_lens)
    return _OP(q, k_pages, v_pages, page_table, seq_lens)


def _launch(q, k_pages, v_pages, page_table, seq_lens):
    """The operator's CUDA implementation: launch the kernels."""
    from . import _build
    lib = _build.load("paged_attention")
    B, H, D = q.shape
    N, page, KVH, _ = k_pages.shape
    P = page_table.shape[1]
    pps, splits = split_plan(B * KVH, P, sm_count(q.device))
    out = torch.empty_like(q)
    vp = ctypes.c_void_p
    part_acc = part_ml = None
    if splits > 1:  # fp32 partials (m, l, acc) of every split, then merged
        G = H // KVH
        part_acc = torch.empty((B * KVH, splits, G, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B * KVH, splits, G, 2), dtype=torch.float32,
                              device=q.device)
    err = lib.paged_attention_launch(
        vp(q.data_ptr()), vp(k_pages.data_ptr()), vp(v_pages.data_ptr()),
        vp(page_table.data_ptr()), vp(seq_lens.data_ptr()),
        vp(out.data_ptr()),
        vp(part_acc.data_ptr() if part_acc is not None else None),
        vp(part_ml.data_ptr() if part_ml is not None else None),
        _DTYPES[q.dtype], B, H, KVH, D, N, page, P, pps, splits,
        vp(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
_OP = _library.define(
    "paged_attention", "(Tensor q, Tensor k_pages, Tensor v_pages, "
    "Tensor page_table, Tensor seq_lens) -> Tensor", _launch,
    lambda q, *_: torch.empty_like(q),
    lambda *a: [paged_attention_plain(*a)])
