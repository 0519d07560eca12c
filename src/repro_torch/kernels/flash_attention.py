"""Causal / sliding-window GQA flash attention (forward): the CUDA kernel
and its plain PyTorch version.

The port of `repro.kernels.flash_attention.flash_attention_kernel` (the
TPU kernel), with the semantics of its body, not of `layers.attention`:
q, k and v are cast to fp32 and p stays fp32 through the p.v product; the
causal mask compares absolute positions (query row i, key j: no offset
when S != T); ``window > 0`` also hides keys with i - j >= window; hidden
scores are -1e30 and their p is 0; the output is acc / max(l, 1e-30) in
q's dtype, so a row that sees no key is 0.

`flash_attention_plain` is the plain version (a masked softmax over query
row blocks; it never holds more than `ROW_BLOCK` rows of scores).
`flash_attention_kernel` is the wrapper `ops.flash_attention_op` calls:
for CUDA tensors it launches ``csrc/flash_attention.cu`` (head_dim up to
256; bf16 on the tensor cores, with p split into two bf16 terms for the
p.v product, fp32 on the CUDA cores), for CPU tensors it runs the plain
version. The function does not depend on ``block_q`` / ``block_kv``: they
are validated and kept in the signature; the CUDA kernel uses its own
tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import _library

NEG_INF = -1e30
MAX_HEAD_DIM = 256
ROW_BLOCK = 1024  # query rows per pass of the plain version
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes, by the number its launcher reports
ROUTES = ("fp32_cuda_cores", "bf16_tensor_cores")


def _validate(q, k, v, window, block_q, block_kv):
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be [B, S, H, hd] and k, v [B, T, KVH, hd]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    KVH = k.shape[2]
    if KVH == 0 or H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    for name, x in (("block_q", block_q), ("block_kv", block_kv),
                    ("window", window)):
        if not isinstance(x, int) or isinstance(x, bool):
            raise ValueError(f"{name} must be an int; got {x!r}")
    if block_q <= 0 or block_kv <= 0:
        raise ValueError(f"block sizes must be positive; got {block_q}, "
                         f"{block_kv}")
    if not 0 <= window < 2 ** 31:
        raise ValueError(f"window must be in [0, 2^31); got {window}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = 512, block_kv: int = 512):
    """The kernel's function in plain PyTorch (fp32 inside).

    q [B, S, H, hd]; k, v [B, T, KVH, hd] -> [B, S, H, hd] in q's dtype."""
    _validate(q, k, v, window, block_q, block_kv)
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (hd ** 0.5)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for s0 in range(0, S, ROW_BLOCK):
        s1 = min(S, s0 + ROW_BLOCK)
        qb = q[:, s0:s1].float().reshape(B, s1 - s0, KVH, G, hd)
        s = torch.einsum("bskgd,btkd->bkgst", qb, kf) * scale
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        mask = torch.ones((s1 - s0, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos[None, :]
        if window:
            mask &= qpos - kpos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = torch.einsum("bkgst,btkd->bkgsd", p, vf) / torch.clamp(
            p.sum(-1, keepdim=True), min=1e-30)
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, s1 - s0, H, hd).to(q.dtype)
    return out


def _check(q, k, v):
    """Raise on what the kernel does not take (pointers are passed raw)."""
    B, S, H, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one of {tuple(_DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, S, k.shape[1], hd) == 0:
        raise ValueError("empty batch, sequence or head")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("tensors too large for the kernel's int32 sizes")


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           block_q: int = 512, block_kv: int = 512):
    """Flash attention forward: q [B, S, H, hd]; k, v [B, T, KVH, hd] ->
    [B, S, H, hd] in q's dtype (H a multiple of KVH).

    For CUDA tensors this calls the operator
    ``torch.ops.repro_torch.flash_attention``, whose CUDA implementation
    launches the hand-written kernel (``csrc/flash_attention.cu``) on the
    current stream: fp32 or bf16, head_dim up to `MAX_HEAD_DIM`,
    contiguous inputs; anything else, or a build or launch error, raises. For CPU tensors it runs
    `flash_attention_plain`. Any other device raises.
    `flash_attention_kernel.launches` counts kernel launches and
    `flash_attention_kernel.route_launches` those of each route in
    `ROUTES` (the launcher routes by dtype)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _validate(q, k, v, window, block_q, block_kv)
    _check(q, k, v)
    return _OP(q, k, v, bool(causal), window)


def _launch(q, k, v, causal, window):
    """The operator's CUDA implementation: launch the kernel."""
    from . import _build
    lib = _build.load("flash_attention")
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    vp = ctypes.c_void_p
    route = ctypes.c_int(-1)
    err = lib.flash_attention_launch(
        vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
        vp(out.data_ptr()), _DTYPES[q.dtype], B, S, T, H, KVH, hd,
        int(causal), window,
        vp(torch.cuda.current_stream(q.device).cuda_stream),
        ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"error {err}")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.route_launches[ROUTES[route.value]] += 1
    return out


flash_attention_kernel.launches = 0
flash_attention_kernel.route_launches = dict.fromkeys(ROUTES, 0)
_OP = _library.define(
    "flash_attention", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "int window) -> Tensor", _launch, lambda q, *_: torch.empty_like(q),
    lambda q, k, v, causal, window: [flash_attention_plain(
        q, k, v, causal=causal, window=window)])
