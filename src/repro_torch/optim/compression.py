"""Gradient compression: int8 block quantization with error feedback.

The port of `repro.optim.compression`:

  * quantize / dequantize: int8 with a per-block fp32 scale (blocks of
    256 of the flattened tensor, the last one zero-padded), the
    reference's rounding (half to even) and clipping, so the int8 values
    and the scales equal the reference's exactly;
  * ErrorFeedback: the quantization error is kept and added back before
    the next step's quantization (Seide et al.).

`compressed_psum` is the reference's collective over a mesh axis, as its
code computes it: each participant quantizes locally, the int8 payloads
and the fp32 per-block scales are all-gathered, and the result is
``sum_p scale_p * q_p``. PyTorch has no ambient axis, so the live
`DeviceMesh` is passed with the axis name; the gathers go through
`repro_torch.parallel.comm` (gloo stages CUDA tensors through the host).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .adamw import tree_map

BLOCK = 256


def _pad_to_block(x):
    n = x.numel()
    flat = F.pad(x.reshape(-1), (0, (-n) % BLOCK))
    return flat.reshape(-1, BLOCK), n


def quantize(x):
    """x -> (int8 values [n_blocks, BLOCK], fp32 scales [n_blocks],
    orig_size)."""
    blocks, n = _pad_to_block(x.float())
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], n


def dequantize(q, scale, n, shape):
    x = q.float() * scale[:, None]
    return x.reshape(-1)[:n].reshape(shape)


def quantization_error(x):
    q, s, n = quantize(x)
    return x.float() - dequantize(q, s, n, x.shape)


def gather_quantized(x, axis_name: str, mesh):
    """Quantize `x` and all-gather the payloads and scales over the
    processes along `axis_name` of `mesh`: (q [P, n_blocks, BLOCK] int8,
    scales [P, n_blocks] fp32, numel), by position on the axis."""
    from ..parallel import comm
    q, s, n = quantize(x)
    group = mesh.get_group(axis_name)
    scales = torch.stack(comm.all_gather(s, group=group))
    qs = torch.stack(comm.all_gather(q, group=group))
    return qs, scales, n


def compressed_psum(x, axis_name: str, mesh):
    """The int8-quantized sum of `x` over the processes along `axis_name`
    of the live `mesh`: every process gets ``sum_p scale_p * q_p`` in
    `x`'s shape (fp32). A collective: each process of the axis's group
    calls it."""
    qs, scales, n = gather_quantized(x, axis_name, mesh)
    total = torch.einsum("pb,pbk->bk", scales, qs.float())
    return total.reshape(-1)[:n].reshape(x.shape)


class ErrorFeedback(NamedTuple):
    residual: object  # a tree like grads


def ef_init(grads_like):
    return ErrorFeedback(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def ef_compress(ef: ErrorFeedback, grads):
    """Add the residual, quantize, keep the new residual. Returns
    (what is sent, ef)."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
    err = tree_map(quantization_error, corrected)
    sent = tree_map(lambda c, e: c - e, corrected, err)
    return sent, ErrorFeedback(residual=err)
