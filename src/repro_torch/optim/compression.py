"""Gradient compression: int8 block quantization with error feedback.

The port of `repro.optim.compression`:

  * quantize / dequantize: int8 with a per-block fp32 scale (blocks of
    256 of the flattened tensor, the last one zero-padded), the
    reference's rounding (half to even) and clipping, so the int8 values
    and the scales equal the reference's exactly;
  * ErrorFeedback: the quantization error is kept and added back before
    the next step's quantization (Seide et al.).

`compressed_psum` is the reference's `shard_map` collective (an int8
all-reduce over a mesh axis); it waits for the training half of the
mesh-only pieces (ROADMAP A7b) and raises here.
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


def compressed_psum(x, axis_name: str):
    """The reference's int8-quantized psum along a mesh axis."""
    raise NotImplementedError(
        "compressed_psum is a collective over a device mesh: it waits for "
        "the port's mesh-only pieces (ROADMAP A7b)")


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
