"""PaliGemma-style VLM: SigLIP patch-embedding stub + gemma decoder (MQA).

The port of `repro.models.vlm`. The modality frontend is a stub: the
caller supplies precomputed patch embeddings ``[B, n_patches, D]``, which
are prepended to the text embeddings; the backbone is the dense
transformer (kv=1 MQA, GeGLU). Attention is fully causal over the image
and prompt prefix, as in the reference (PaliGemma itself attends
bidirectionally there).

`prefill` runs `transformer.prefill_embeds` over the patch prefix and the
prompt, whose pages it writes in place; `decode` is the dense one. Both
pass a `DeviceMesh` (``mesh=``) on, as the dense family takes it.
"""
from __future__ import annotations

import torch

from . import layers, transformer
from .config import ArchConfig

param_shapes = transformer.param_shapes
init = transformer.init
logits_fn = transformer.logits_fn
cache_spec = transformer.cache_spec
init_cache = transformer.init_cache
decode = transformer.decode  # post-prefill decode is identical to dense


def _embeds(cfg: ArchConfig, params, tokens, patch_embeds):
    """(patches then text embeddings [B, P + S, D], positions [B, P + S])."""
    B, S = tokens.shape
    P = patch_embeds.shape[1]
    dt = layers.torch_dtype(cfg.dtype)
    x = torch.cat([patch_embeds.to(dt),
                   layers.embed(params["embed"], tokens).to(dt)], dim=1)
    positions = torch.arange(P + S, device=tokens.device).expand(B, P + S)
    return x, positions


def forward(cfg: ArchConfig, params, tokens, patch_embeds):
    """tokens [B, S_text]; patch_embeds [B, n_patches, D] -> hidden over
    the full sequence [B, n_patches + S_text, D]."""
    x, positions = _embeds(cfg, params, tokens, patch_embeds)
    return transformer.forward_embeds(cfg, params, x, positions)


def loss(cfg: ArchConfig, params, batch):
    tokens, labels = batch["tokens"], batch["labels"]
    P = batch["patch_embeds"].shape[1]
    hidden = forward(cfg, params, tokens, batch["patch_embeds"])
    # text token s sits at position P + s; logits at P + s - 1 predict it
    S = tokens.shape[1]
    logits = logits_fn(cfg, params, hidden[:, P - 1: P + S - 1])
    l = layers.cross_entropy(logits, labels)
    return l, {"loss": l}


def prefill(cfg: ArchConfig, params, batch, cache, mesh=None):
    """Image + prompt prefill: the patch prefix occupies the first pages.
    Raises unless n_patches + S_text is a whole number of pages."""
    tokens, patch_embeds = batch["tokens"], batch["patch_embeds"]
    P, S = patch_embeds.shape[1], tokens.shape[1]
    if (P + S) % cfg.page_size:
        raise ValueError(f"{P} patches + {S} text tokens is not a multiple "
                         f"of the page size {cfg.page_size}")
    x, positions = _embeds(cfg, params, tokens, patch_embeds)
    return transformer.prefill_embeds(cfg, params, x, positions, cache,
                                      mesh=mesh)
