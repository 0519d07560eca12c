"""Dense GQA transformer LM (nemotron / stablelm / mistral / granite):
training (`forward`, `loss`) and serving (prefill + paged-KV decode).

The port of `repro.models.transformer`. Parameters are a dict of tensors
stacked over layers, as in the reference, and the layer loop is a Python
loop where the reference scans. Decode uses the paged KV cache managed by
PIM-malloc (`repro_torch.kvcache`).

Training differentiates through `torch.autograd`. `forward_embeds` unbinds
the stacked weights once per forward, so their backward stacks the L
per-layer gradients once (indexing ``w[l]`` on every layer would make a
zero tensor the size of the whole stack per layer in the backward).
``cfg.remat`` checkpoints each layer's block (the reference's
`jax.checkpoint`): the backward recomputes it.

`prefill` and `decode` **write the cache's pages in place** (the layer
slices of ``cache["k_pages"]`` / ``cache["v_pages"]``) and return a new
dict that shares them: the reference is functional, but a functional copy
of a full-width cache per layer per token would move gigabytes per step.

Sequence parallelism: `init_cache`, `prefill` and `decode` take a
`DeviceMesh` of processes (``mesh=``). With a ``"model"`` axis the cache
holds this process's slice of the physical pages, the prefill computes on
every process and writes only its own pages, and the decode takes
`paged.write_attend_seqpar` (the reference's order,
`repro.models.transformer.decode`), whose partials combine over
``"model"``. The pages are split whatever ``cfg.kv_seq_parallel`` says,
so on such a mesh the decode always takes it: the reference's GSPMD
`attend` over split pools computes the same function. Tensors are this
process's batch rows (`paged.batch_rows`). Without a mesh, the reference
with ``cfg.kv_seq_parallel`` falls back to write + `attend` *without*
passing ``cfg.attend_impl`` (so its Pallas kernel is never reached
there); the port writes the token and calls
`attend(impl=cfg.attend_impl)`. Both compute the same function.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..kvcache import paged
from . import layers
from .config import ArchConfig


def param_shapes(cfg: ArchConfig) -> dict:
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.padded_vocab, cfg.d_ff
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    blocks = {
        "ln1": ((L, D), dt),
        "ln2": ((L, D), dt),
        "wq": ((L, D, H, hd) if cfg.attn_4d else (L, D, H * hd), dt),
        "wk": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wv": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wo": ((L, H, hd, D) if cfg.attn_4d else (L, H * hd, D), dt),
        "w1": ((L, D, F), dt),
        "w2": ((L, F, D), dt),
    }
    if layers.mlp_n_mats(cfg.mlp) == 3:
        blocks["w3"] = ((L, D, F), dt)
    shapes = {"embed": ((V, D), dt), "blocks": blocks, "ln_f": ((D,), dt)}
    if not cfg.tie_embeddings:
        shapes["head"] = ((D, V), dt)
    return shapes


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed`, made on `device` in the config's dtype
    (the card unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return layers.init_params(param_shapes(cfg), gen, dev)


def logits_fn(cfg: ArchConfig, params, hidden):
    head = layers.at_use(params["embed"].T if cfg.tie_embeddings
                         else params["head"])
    return layers.mask_padded_logits(hidden @ head.to(hidden.dtype),
                                     cfg.vocab)


def _layer(params, l: int) -> dict:
    return {k: v[l] for k, v in params["blocks"].items()}


def dense_mlp(cfg: ArchConfig, h, lp):
    """The dense family's feed-forward of one layer: `layers.mlp` over
    ``w1`` / ``w2`` (/ ``w3``). The other families that share this
    module's block pass their own (``ffn``: the MoE's routed experts)."""
    return layers.mlp(h, lp["w1"], lp["w2"], lp.get("w3"), cfg.mlp)


# ---------------------------------------------------------------- training --
def _block(cfg: ArchConfig, x, positions, lp, *, window: int = 0,
           ffn=dense_mlp):
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lp = layers.at_use(lp)
    if cfg.seq_shard:
        # Megatron-SP: the residual is sequence-sharded between blocks;
        # gather the sequence here so the TP matmuls see whole sequences
        x = layers.activation_constraint(x, seq_over_model=False)
    h = layers.rms_norm(x, lp["ln1"])
    q = layers.qk_proj(h, lp["wq"], H, hd)
    k = layers.qk_proj(h, lp["wk"], KVH, hd)
    v = layers.qk_proj(h, lp["wv"], KVH, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    if cfg.gqa_expand and KVH != H:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    attn = layers.pick_attention(S, S, cfg.flash_min_seq)
    o = attn(q, k, v, causal=True, window=window)
    x = x + layers.activation_constraint(
        layers.out_proj(o, lp["wo"]).to(x.dtype))
    h2 = layers.rms_norm(x, lp["ln2"])
    x = x + layers.activation_constraint(ffn(cfg, h2, lp))
    return x


def forward_embeds(cfg: ArchConfig, params, x, positions, ffn=dense_mlp):
    """x [B, S, D] input embeddings -> final hidden [B, S, D]."""
    blk = functools.partial(_block, cfg, ffn=ffn)
    names = list(params["blocks"])
    per_layer = zip(*(torch.unbind(params["blocks"][k]) for k in names))
    for ws in per_layer:
        lp = dict(zip(names, ws))
        x = layers.activation_constraint(x, seq_over_model=cfg.seq_shard)
        if cfg.remat:
            x = checkpoint(blk, x, positions, lp, use_reentrant=False)
        else:
            x = blk(x, positions, lp)
    return layers.rms_norm(x, params["ln_f"])


def forward(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> final hidden [B, S, D]."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = layers.embed(params["embed"], tokens).to(
        layers.torch_dtype(cfg.dtype))
    return forward_embeds(cfg, params, x, positions)


def loss(cfg: ArchConfig, params, batch):
    hidden = forward(cfg, params, batch["tokens"])
    logits = logits_fn(cfg, params, hidden)
    l = layers.cross_entropy(logits, batch["labels"])
    return l, {"loss": l}


# ----------------------------------------------------------------- serving --
def cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    return paged.cache_spec(
        n_layers=cfg.n_layers, batch=batch, max_seq=max_seq,
        page_size=cfg.page_size, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, dtype=layers.torch_dtype(cfg.dtype))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda",
               mesh=None):
    """The paged cache of `batch` rows (this process's); with a mesh that
    has a ``"model"`` axis, of this process's physical pages."""
    return paged.init_cache(
        n_layers=cfg.n_layers, batch=batch, max_seq=max_seq,
        page_size=cfg.page_size, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, dtype=layers.torch_dtype(cfg.dtype),
        device=device, mesh=mesh)


def prefill(cfg: ArchConfig, params, batch, cache, ffn=dense_mlp,
            mesh=None):
    """Full-sequence forward that also writes the paged KV cache (in
    place). Returns (cache, logits_last [B, V])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"][tokens].to(layers.torch_dtype(cfg.dtype))
    return prefill_embeds(cfg, params, x, positions, cache, ffn=ffn,
                          mesh=mesh)


def prefill_embeds(cfg: ArchConfig, params, x, positions, cache,
                   ffn=dense_mlp, mesh=None):
    """`prefill` over input embeddings x [B, S, D] at `positions` [B, S]
    (the VLM's patch prefix and text share it); writes the pages of all S
    positions (on a ``"model"`` mesh, those this process holds) and sets
    seq_lens to S."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
    attn = layers.pick_attention(S, S, cfg.flash_min_seq)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = layers.rms_norm(x, lp["ln1"])
        q = layers.apply_rope(layers.qk_proj(h, lp["wq"], H, hd), cos, sin)
        k = layers.apply_rope(layers.qk_proj(h, lp["wk"], KVH, hd), cos, sin)
        v = layers.qk_proj(h, lp["wv"], KVH, hd)
        o = attn(q, k, v, causal=True)
        x = x + layers.out_proj(o, lp["wo"]).to(x.dtype)
        h2 = layers.rms_norm(x, lp["ln2"])
        x = x + ffn(cfg, h2, lp)
        paged.write_prefill(cache["k_pages"][l], k, cache["page_table"],
                            mesh=mesh)
        paged.write_prefill(cache["v_pages"][l], v, cache["page_table"],
                            mesh=mesh)
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return dict(cache, seq_lens=seq_lens), logits


def decode(cfg: ArchConfig, params, cache, batch, ffn=dense_mlp,
           mesh=None):
    """One decode step: tokens [B, 1] -> (cache, logits [B, V]); writes
    the new token's K/V into the cache's pages in place (on a ``"model"``
    mesh, into the page's owner: `paged.write_attend_seqpar`).

    The RoPE tables are the same for every layer of a step, so they are
    made once per step."""
    tokens = batch["tokens"]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["seq_lens"]  # [B] position of the new token
    pt = cache["page_table"]
    cos, sin = layers.rope_tables(pos[:, None], hd, cfg.rope_theta)
    x = params["embed"][tokens[:, 0]].to(
        layers.torch_dtype(cfg.dtype))[:, None, :]  # [B, 1, D]
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = layers.rms_norm(x, lp["ln1"])
        q = layers.apply_rope(layers.qk_proj(h, lp["wq"], H, hd), cos,
                              sin)[:, 0]
        k = layers.apply_rope(layers.qk_proj(h, lp["wk"], KVH, hd), cos,
                              sin)[:, 0]
        v = layers.qk_proj(h, lp["wv"], KVH, hd)[:, 0]
        o, _, _ = paged.write_attend_seqpar(
            q, k, v, cache["k_pages"][l], cache["v_pages"][l], pt, pos,
            mesh=mesh, impl=cfg.attend_impl)
        x = x + layers.out_proj(o[:, None], lp["wo"]).to(x.dtype)
        h2 = layers.rms_norm(x, lp["ln2"])
        x = x + ffn(cfg, h2, lp)
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, 0])
    return dict(cache, seq_lens=pos + 1), logits
