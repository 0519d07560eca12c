"""Whisper-style encoder-decoder (audio family).

The port of `repro.models.encdec`. The conv audio frontend is a stub: the
caller supplies precomputed frame embeddings ``[B, enc_frames, D]``.
Encoder layers are bidirectional self-attention with RoPE; decoder layers
are causal self-attention, cross-attention over the encoder's output and a
two-matrix tanh-GELU MLP; the embedding is tied.

Serving: `prefill` encodes the frames once, stores every decoder layer's
cross-attention K/V densely in the cache (``enc_k`` / ``enc_v``, ``[L, B,
T, KVH, hd]``) and writes the prompt's self-attention pages; `decode`
attends over the paged self-attention cache (the paged-attention kernel
under ``attend_impl="kernel"``) and over the cached encoder K/V with
`_cross`, the plain materialising attention below ``flash_min_seq``
frames (as the reference's `layers.attention`). Both write the cache in
place, as the dense family's do.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..kvcache import paged
from . import layers, transformer
from .config import ArchConfig


def param_shapes(cfg: ArchConfig) -> dict:
    L, Le = cfg.n_layers, cfg.enc_layers
    D, V, F = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def attn_mats(L):
        if cfg.attn_4d:
            return {
                "wq": ((L, D, H, hd), dt), "wk": ((L, D, KVH, hd), dt),
                "wv": ((L, D, KVH, hd), dt), "wo": ((L, H, hd, D), dt),
            }
        return {
            "wq": ((L, D, H * hd), dt), "wk": ((L, D, KVH * hd), dt),
            "wv": ((L, D, KVH * hd), dt), "wo": ((L, H * hd, D), dt),
        }

    enc = {"ln1": ((Le, D), dt), "ln2": ((Le, D), dt),
           "w1": ((Le, D, F), dt), "w2": ((Le, F, D), dt)}
    enc.update(attn_mats(Le))
    dec = {"ln1": ((L, D), dt), "ln_x": ((L, D), dt), "ln2": ((L, D), dt),
           "w1": ((L, D, F), dt), "w2": ((L, F, D), dt)}
    dec.update(attn_mats(L))
    dec.update({f"x{k}": v for k, v in attn_mats(L).items()})
    return {"embed": ((V, D), dt), "enc": enc, "dec": dec,
            "ln_enc": ((D,), dt), "ln_f": ((D,), dt)}


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device` (the card by default)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return layers.init_params(param_shapes(cfg), gen, dev)


def _layers(tree):
    """The per-layer dicts of a stack of layers (one unbind per leaf)."""
    names = list(tree)
    return [dict(zip(names, ws))
            for ws in zip(*(torch.unbind(tree[k]) for k in names))]


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def _self_qkv(cfg, h, lp, cos, sin):
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.apply_rope(layers.qk_proj(h, lp["wq"], H, hd), cos, sin)
    k = layers.apply_rope(layers.qk_proj(h, lp["wk"], KVH, hd), cos, sin)
    return q, k, layers.qk_proj(h, lp["wv"], KVH, hd)


def _gelu_mlp(x, lp):
    return layers.mlp(x, lp["w1"], lp["w2"], None, "gelu")


def _enc_block(cfg, x, cos, sin, lp):
    lp = layers.at_use(lp)
    h = layers.rms_norm(x, lp["ln1"])
    q, k, v = _self_qkv(cfg, h, lp, cos, sin)
    o = layers.attention(q, k, v, causal=False)
    x = x + layers.out_proj(o, lp["wo"]).to(x.dtype)
    return x + _gelu_mlp(layers.rms_norm(x, lp["ln2"]), lp)


def encode(cfg: ArchConfig, params, enc_embeds):
    """enc_embeds [B, T, D] (the stub frontend's output) -> encoder
    hidden [B, T, D]."""
    B, T, _ = enc_embeds.shape
    cos, sin = layers.rope_tables(_positions(B, T, enc_embeds.device),
                                  cfg.head_dim, cfg.rope_theta)
    x = enc_embeds.to(layers.torch_dtype(cfg.dtype))
    blk = functools.partial(_enc_block, cfg)
    for lp in _layers(params["enc"]):
        if cfg.remat:
            x = checkpoint(blk, x, cos, sin, lp, use_reentrant=False)
        else:
            x = blk(x, cos, sin, lp)
    return layers.rms_norm(x, params["ln_enc"])


def _cross_kv(cfg, enc_out, lp):
    KVH, hd = cfg.n_kv_heads, cfg.head_dim
    return (layers.qk_proj(enc_out, lp["xwk"], KVH, hd),
            layers.qk_proj(enc_out, lp["xwv"], KVH, hd))


def _cross(cfg, x, lp, kx, vx):
    """x + cross-attention of x's queries over the encoder's K/V."""
    S, T = x.shape[1], kx.shape[1]
    qx = layers.qk_proj(layers.rms_norm(x, lp["ln_x"]), lp["xwq"],
                        cfg.n_heads, cfg.head_dim)
    ox = layers.pick_attention(S, T, cfg.flash_min_seq)(qx, kx, vx,
                                                        causal=False)
    return x + layers.out_proj(ox, lp["xwo"]).to(x.dtype)


def _dec_layer(cfg, x, cos, sin, enc_out, lp):
    """One decoder layer over x [B, S, D]: causal self-attention,
    cross-attention over enc_out [B, T, D], the MLP. Returns (x, the
    self-attention K and V, the cross-attention K and V)."""
    S = x.shape[1]
    h = layers.rms_norm(x, lp["ln1"])
    q, k, v = _self_qkv(cfg, h, lp, cos, sin)
    o = layers.pick_attention(S, S, cfg.flash_min_seq)(q, k, v, causal=True)
    x = x + layers.out_proj(o, lp["wo"]).to(x.dtype)
    kx, vx = _cross_kv(cfg, enc_out, lp)
    x = _cross(cfg, x, lp, kx, vx)
    return x + _gelu_mlp(layers.rms_norm(x, lp["ln2"]), lp), k, v, kx, vx


def _dec_block(cfg, x, cos, sin, enc_out, lp):
    return _dec_layer(cfg, x, cos, sin, enc_out, layers.at_use(lp))[0]


def forward(cfg: ArchConfig, params, tokens, enc_embeds):
    """tokens [B, S], enc_embeds [B, T, D] -> decoder hidden [B, S, D]."""
    B, S = tokens.shape
    enc_out = encode(cfg, params, enc_embeds)
    cos, sin = layers.rope_tables(_positions(B, S, tokens.device),
                                  cfg.head_dim, cfg.rope_theta)
    x = layers.embed(params["embed"], tokens).to(
        layers.torch_dtype(cfg.dtype))
    blk = functools.partial(_dec_block, cfg)
    for lp in _layers(params["dec"]):
        if cfg.remat:
            x = checkpoint(blk, x, cos, sin, enc_out, lp,
                           use_reentrant=False)
        else:
            x = blk(x, cos, sin, enc_out, lp)
    return layers.rms_norm(x, params["ln_f"])


def logits_fn(cfg: ArchConfig, params, hidden):
    return layers.mask_padded_logits(
        hidden @ layers.at_use(params["embed"].T).to(hidden.dtype),
        cfg.vocab)  # tied


def loss(cfg: ArchConfig, params, batch):
    hidden = forward(cfg, params, batch["tokens"], batch["enc_embeds"])
    logits = logits_fn(cfg, params, hidden)
    l = layers.cross_entropy(logits, batch["labels"])
    return l, {"loss": l}


# ----------------------------------------------------------------- serving --
def cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The dense paged cache plus the encoder's K/V of every decoder
    layer, ``[L, B, enc_frames, KVH, hd]`` each."""
    spec = transformer.cache_spec(cfg, batch, max_seq)
    enc = ((cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads,
            cfg.head_dim), layers.torch_dtype(cfg.dtype))
    spec["enc_k"] = spec["enc_v"] = enc
    return spec


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda",
               mesh=None):
    """The dense paged cache (on a ``"model"`` mesh, this process's
    physical pages) and the encoder's K/V of `batch` rows, whole."""
    cache = transformer.init_cache(cfg, batch, max_seq, device=device,
                                   mesh=mesh)
    shape, dt = cache_spec(cfg, batch, max_seq)["enc_k"]
    dev = cache["k_pages"].device
    cache["enc_k"] = torch.zeros(shape, dtype=dt, device=dev)
    cache["enc_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def prefill(cfg: ArchConfig, params, batch, cache, mesh=None):
    """Encode the frames, store each decoder layer's cross K/V in
    ``enc_k`` / ``enc_v`` and prefill the decoder, writing the cache in
    place (on a ``"model"`` mesh, the pages this process holds). Returns
    (cache, logits_last [B, V])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(cfg, params, batch["enc_embeds"])
    T = enc_out.shape[1]
    if T != cache["enc_k"].shape[2]:
        raise ValueError(f"{T} encoder frames, the cache holds "
                         f"{cache['enc_k'].shape[2]}")
    cos, sin = layers.rope_tables(_positions(B, S, tokens.device),
                                  cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens].to(layers.torch_dtype(cfg.dtype))
    pt = cache["page_table"]
    for l, lp in enumerate(_layers(params["dec"])):
        x, k, v, kx, vx = _dec_layer(cfg, x, cos, sin, enc_out, lp)
        paged.write_prefill(cache["k_pages"][l], k, pt, mesh=mesh)
        paged.write_prefill(cache["v_pages"][l], v, pt, mesh=mesh)
        cache["enc_k"][l] = kx
        cache["enc_v"][l] = vx
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return dict(cache, seq_lens=seq_lens), logits


def decode(cfg: ArchConfig, params, cache, batch, mesh=None):
    """One decode step: tokens [B, 1] -> (cache, logits [B, V]); writes
    the new token's self-attention K/V into the pages in place (on a
    ``"model"`` mesh through `paged.write_attend_seqpar`, as the
    reference's decode takes it)."""
    tokens = batch["tokens"]
    pos = cache["seq_lens"]
    pt = cache["page_table"]
    cos, sin = layers.rope_tables(pos[:, None], cfg.head_dim,
                                  cfg.rope_theta)
    x = params["embed"][tokens[:, 0]].to(
        layers.torch_dtype(cfg.dtype))[:, None, :]  # [B, 1, D]
    for l, lp in enumerate(_layers(params["dec"])):
        h = layers.rms_norm(x, lp["ln1"])
        q, k, v = _self_qkv(cfg, h, lp, cos, sin)
        o, _, _ = paged.write_attend_seqpar(
            q[:, 0], k[:, 0], v[:, 0], cache["k_pages"][l],
            cache["v_pages"][l], pt, pos, mesh=mesh, impl=cfg.attend_impl)
        x = x + layers.out_proj(o[:, None], lp["wo"]).to(x.dtype)
        x = _cross(cfg, x, lp, cache["enc_k"][l], cache["enc_v"][l])
        x = x + _gelu_mlp(layers.rms_norm(x, lp["ln2"]), lp)
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, 0])
    return dict(cache, seq_lens=pos + 1), logits
