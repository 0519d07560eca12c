"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local
attention.

The port of `repro.models.hybrid`. Layers come in groups of (recurrent,
recurrent, local attention), stacked as ``rec1`` / ``rec2`` / ``attn``, and
the remainder layers are recurrent (``tail``); every layer has its own
GeGLU MLP. The RG-LRU trains and prefills through a parallel scan and
decodes with an O(1) state update; the local attention decodes over a
rolling ``win``-token K/V buffer (no paged cache).

`associative_scan` is the odd/even recursion of `jax.lax.associative_scan`
(about 2 log2 S levels of strided elementwise ops), so it combines in the
reference's order and differentiates under autograd; a closed form
through ``cumsum(log a)`` would overflow (a step decays by up to e^-8.5).
Where the reference mixes bf16 with fp32 or asks for fp32 results (the
RG-LRU's gates and state, the decode attention's scores and output), the
bf16 operand is upcast first (exact); the conv taps and the projections
stay in the config's dtype.

The group loop is a Python loop over the stacked weights, unbound once per
forward (see `transformer`); ``cfg.remat`` checkpoints each mixer, as the
reference checkpoints ``rec`` and ``att``. `prefill` and `decode` write the
layer slices of ``cache["rg_state"]`` / ``["conv_state"]`` /
``["win_k"]`` / ``["win_v"]`` in place (the window slot of a decode step at
``pos % win``) and return a new dict sharing them. The recurrent layers'
states are numbered as the reference numbers them: group g's ``rec1`` at
2g, its ``rec2`` at 2g + 1, the tail's layer t at 2G + t.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from . import layers
from .config import ArchConfig
from .ssm import _per_layer, softplus

RG_C = 8.0  # Griffin's fixed scalar in a_t = exp(-c * softplus(lam) * r_t)
GROUP = ("rec1", "rec2", "attn")


def _group_counts(cfg: ArchConfig):
    return cfg.n_layers // 3, cfg.n_layers % 3  # (groups of R,R,A; tail R's)


def _rec_shapes(cfg: ArchConfig, L: int) -> dict:
    D = cfg.d_model
    dt = cfg.dtype
    return {
        "ln": ((L, D), dt),
        "wx": ((L, D, D), dt),
        "wy": ((L, D, D), dt),
        "conv_w": ((L, cfg.conv_width, D), dt),
        "conv_b": ((L, D), dt),
        "w_r": ((L, D, D), dt),
        "w_i": ((L, D, D), dt),
        "a_param": ((L, D), "float32"),
        "w_out": ((L, D, D), dt),
        "ln_mlp": ((L, D), dt),
        "m1": ((L, D, cfg.d_ff), dt),
        "m2": ((L, cfg.d_ff, D), dt),
        "m3": ((L, D, cfg.d_ff), dt),
    }


def _attn_shapes(cfg: ArchConfig, L: int) -> dict:
    D, H, KVH, hd, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype
    return {
        "ln": ((L, D), dt),
        "wq": ((L, D, H, hd) if cfg.attn_4d else (L, D, H * hd), dt),
        "wk": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wv": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wo": ((L, H, hd, D) if cfg.attn_4d else (L, H * hd, D), dt),
        "ln_mlp": ((L, D), dt),
        "m1": ((L, D, F_), dt),
        "m2": ((L, F_, D), dt),
        "m3": ((L, D, F_), dt),
    }


def param_shapes(cfg: ArchConfig) -> dict:
    G, R = _group_counts(cfg)
    dt = cfg.dtype
    shapes = {
        "embed": ((cfg.padded_vocab, cfg.d_model), dt),
        "rec1": _rec_shapes(cfg, G),
        "rec2": _rec_shapes(cfg, G),
        "attn": _attn_shapes(cfg, G),
        "ln_f": ((cfg.d_model,), dt),
    }
    if R:
        shapes["tail"] = _rec_shapes(cfg, R)
    return shapes


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device`; every recurrent layer's
    ``a_param`` = 0.65, as the reference sets it."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = layers.init_params(param_shapes(cfg), gen, dev)
    G, R = _group_counts(cfg)
    for name, L in (("rec1", G), ("rec2", G), ("tail", R)):
        if L and name in p:
            p[name]["a_param"] = torch.full((L, cfg.d_model), 0.65,
                                            dtype=torch.float32, device=dev)
    return p


# ------------------------------------------------------------------ RG-LRU --
def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd, dim: int):
    """Even elements at 0, 2, ... and odd ones at 1, 3, ... along `dim`
    (len(even) == len(odd) or len(odd) + 1)."""
    n = odd.shape[dim]
    both = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1)
    out = both.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim=dim)
    return out


def _strided(x, dim: int, start: int, stop=None, step: int = 1):
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple of tensors `elems` along `dim` with the
    associative `combine`, by `jax.lax.associative_scan`'s recursion:
    combine adjacent pairs, scan those, then fill in the even elements."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_strided(e, dim, 0, -1, 2) for e in elems),
                      tuple(_strided(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine(tuple(_strided(e, dim, 0, -1) for e in odd),
                       tuple(_strided(e, dim, 2, None, 2) for e in elems))
    else:
        even = combine(odd, tuple(_strided(e, dim, 2, None, 2)
                                  for e in elems))
    even = tuple(torch.cat([_strided(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _rglru_gates(x, r, i, a_param):
    """(a, b) of h_t = a_t h_{t-1} + b_t, fp32."""
    log_a = -RG_C * softplus(a_param) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, gated * (i.float() * x.float())


def _rglru_scan_f32(x, r, i, a_param):
    """Every step's RG-LRU state, fp32 [B,S,D]."""
    a, b = _rglru_gates(x, r, i, a_param[None, None, :])
    return associative_scan(_combine, (a, b), dim=1)[1]


def _rglru_scan(x, r, i, a_param):
    """Parallel RG-LRU. x/r/i: [B,S,D] (r,i post-sigmoid); returns [B,S,D]."""
    return _rglru_scan_f32(x, r, i, a_param).to(x.dtype)


def _rglru_step(state, x, r, i, a_param):
    """One-token RG-LRU. state/x/r/i: [B, D] -> (state, y)."""
    a, b = _rglru_gates(x, r, i, a_param[None, :])
    h = a * state + b
    return h, h.to(x.dtype)


# ------------------------------------------------------------------ mixers --
def _conv(xp, lp, S: int, W: int):
    """The depthwise causal conv over xp [B, W-1+S, D] (taps summed in
    the activations' dtype, in tap order) + bias -> [B, S, D]."""
    return sum(xp[:, i: i + S, :] * lp["conv_w"][i][None, None, :]
               for i in range(W)) + lp["conv_b"][None, None, :]


def _mlp_half(x, lp):
    h2 = layers.rms_norm(x, lp["ln_mlp"])
    return x + layers.mlp(h2, lp["m1"], lp["m2"], lp["m3"], "geglu")


def _rec_mixer(cfg: ArchConfig, x, lp, conv_state=None, rg_state=None):
    """One recurrent layer over x [B,S,D]: (x out, the RG-LRU's last state
    [B,D] fp32, the conv's state [B,W-1,D]). With `rg_state` (decode,
    S = 1) the RG-LRU is one step from it and the conv continues from
    `conv_state`."""
    B, S, _ = x.shape
    h = layers.rms_norm(x, lp["ln"])
    xb = h @ lp["wx"]
    yb = h @ lp["wy"]
    W = cfg.conv_width
    if conv_state is None:
        conv_state = xb.new_zeros((B, W - 1, xb.shape[-1]))
    xp = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
    xc = _conv(xp, lp, S, W)
    conv_state = xp[:, -(W - 1):, :]
    r = torch.sigmoid(xc @ lp["w_r"])
    i = torch.sigmoid(xc @ lp["w_i"])
    if rg_state is None:
        hfull = _rglru_scan_f32(xc, r, i, lp["a_param"])
        rg_state, y = hfull[:, -1], hfull.to(x.dtype)
    else:
        rg_state, y = _rglru_step(rg_state, xc[:, 0], r[:, 0], i[:, 0],
                                  lp["a_param"])
        y = y[:, None, :]
    out = (y * F.gelu(yb, approximate="tanh")) @ lp["w_out"]
    x = x + out.to(x.dtype)
    return _mlp_half(x, lp), rg_state, conv_state


def _rec_mixer_train(cfg: ArchConfig, x, lp):
    return _rec_mixer(cfg, x, layers.at_use(lp))[0]


def _attn_qkv(cfg: ArchConfig, x, lp, positions):
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = layers.rms_norm(x, lp["ln"])
    q = layers.qk_proj(h, lp["wq"], H, hd)
    k = layers.qk_proj(h, lp["wk"], KVH, hd)
    v = layers.qk_proj(h, lp["wv"], KVH, hd)
    cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _attn_mixer(cfg: ArchConfig, x, positions, lp):
    """Local attention over x [B,S,D] at `positions`: (x out, k, v) with k
    after RoPE."""
    S = x.shape[1]
    q, k, v = _attn_qkv(cfg, x, lp, positions)
    attn = layers.pick_attention(S, S, cfg.flash_min_seq)
    o = attn(q, k, v, causal=True, window=cfg.window)
    x = x + layers.out_proj(o, lp["wo"]).to(x.dtype)
    return _mlp_half(x, lp), k, v


def _attn_mixer_train(cfg: ArchConfig, x, positions, lp):
    return _attn_mixer(cfg, x, positions, layers.at_use(lp))[0]


def _attn_mixer_decode(cfg: ArchConfig, x, lp, win_k, win_v, pos):
    """Rolling-window MQA decode. x [B,1,D]; win_k/v [B,win,KVH,hd]
    (written in place at slot pos % win); pos [B]."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    win = win_k.shape[1]
    q, k, v = _attn_qkv(cfg, x, lp, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    slot = (pos % win).long()
    bidx = torch.arange(B, device=x.device)
    win_k.index_put_((bidx, slot), k.to(win_k.dtype))
    win_v.index_put_((bidx, slot), v.to(win_v.dtype))
    # slots valid if their stored position <= pos (always true after wrap)
    slots = torch.arange(win, device=x.device)[None, :]
    valid = (slots <= pos[:, None]) | (pos[:, None] >= win)
    G = H // KVH
    qh = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qh.float(),
                     win_k.to(q.dtype).float()) / (hd ** 0.5)
    s = torch.where(valid[:, None, None, :], s, layers.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p.to(q.dtype).float(),
                     win_v.to(q.dtype).float())
    o4 = o.reshape(B, 1, H, hd).to(x.dtype)
    x = x + layers.out_proj(o4, lp["wo"]).to(x.dtype)
    return _mlp_half(x, lp)


# ---------------------------------------------------------------- training --
def _embed(cfg: ArchConfig, params, tokens):
    return layers.embed(params["embed"], tokens).to(
        layers.torch_dtype(cfg.dtype))


def _groups(params):
    """[(rec1, rec2, attn) layer dicts] of every group, unbound once."""
    return list(zip(*(_per_layer(params[k]) for k in GROUP)))


def forward(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> final hidden [B, S, D]."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed(cfg, params, tokens)
    rec = functools.partial(_rec_mixer_train, cfg)
    att = functools.partial(_attn_mixer_train, cfg)
    if cfg.remat:
        rec = functools.partial(checkpoint, rec, use_reentrant=False)
        att = functools.partial(checkpoint, att, use_reentrant=False)
    G, R = _group_counts(cfg)
    if G:
        for lp1, lp2, lpa in _groups(params):
            x = layers.activation_constraint(x, seq_over_model=cfg.seq_shard)
            x = rec(x, lp1)
            x = rec(x, lp2)
            x = att(x, positions, lpa)
    if R:
        for lp in _per_layer(params["tail"]):
            x = rec(x, lp)
    return layers.rms_norm(x, params["ln_f"])


def logits_fn(cfg: ArchConfig, params, hidden):
    return layers.mask_padded_logits(
        hidden @ layers.at_use(params["embed"].T).to(hidden.dtype),
        cfg.vocab)  # tied


def loss(cfg: ArchConfig, params, batch):
    hidden = forward(cfg, params, batch["tokens"])
    logits = logits_fn(cfg, params, hidden)
    l = layers.cross_entropy(logits, batch["labels"])
    return l, {"loss": l}


# ----------------------------------------------------------------- serving --
def cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """{name: (shape, dtype)} of the recurrent states and the window
    buffers of ``min(window, max_seq)`` tokens (nothing allocated)."""
    G, R = _group_counts(cfg)
    D, W = cfg.d_model, cfg.conv_width
    KVH, hd = cfg.n_kv_heads, cfg.head_dim
    win = min(cfg.window, max_seq)
    dt = layers.torch_dtype(cfg.dtype)
    n_rec = 2 * G + R
    return {
        "rg_state": ((n_rec, batch, D), torch.float32),
        "conv_state": ((n_rec, batch, W - 1, D), dt),
        "win_k": ((G, batch, win, KVH, hd), dt),
        "win_v": ((G, batch, win, KVH, hd), dt),
        "seq_lens": ((batch,), torch.int32),
    }


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda"):
    """Zero states and window buffers on `device` (the card unless the
    caller asks for the CPU)."""
    dev = _device.resolve(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items()}


def _layers(cfg: ArchConfig, params):
    """Every layer in the order a forward runs it: ("rec", its state
    index, lp) or ("attn", its group, lp)."""
    G, R = _group_counts(cfg)
    out = []
    if G:
        for g, (lp1, lp2, lpa) in enumerate(_groups(params)):
            out += [("rec", 2 * g, lp1), ("rec", 2 * g + 1, lp2),
                    ("attn", g, lpa)]
    if R:
        out += [("rec", 2 * G + t, lp)
                for t, lp in enumerate(_per_layer(params["tail"]))]
    return out


def prefill(cfg: ArchConfig, params, batch, cache):
    """Parallel prefill (the scan and the windowed attention) that also
    writes every layer's states and the last ``win`` tokens' K/V at slots
    ``position % win`` into the cache (in place). Returns (cache,
    logits_last [B, V])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed(cfg, params, tokens)
    win = cache["win_k"].shape[2]
    bidx = torch.arange(B, device=x.device)[:, None]
    for kind, j, lp in _layers(cfg, params):
        if kind == "rec":
            x, rg, cv = _rec_mixer(cfg, x, lp)
            cache["rg_state"][j] = rg
            cache["conv_state"][j] = cv
            continue
        x, k, v = _attn_mixer(cfg, x, positions, lp)
        n = min(S, win)  # the rolling buffer: the last `win` tokens
        slots = positions[:, S - n:] % win
        for buf, new in ((cache["win_k"][j], k), (cache["win_v"][j], v)):
            buf.zero_()
            buf[bidx, slots] = new[:, S - n:].to(buf.dtype)
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return dict(cache, seq_lens=seq_lens), logits


def decode(cfg: ArchConfig, params, cache, batch):
    """One decode step: tokens [B, 1] -> (cache, logits [B, V]); updates
    the states and writes the token's K/V into the window in place."""
    tokens = batch["tokens"]
    pos = cache["seq_lens"]
    x = _embed(cfg, params, tokens[:, 0])[:, None, :]
    for kind, j, lp in _layers(cfg, params):
        if kind == "rec":
            x, rg, cv = _rec_mixer(cfg, x, lp,
                                   conv_state=cache["conv_state"][j],
                                   rg_state=cache["rg_state"][j])
            cache["rg_state"][j] = rg
            cache["conv_state"][j] = cv
        else:
            x = _attn_mixer_decode(cfg, x, lp, cache["win_k"][j],
                                   cache["win_v"][j], pos)
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, 0])
    return dict(cache, seq_lens=pos + 1), logits
