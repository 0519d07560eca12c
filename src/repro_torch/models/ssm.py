"""Mamba-2 / SSD (state-space duality) family: an attention-free LM.

The port of `repro.models.ssm`. Training and prefill run the *chunked* SSD
(quadratic within a chunk, a linear recurrence across chunks); decode is
the O(1) recurrent update ``h' = exp(dt * A) h + dt * (B x)``. The state
has a constant size and there is no KV cache to page, so `launch.serve`
refuses this family as the reference's does; a server drives `prefill`
and `decode` directly.

Numerics follow the reference: the projections and the causal conv stay
in the config's dtype (the conv's taps summed in that dtype, in tap
order); dt, A, the decays and every SSD product are fp32, their bf16
operands upcast first (exact) where the reference mixes them or asks for
fp32 results; the SSD's output is cast back to the activations' dtype.
Padding to whole chunks uses dt = 0, which adds nothing to the state.

One deviation: the reference takes the intra-chunk decays' ``exp`` over
every (i, j) of a chunk and masks the non-causal ones after it. Above the
diagonal the exponent is the chunk's decay sum negated, which passes
fp32's exp range (88.7) once ``sum(dt) * |A|`` over a chunk does; the
``where`` hides the inf in the forward, but its backward multiplies 0 by
it, and every gradient turns NaN. At full width (A down to -16, chunks of
128), trained on 4 x 4096 tokens from the init, mamba2-130m's first
update made every loss after it NaN on the card. The port masks the
exponent to -inf before the ``exp``: the forward is the same, the
gradients are the reference's wherever those are finite, and finite
where they are NaN (ROADMAP C).

The layer loop is a Python loop over the stacked weights, unbound once per
forward (see `transformer`); ``cfg.remat`` checkpoints each block.
`prefill` and `decode` write the layer slices of ``cache["ssm_state"]``
and ``cache["conv_state"]`` in place and return a new dict sharing them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..parallel.sharding import is_dtensor
from . import layers
from .config import ArchConfig


def dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N  # x, B, C go through the causal conv
    return d_inner, H, N, conv_dim


def param_shapes(cfg: ArchConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    d_inner, H, N, conv_dim = dims(cfg)
    dt = cfg.dtype
    blocks = {
        "ln": ((L, D), dt),
        "wz": ((L, D, d_inner), dt),
        "wxi": ((L, D, d_inner), dt),
        "wb": ((L, D, N), dt),
        "wc": ((L, D, N), dt),
        "wdt": ((L, D, H), dt),
        "conv_w": ((L, cfg.conv_width, conv_dim), dt),
        "conv_b": ((L, conv_dim), dt),
        "a_log": ((L, H), "float32"),
        "d_skip": ((L, H), "float32"),
        "dt_bias": ((L, H), "float32"),
        "ln_y": ((L, d_inner), dt),
        "out_proj": ((L, d_inner, D), dt),
    }
    return {"embed": ((V, D), dt), "blocks": blocks, "ln_f": ((D,), dt)}


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device`; A in (-16, -1) (``a_log``
    = log(linspace(1, 16, H)) on every layer) and ``dt_bias`` = -4.6
    (softplus^-1(0.01)), as the reference sets them."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = layers.init_params(param_shapes(cfg), gen, dev)
    L = cfg.n_layers
    _, H, _, _ = dims(cfg)
    p["blocks"]["a_log"] = torch.log(torch.linspace(
        1.0, 16.0, H, dtype=torch.float32, device=dev))[None].repeat(L, 1)
    p["blocks"]["dt_bias"] = torch.full((L, H), -4.6, dtype=torch.float32,
                                        device=dev)
    return p


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x [B,S,C]; w [W,C]; state [B,W-1,C] or None.

    Returns (y [B,S,C], new_state [B,W-1,C])."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :]
            for i in range(W))
    y = F.silu(y + b[None, None, :])
    return y.to(x.dtype), xp[:, -(W - 1):, :]


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Chunked SSD. x [b,s,h,p]; dt [b,s,h] (>0); A [h] (<0); B_,C_ [b,s,n].

    Returns y [b,s,h,p] (x's dtype) and the final state [b,h,p,n] fp32."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    s_orig = s
    pad = (-s) % chunk
    if pad:
        # dt=0 steps contribute nothing to the state; outputs are sliced off
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B_.reshape(b, nc, chunk, n).float()
    Cc = C_.reshape(b, nc, chunk, n).float()

    dA = dtc * A  # [b,nc,l,h], negative
    cum = torch.cumsum(dA, dim=2)  # inclusive within-chunk cumsum

    # intra-chunk (quadratic in chunk length); the exponent is masked
    # before the exp (the reference masks after it: see the docstring)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(
        causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    W = scores[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk-final states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b,nc,j,h]
    Sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_end * dtc, Bc, xc)

    # inter-chunk linear recurrence: H_c = exp(sum dA_c) H_{c-1} + S_c, a
    # loop over the chunks (the reference's lax.scan); unbound once, so
    # that the backward stacks the chunks' gradients once
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b,nc,h]
    Hc = x.new_zeros((b, h, p, n), dtype=torch.float32)
    Hprevs = []
    for cd, S_c in zip(chunk_decay.unbind(1), Sc.unbind(1)):
        Hprevs.append(Hc)
        Hc = Hc * cd[:, :, None, None] + S_c
    Hprevs = torch.stack(Hprevs, dim=1)  # [b,nc,h,p,n] state at chunk starts

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, Hprevs) * torch.exp(
        cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), Hc


def ssd_recurrent_step(state, x, dt, A, B_, C_):
    """One-token SSD update. state [B,h,p,n]; x [B,h,p]; dt [B,h];
    B_,C_ [B,n]."""
    dt = dt.float()
    dA = torch.exp(dt * A)  # [B,h]
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, B_.float(), x.float())
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_.float(), state)
    return state, y.to(x.dtype)


def _ssd_local(x, dt, A, B_, C_, chunk: int):
    """`ssd_chunked` over DTensors (x [b,s,h,p], dt [b,s,h], A [h], B_, C_
    [b,s,n]): each process runs it on its own rows over the data axes and
    its own heads over ``"model"`` (where they divide), the sequence
    whole, as `layers._attend_local` attends; no collective inside, the
    one-device arithmetic. Returns (y, state) as DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    b, s, h, p = x.shape
    dp = math.prod(mesh.size(i) for i, a in enumerate(names) if a != "model")
    m = math.prod(mesh.size(i) for i, a in enumerate(names) if a == "model")
    b_ok, h_ok = b % dp == 0, h % m == 0

    def placed(heads):
        """Rows over the data axes, dimension `heads` over "model"."""
        return [Shard(heads) if a == "model" and h_ok and heads is not None
                else Shard(0) if a != "model" and b_ok else Replicate()
                for a in names]

    def local(t, pl, grad=None):
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)

    heads_only = [Shard(0) if a == "model" and h_ok else Replicate()
                  for a in names]
    # B_ and C_ are shared by the heads: where the heads are split, each
    # process's gradient of them is its heads' part of the sum
    shared = [Partial() if a == "model" and h_ok else pl
              for a, pl in zip(names, placed(None))]
    y, state = ssd_chunked(local(x, placed(2)), local(dt, placed(2)),
                           local(A, heads_only),
                           local(B_, placed(None), shared),
                           local(C_, placed(None), shared), chunk)
    return (layers._from_local(y, mesh, placed(2), x.shape),
            layers._from_local(state, mesh, placed(1),
                               (b, h, p, B_.shape[-1])))


def _proj(lp, h):
    return (h @ lp["wz"], h @ lp["wxi"], h @ lp["wb"], h @ lp["wc"],
            h @ lp["wdt"])


def _mixer(cfg: ArchConfig, x, lp, conv_state=None, ssm_state=None):
    """One block over x [B,S,D]: (x + the block's output, the SSD's final
    state [B,H,P,N] fp32, the conv's state [B,W-1,conv_dim]). With
    `ssm_state` (decode, S = 1) the SSD is the recurrent step from it."""
    B, S, D = x.shape
    d_inner, H, N, conv_dim = dims(cfg)
    h = layers.rms_norm(x, lp["ln"])
    z, xs, B_, C_, dtp = _proj(lp, h)
    conv_in = torch.cat([xs, B_, C_], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, lp["conv_w"], lp["conv_b"],
                                        state=conv_state)
    xs, B_, C_ = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = softplus(dtp.float() + lp["dt_bias"])
    A = -torch.exp(lp["a_log"])
    if ssm_state is None:
        xh = layers.split_heads(xs, H, cfg.ssm_head_dim)
        ssd = _ssd_local if is_dtensor(xh) else ssd_chunked
        y, ssm_state = ssd(xh, dt, A, B_, C_, cfg.ssm_chunk)
        y = y + lp["d_skip"][None, None, :, None].to(y.dtype) * xh
    else:
        xh = xs[:, 0].reshape(B, H, cfg.ssm_head_dim)
        ssm_state, y = ssd_recurrent_step(ssm_state, xh, dt[:, 0], A,
                                          B_[:, 0], C_[:, 0])
        y = y + lp["d_skip"][None, :, None].to(y.dtype) * xh
    y = layers.merge_heads(y).reshape(B, S, d_inner)
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype), lp["ln_y"])
    return x + (y @ lp["out_proj"]).to(x.dtype), ssm_state, conv_state


def _block_train(cfg: ArchConfig, x, lp):
    return _mixer(cfg, x, layers.at_use(lp))[0]


def _per_layer(blocks):
    """The stacked block weights unbound once: one dict per layer."""
    names = list(blocks)
    return [dict(zip(names, ws))
            for ws in zip(*(torch.unbind(blocks[k]) for k in names))]


def _embed(cfg: ArchConfig, params, tokens):
    return layers.embed(params["embed"], tokens).to(
        layers.torch_dtype(cfg.dtype))


def forward(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> final hidden [B, S, D]."""
    x = _embed(cfg, params, tokens)
    blk = functools.partial(_block_train, cfg)
    for lp in _per_layer(params["blocks"]):
        x = layers.activation_constraint(x, seq_over_model=cfg.seq_shard)
        if cfg.remat:
            x = checkpoint(blk, x, lp, use_reentrant=False)
        else:
            x = blk(x, lp)
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
    """{name: (shape, dtype)} of the recurrent state (nothing allocated)."""
    d_inner, H, N, conv_dim = dims(cfg)
    L, W = cfg.n_layers, cfg.conv_width
    return {
        "ssm_state": ((L, batch, H, cfg.ssm_head_dim, N), torch.float32),
        "conv_state": ((L, batch, W - 1, conv_dim),
                       layers.torch_dtype(cfg.dtype)),
        "seq_lens": ((batch,), torch.int32),
    }


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda"):
    """Zero states on `device` (the card unless the caller asks for the
    CPU)."""
    dev = _device.resolve(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_seq).items()}


def prefill(cfg: ArchConfig, params, batch, cache):
    """Forward that also writes every layer's final SSM and conv states
    into the cache (in place). Returns (cache, logits_last [B, V])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    for l, lp in enumerate(_per_layer(params["blocks"])):
        x, ssm_state, conv_state = _mixer(cfg, x, lp)
        cache["ssm_state"][l] = ssm_state
        cache["conv_state"][l] = conv_state
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return dict(cache, seq_lens=seq_lens), logits


def decode(cfg: ArchConfig, params, cache, batch):
    """One decode step: tokens [B, 1] -> (cache, logits [B, V]); updates
    the states in place."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens[:, 0])[:, None, :]
    for l, lp in enumerate(_per_layer(params["blocks"])):
        x, ssm_state, conv_state = _mixer(
            cfg, x, lp, conv_state=cache["conv_state"][l],
            ssm_state=cache["ssm_state"][l])
        cache["ssm_state"][l] = ssm_state
        cache["conv_state"][l] = conv_state
    x = layers.rms_norm(x, params["ln_f"])
    logits = logits_fn(cfg, params, x[:, 0])
    return dict(cache, seq_lens=cache["seq_lens"] + 1), logits

