"""Mixture-of-Experts LM family (olmoe 64e/top-8, qwen2-moe 60e/top-4 +
shared).

The port of `repro.models.moe`. Token-choice top-k routing with
capacity-bounded, gather-based dispatch: each group of tokens is scattered
into per-expert slot tables (int indices), the experts run as batched
``[E, C, D] x [E, D, F]`` products, and the results gather back. The
attention half of each layer, the caches and the serving loop are the
dense family's (`transformer`, with `_moe_mlp` as the block's
feed-forward), so decode reaches the paged-attention kernel the same way.

Numerics follow the reference:

  * the router's logits are ``x @ wr`` in the activations' dtype (``wr``
    is fp32 and cast down), then fp32; padded experts (``padded_experts >
    n_experts``) are masked to -1e30 before the softmax;
  * top-k keeps `lax.top_k`'s tie order, the lower expert index first:
    a stable descending sort, then the first K (`torch.topk` orders ties
    otherwise, and a bf16 router over 64 experts ties);
  * the three expert products keep their fp32 results (the reference's
    ``preferred_element_type=float32``): the operands are upcast (bf16
    values are exact in fp32) and multiplied in fp32; ``silu(h1) * h3`` is
    taken in fp32 and cast once;
  * a (token, k) whose expert already holds C tokens of its group is
    dropped and contributes 0.

Groups are independent, so all of them run in one batched pass where the
reference scans ``n_iter`` steps of ``m`` vmapped groups. The output keeps
the reference's order: chunk ``i_m * n_iter + i_iter`` of the (padded)
token stream lands at ``i_iter * m + i_m``, which is the identity unless
both ``m`` and ``n_iter`` exceed 1 (more than ``moe_parallel_groups``
groups: ROADMAP C).

On a mesh (training on DTensors) the routed experts run on local tensors
(`_routed_on_mesh`) with the same groups of the whole token stream, so a
group's capacity is shared by the same tokens as on one device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import device as _device
from . import layers, transformer
from .config import ArchConfig

cache_spec = transformer.cache_spec
init_cache = transformer.init_cache
logits_fn = transformer.logits_fn

MASKED = -1e30  # router logit of a padded (dummy) expert


def capacity(cfg: ArchConfig) -> int:
    c = math.ceil(cfg.moe_group * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8 * math.ceil(c / 8), 8)


def param_shapes(cfg: ArchConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, Fe = cfg.padded_experts, cfg.expert_d_ff  # dummies never routed
    dt = cfg.dtype
    blocks = {
        "ln1": ((L, D), dt),
        "ln2": ((L, D), dt),
        "wq": ((L, D, H, hd) if cfg.attn_4d else (L, D, H * hd), dt),
        "wk": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wv": ((L, D, KVH, hd) if cfg.attn_4d else (L, D, KVH * hd), dt),
        "wo": ((L, H, hd, D) if cfg.attn_4d else (L, H * hd, D), dt),
        "wr": ((L, D, E), "float32"),       # router in fp32
        "we1": ((L, E, D, Fe), dt),
        "we2": ((L, E, Fe, D), dt),
        "we3": ((L, E, D, Fe), dt),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        blocks.update({
            "ws1": ((L, D, Fs), dt),
            "ws2": ((L, Fs, D), dt),
            "ws3": ((L, D, Fs), dt),
        })
    shapes = {"embed": ((V, D), dt), "blocks": blocks, "ln_f": ((D,), dt)}
    if not cfg.tie_embeddings:
        shapes["head"] = ((D, V), dt)
    return shapes


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device` (the card by default)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return layers.init_params(param_shapes(cfg), gen, dev)


def group_shape(cfg: ArchConfig, n_tokens: int) -> tuple[int, int, int, int]:
    """(group size Gs, capacity C, parallel groups m, iterations n_iter)
    of one dispatch over `n_tokens` tokens, as the reference sizes them:
    the group adapts to the token count (a decode step of B tokens is one
    group of ``8 * ceil(B / 8)``), and C truncates before it rounds up."""
    E, K = cfg.padded_experts, cfg.top_k
    Gs = min(cfg.moe_group, max(8 * ((n_tokens + 7) // 8), 8))
    C = max(8 * -(-int(Gs * K * cfg.capacity_factor / E) // 8), 8)
    m = max(min(cfg.moe_parallel_groups, -(-n_tokens // Gs)), 1)
    n_iter = -(-n_tokens // (Gs * m))
    return Gs, C, m, n_iter


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, in
    `lax.top_k`'s order: value descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ArchConfig, xg, wr):
    """Router of the groups xg [G, Gs, D]: (gates fp32 [G, Gs, K],
    expert ids [G, Gs, K]), the ids in `top_k`'s order."""
    E, K = cfg.padded_experts, cfg.top_k
    logits = (xg @ wr.to(xg.dtype)).float()
    if E != cfg.n_experts:  # mask padded (dummy) experts off the router
        real = torch.arange(E, device=xg.device) < cfg.n_experts
        logits = torch.where(real, logits, MASKED)
    gates, idx = top_k(torch.softmax(logits, dim=-1), K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def slots(idx, E: int, C: int):
    """(slot of each (token, k) inside its expert [G, Gs * K], kept
    [G, Gs * K]) for expert ids idx [G, Gs, K]: slots count in
    token-major order, and a (token, k) at slot C or later is dropped."""
    e_flat = idx.reshape(idx.shape[0], -1)
    oh = F.one_hot(e_flat, E)                              # [G, Gs*K, E]
    pos = (oh.cumsum(1) - oh).gather(2, e_flat[..., None])[..., 0]
    return pos, pos < C


def _groups(cfg: ArchConfig, x):
    """The reference's groups of a token stream x [N, D]: [G, Gs, D],
    chunk ``i_m * n_iter + i_iter`` of the (padded) stream at group
    ``i_iter * m + i_m``."""
    N, D = x.shape
    Gs, _, m, n_iter = group_shape(cfg, N)
    pad = n_iter * m * Gs - N
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(m, n_iter, Gs, D).transpose(0, 1).reshape(-1, Gs, D)


def _experts(cfg: ArchConfig, xg, wr, we1, we2, we3, e0: int = 0):
    """The routed experts of the groups xg [G, Gs, D] -> [G, Gs, D]. The
    router sees all E experts; `we1` / `we3` [E_l, D, F_l] and `we2`
    [E_l, F_l, D] are experts ``e0 .. e0 + E_l`` (all of them on one
    device), and a (token, k) routed elsewhere contributes 0 here."""
    G, Gs, D = xg.shape
    E, K = cfg.padded_experts, cfg.top_k
    E_l = we1.shape[0]
    dev = xg.device
    C = max(8 * -(-int(Gs * K * cfg.capacity_factor / E) // 8), 8)
    gates, idx = route(cfg, xg, wr)                        # [G, Gs, K]
    pos, keep = slots(idx, E, C)
    e_flat = idx.reshape(G, Gs * K)
    # slot tables: token id per (group, expert, slot); -1 = empty. Kept
    # (expert, slot) pairs are distinct; the dropped ones all go to a
    # spare slot C, cut off after (no mask indexing: nothing waits on
    # the device)
    tok = torch.arange(Gs, device=dev).repeat_interleave(K).expand(G, -1)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Gs * K)
    slot_tok = torch.full((G, E, C + 1), -1, dtype=torch.long, device=dev)
    slot_tok[gidx, e_flat, torch.where(keep, pos, C)] = tok
    slot_tok = slot_tok[:, e0:e0 + E_l, :C]
    # gather tokens -> [G, E_l, C, D], run the experts in fp32, gather back
    filled = slot_tok >= 0
    x_e = xg[torch.arange(G, device=dev)[:, None, None],
             slot_tok.clamp(min=0)]
    x_e = torch.where(filled[..., None], x_e, 0).float()
    h1 = F.silu(x_e @ we1.float())
    h3 = x_e @ we3.float()
    y_e = ((h1 * h3).to(xg.dtype).float() @ we2.float()).to(xg.dtype)
    # combine: y[g, t] = sum_k gate_k * y_e[g, idx_k, pos_k]
    pos_k = pos.reshape(G, Gs, K).clamp(max=C - 1)
    here = keep.reshape(G, Gs, K)
    if E_l != E:
        here = here & (idx >= e0) & (idx < e0 + E_l)
    picked = y_e[torch.arange(G, device=dev)[:, None, None],
                 (idx - e0).clamp(0, E_l - 1), pos_k]
    w = torch.where(here, gates, 0.0).to(xg.dtype)
    return torch.einsum("ngkd,ngk->ngd", picked, w)


def _moe_mlp(cfg: ArchConfig, h, lp):
    """h [B, S, D] -> [B, S, D] routed through capacity-bounded experts."""
    if layers.is_dtensor(h):
        y = _routed_on_mesh(cfg, h, lp)
    else:
        B, S, D = h.shape
        yg = _experts(cfg, _groups(cfg, h.reshape(B * S, D)), lp["wr"],
                      lp["we1"], lp["we2"], lp["we3"])
        y = yg.reshape(-1, D)[:B * S].reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + layers.mlp(h, lp["ws1"], lp["ws2"], lp["ws3"], "swiglu")
    return y.to(h.dtype)


def _routed_on_mesh(cfg: ArchConfig, h, lp):
    """The routed half of `_moe_mlp` on DTensors (training on a mesh),
    with the reference's groups of the whole token stream: each process
    computes the groups that hold its rows (its rows alone where they are
    whole groups in place, else from the stream gathered over the data
    axes) and, of each, the experts its ``"model"`` shard holds (or its
    slice of every expert's width); the result is its rows, a partial sum
    over ``"model"``. A token's output has no gradient path to another
    token's, so each row's gradient comes back from its own process."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, (B, S, D) = h.device_mesh, h.shape
    names = tuple(mesh.mesh_dim_names or ())
    N = B * S
    Gs, _, m, n_iter = group_shape(cfg, N)
    row = [isinstance(p, Shard) and p.dim == 0 for p in h.placements]
    dp = math.prod(mesh.size(d) for d, r in enumerate(row) if r)
    coord = mesh.get_coordinate()
    rank = 0
    for d, r in enumerate(row):
        if r:
            rank = rank * mesh.size(d) + coord[d]
    n_l = N // dp
    # where the experts' weights split over "model", this process holds
    # a share of each output (partial), else the whole output
    we1 = lp["we1"]
    split = [n == "model" and isinstance(p, Shard)
             for n, p in zip(names, we1.placements)]
    part = [Partial() if r or s else Replicate()
            for r, s in zip(row, split)]

    def local(w):
        return w.to_local(grad_placements=[
            Partial() if r else p for r, p in zip(row, w.placements)])

    x_rows = h.redistribute(mesh, [Shard(0) if r else Replicate()
                                   for r in row])
    if (m == 1 or n_iter == 1) and n_l % Gs == 0:
        # the groups are this process's rows, in order
        xg = x_rows.to_local(grad_placements=[
            Shard(0) if r else p for r, p in zip(row, part)]
        ).reshape(n_l // Gs, Gs, D)
        lo = 0
    else:
        whole = x_rows.redistribute(mesh, [Replicate()] * mesh.ndim)
        g0 = rank * n_l // Gs
        g1 = -(-(rank + 1) * n_l // Gs)
        xg = _groups(cfg, whole.to_local(grad_placements=part).reshape(
            N, D))[g0:g1]
        lo = rank * n_l - g0 * Gs
    e0 = 0
    for i, s in enumerate(split):
        if s and we1.placements[i].dim == 0:     # the experts themselves
            e0 = coord[i] * (cfg.padded_experts // mesh.size(i))
    wr = lp["wr"].redistribute(mesh, [Replicate()] * mesh.ndim)
    yg = _experts(cfg, xg, wr.to_local(grad_placements=part), local(we1),
                  local(lp["we2"]), local(lp["we3"]), e0)
    y = yg.reshape(-1, D)[lo:lo + n_l].reshape(n_l // S, S, D)
    out = [Shard(0) if r else Partial() if s else Replicate()
           for r, s in zip(row, split)]
    return layers._from_local(y, mesh, out, (B, S, D))


def forward(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> final hidden [B, S, D]."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = layers.embed(params["embed"], tokens).to(
        layers.torch_dtype(cfg.dtype))
    return transformer.forward_embeds(cfg, params, x, positions,
                                      ffn=_moe_mlp)


def loss(cfg: ArchConfig, params, batch):
    hidden = forward(cfg, params, batch["tokens"])
    logits = logits_fn(cfg, params, hidden)
    l = layers.cross_entropy(logits, batch["labels"])
    return l, {"loss": l}


# ----------------------------------------------------------------- serving --
def prefill(cfg: ArchConfig, params, batch, cache, mesh=None):
    """The dense prefill with the routed experts; writes the pages in
    place. Returns (cache, logits_last [B, V])."""
    return transformer.prefill(cfg, params, batch, cache, ffn=_moe_mlp,
                               mesh=mesh)


def decode(cfg: ArchConfig, params, cache, batch, mesh=None):
    """One decode step (paged attention, then the routed experts); writes
    the new token's K/V in place. Returns (cache, logits [B, V])."""
    return transformer.decode(cfg, params, cache, batch, ffn=_moe_mlp,
                              mesh=mesh)
