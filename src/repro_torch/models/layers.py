"""Shared model layers: norms, RoPE, (flash / GQA / local) attention, MLPs.

The port of `repro.models.layers`, in plain PyTorch with the reference's
numerics: norms and softmax in fp32, attention products in fp32, matmuls in
the config dtype with fp32 accumulation, and the reference's tensor layouts
(``[B, S, H, hd]`` activations, ``[D, H, hd]`` / ``[H, hd, D]`` attention
weights under ``attn_4d``). Parameters are dicts of tensors stacked over
layers (leading L axis). Every function differentiates under autograd: the
masked scores' ``where`` gives them zero gradient, as the reference's
does.

On a mesh the same functions run on DTensors (parameters placed by
`repro_torch.parallel.sharding.named`, a batch by
`repro_torch.data.pipeline.shard_batch`): `on_mesh` is the context a loss
and its backward run in there, `activation_constraint` pins the residual
stream's placement and its gradient's, and `at_use` gathers a layer's
FSDP-sharded weights before its products; each is a no-op on a plain
tensor (the reference's "no ambient mesh").
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import is_dtensor

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions, d: int, theta: float = 10_000.0):
    """(cos, sin) of RoPE for ``positions [..., S]``, each
    ``[..., S, 1, d // 2]`` fp32: shared by every layer of a step."""
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., :, None].float() * freq
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x, cos, sin):
    """Rotate x ``[..., S, H, D]`` by halves with `rope_tables`' output;
    fp32 inside, x's dtype out."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, D]; positions: [..., S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _causal_mask(S, T, device, causal, window, q_offset=0):
    qpos = torch.arange(S, device=device) + q_offset
    kpos = torch.arange(T, device=device)
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _attend_local(attn, q, k, v, **kw):
    """`attn` over DTensors q [B, S, H, D], k, v [B, T, KVH, D]: each
    process attends over its own rows and heads. The batch goes over the
    data axes and the query heads over ``"model"`` where they divide, with
    the KV heads they read: split alike where ``"model"`` divides them
    too, else (fewer KV heads than ``"model"`` positions, granite's 8 on
    16) whole on every process, which then reads the one KV head its
    query heads share. Sequence and head dimension stay whole; the output
    is a DTensor of q's new placements. No collective runs inside; the
    products are the one-device ones."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    data = [a for a in names if a != "model"]
    B, H, KVH = q.shape[0], q.shape[2], k.shape[2]
    b_ok = B % math.prod(mesh.size(names.index(a)) for a in data) == 0
    m = mesh.size(names.index("model")) if "model" in names else 1
    q_ok = H % m == 0 and (KVH % m == 0 or m % KVH == 0)
    kv_split = q_ok and KVH % m == 0

    def placed(heads):
        return [Shard(2) if a == "model" and heads else
                Shard(0) if a != "model" and b_ok else Replicate()
                for a in names]
    placements = placed(q_ok)
    q = q.redistribute(mesh, placements)
    if q_ok and not kv_split:
        # this process's H / m query heads share KV head `j`: each process
        # reads (and gives a gradient to) its own slice of the whole heads
        kv = placed(False)
        grad = [Partial() if a == "model" else p for a, p in zip(names, kv)]
        j = mesh.get_coordinate()[names.index("model")] * (H // m) \
            // (H // KVH)
        k, v = (x.redistribute(mesh, kv).to_local(grad_placements=grad)
                [:, :, j:j + 1] for x in (k, v))
    else:
        k, v = (x.redistribute(mesh, placements).to_local() for x in (k, v))
    o = attn(q.to_local(), k, v, **kw)
    return _from_local(o, mesh, placements, q.shape)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """Materializing GQA attention (for short sequences).

    q: [B, S, H, D]; k, v: [B, T, KVH, D]. Returns [B, S, H, D].
    window > 0 -> local (sliding-window) attention. On DTensors it runs
    on each process's rows and heads (`_attend_local`)."""
    if is_dtensor(q):
        return _attend_local(attention, q, k, v, causal=causal,
                             window=window, q_offset=q_offset)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qh = q.reshape(B, S, KVH, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qh.float(), k.float()) / (D ** 0.5)
    mask = _causal_mask(S, T, q.device, causal, window, q_offset)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p.float(), v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (prefers big blocks)."""
    d = min(n, target)
    while n % d:
        d -= 1
    return d


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 1024, block_kv: int = 1024):
    """Chunked (flash-style) attention in plain PyTorch: O(S * block)
    memory, online softmax over KV blocks. Same signature and semantics as
    `attention`; for sequences where the S x T scores must not
    materialize."""
    if is_dtensor(q):
        return _attend_local(flash_attention, q, k, v, causal=causal,
                             window=window, block_q=block_q,
                             block_kv=block_kv)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    block_q = _pick_block(S, block_q)
    block_kv = _pick_block(T, block_kv)
    qh = q.reshape(B, S, KVH, G, D)
    scale = 1.0 / (D ** 0.5)
    out = []
    for q0 in range(0, S, block_q):
        qi = qh[:, q0:q0 + block_q]
        m = torch.full((B, KVH, G, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, KVH, G, block_q), device=q.device)
        acc = torch.zeros((B, KVH, G, block_q, D), device=q.device)
        for k0 in range(0, T, block_kv):
            ki, vi = k[:, k0:k0 + block_kv], v[:, k0:k0 + block_kv]
            s = torch.einsum("bskgd,btkd->bkgst", qi.float(),
                             ki.float()) * scale
            mask = _causal_mask(block_q, block_kv, q.device, causal, window,
                                q_offset=q0 - k0)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(q.dtype).float(), vi.float())
            m = m_new
        out.append(acc / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(out, dim=3)                          # [B, KVH, G, S, D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def pick_attention(S: int, T: int, min_seq: int = 8193):
    """Materializing attention below `min_seq` tokens, chunked flash
    above."""
    return attention if max(S, T) < min_seq else flash_attention


def _whole_heads(y, dim: int, H: int):
    """`y` with its dimension `dim` (H heads of equal width, flattened)
    gathered over the mesh axes that split it where their product does not
    divide H (8 KV heads over a 16-wide ``"model"`` axis): a view back to
    ``[.., H, hd]`` never cuts a head. `y` itself otherwise."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    mesh, dim = y.device_mesh, dim % y.ndim
    on = [i for i, p in enumerate(y.placements)
          if isinstance(p, Shard) and p.dim % y.ndim == dim]
    if H % math.prod(mesh.size(i) for i in on) == 0:
        return y
    return y.redistribute(mesh, [Replicate() if i in on else p
                                 for i, p in enumerate(y.placements)])


class _HeadsGrad(torch.autograd.Function):
    """The identity, whose backward applies `_whole_heads` to the
    gradient: a flattened tensor's gradient is viewed back to its
    heads."""

    @staticmethod
    def forward(ctx, x, dim, H):
        ctx.dim, ctx.H = dim, H
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.dim, ctx.H), None, None


def _flat_heads(w, shape, dim: int, H: int):
    """``w.reshape(shape)`` of a tensor whose H heads are flattened into
    its dimension `dim`; on a DTensor mesh whose axes do not divide H, the
    gradient's heads are kept whole (`_HeadsGrad`)."""
    flat = w.reshape(shape)
    if is_dtensor(w):
        names = w.device_mesh.mesh_dim_names or ()
        if any(H % w.device_mesh.size(i) for i in range(len(names))):
            flat = _HeadsGrad.apply(flat, dim, H)
    return flat


def split_heads(y, H: int, hd: int):
    """``y [..., H*hd] -> [..., H, hd]``; on a mesh the heads are kept
    whole (`_whole_heads`)."""
    return _whole_heads(y, -1, H).reshape(*y.shape[:-1], H, hd)


def merge_heads(o):
    """``o [..., H, hd] -> [..., H*hd]``; on a mesh whose axes do not
    divide the H heads, the gradient's heads are kept whole."""
    return _flat_heads(o, (*o.shape[:-2], -1), -1, o.shape[-2])


def _columns_over_model(w):
    """A projection weight ``[D, N]`` that the rules replicate over
    ``"model"`` (8 KV heads on a 16-wide axis), used split over its N
    columns where they divide the axis: each process computes its slice
    of the product, as for the query heads, and `split_heads` gathers the
    heads after. `w` itself otherwise."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(w.device_mesh.mesh_dim_names or ())
    if "model" not in names:
        return w
    i = names.index("model")
    if not isinstance(w.placements[i], Replicate) or \
            w.shape[-1] % w.device_mesh.size(i):
        return w
    placements = list(w.placements)
    placements[i] = Shard(w.ndim - 1)
    return w.redistribute(w.device_mesh, placements)


def qk_proj(h, w, H: int, hd: int):
    """Attention projection for both weight layouts: w 2-D ``[D, H*hd]``
    (flat) or 3-D ``[D, H, hd]`` (``attn_4d``). The 3-D product runs as one
    matmul over a view of w, accumulating in fp32. On a mesh a weight
    replicated over ``"model"`` is used split over its columns
    (`_columns_over_model`)."""
    if w.dim() == 3:
        w = _flat_heads(w, (w.shape[0], -1), 1, H)
    return split_heads(h @ _columns_over_model(w), H, hd)


def out_proj(o, w):
    """o [..., H, hd] x wo (``[H*hd, D]`` flat | ``[H, hd, D]``
    ``attn_4d``) -> [..., D]."""
    flat = merge_heads(o)
    if w.dim() == 2:
        return flat @ w
    return flat @ _flat_heads(w, (-1, w.shape[-1]), 0, w.shape[0])


def mlp(x, w1, w2, w3, kind: str):
    """w1: [D, F] (gate / in), w2: [F, D] (out), w3: [D, F] (up; swiglu /
    geglu only). GELU is the tanh approximation, as ``jax.nn.gelu``'s
    default."""
    dt = x.dtype
    if kind == "swiglu":
        h = F.silu(x @ w1) * (x @ w3)
    elif kind == "geglu":
        h = F.gelu(x @ w1, approximate="tanh") * (x @ w3)
    elif kind == "squared_relu":
        h = torch.square(F.relu(x @ w1))
    elif kind == "gelu":
        h = F.gelu(x @ w1, approximate="tanh")
    else:
        raise ValueError(kind)
    return (h.to(dt) @ w2).to(dt)


def mlp_n_mats(kind: str) -> int:
    return 3 if kind in ("swiglu", "geglu") else 2


def mask_padded_logits(logits, vocab: int):
    """Vocab is padded (Megatron-style); mask the pad columns."""
    vp = logits.shape[-1]
    if vp == vocab:
        return logits
    col = torch.arange(vp, device=logits.device) < vocab
    return torch.where(col, logits, NEG_INF)


def cross_entropy(logits, labels, ignore: int = -100):
    """Mean token cross-entropy in fp32; `ignore` labels are masked (the
    mean is over the valid labels, at least one)."""
    logits = logits.float()
    valid = labels != ignore
    lbl = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # a gather along a vocab-sharded dimension leaves a partial sum
        # DTensor cannot reduce: pick the gold logit by a mask (one
        # non-zero term a row, so the same value). The DTensor is the left
        # operand: Python hands a subclass on the right the op first, and a
        # fake `col` (the dry-run's) is no subclass, so on the right the
        # operands would reach DTensor swapped and its placements differ
        col = torch.arange(logits.shape[-1], device=lbl.device)
        gold = torch.where(lbl[..., None] == col, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def on_mesh(params, batch=None):
    """The context a loss over `params` (and its backward) runs in: a
    no-op for plain tensors. Where the parameters are DTensors, the batch
    must be too (`shard_batch`; a plain batch would run whole on every
    process), and the tensors the model makes itself from positions and
    shapes (RoPE tables, masks, column ids: the same on every process)
    are taken as replicated."""
    if not any(is_dtensor(p) for p in _leaves(params)):
        return contextlib.nullcontext()
    plain = [k for k, v in (batch or {}).items()
             if isinstance(v, torch.Tensor) and not is_dtensor(v)]
    if plain:
        raise ValueError(f"parameters on a mesh and batch leaves {plain} "
                         f"on one device: place the batch with shard_batch")
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def embed(table, tokens):
    """``table[tokens]``: the embedding rows of `tokens`. On DTensors each
    process looks up its own tokens in the whole table (gathered), and
    the table's gradient is the sum over the processes whose tokens
    differ (a partial sum over the axes the tokens are split on)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in tokens.placements]
    rows = whole.to_local(grad_placements=grad)[tokens.to_local()]
    return _from_local(rows, mesh, tokens.placements,
                       (*tokens.shape, table.shape[-1]))


def _from_local(x, mesh, placements, shape):
    """A DTensor of global `shape` (contiguous) from this process's
    shard `x`: shards may be uneven."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def activation_constraint(x, seq_over_model: bool = False):
    """Pin the residual stream's placement between layers: the batch over
    the data axes (where it divides), with `seq_over_model` the sequence
    over ``"model"`` (where it divides), the rest replicated. A no-op on
    a plain tensor and on a mesh without a ``"model"`` axis."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return x
    from torch.distributed.tensor import Replicate, Shard
    batch = [a for a in names if a != "model"]
    if x.shape[0] % math.prod(mesh.size(names.index(a)) for a in batch):
        batch = []
    seq = seq_over_model and x.shape[1] % mesh.size(
        names.index("model")) == 0
    placements = tuple(Shard(0) if a in batch else
                       Shard(1) if a == "model" and seq else Replicate()
                       for a in names)
    return _Pin.apply(x, placements)


class _Pin(torch.autograd.Function):
    """A DTensor redistributed to `placements`, and its gradient too (a
    partial sum is reduced there): the backward keeps the forward's
    placements, as Megatron's all-reduce pairs do, where DTensor would
    otherwise pick each gradient's placement by cost and repeat products
    on gathered operands."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def at_use(tree):
    """A layer's weights (a dict of tensors, or one tensor) as its
    products use them: on a mesh each DTensor is gathered over the axes
    other than ``"model"`` (FSDP's shard over ``"data"``), as GSPMD
    gathers a weight before its product, so every product runs on the
    process's own rows with whole contractions; the gradient goes back
    reduce-scattered onto the shard. Plain tensors, and DTensors split
    over ``"model"`` only, are returned as they are."""
    if isinstance(tree, dict):
        return {k: at_use(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    mesh = tree.device_mesh
    names = mesh.mesh_dim_names or ()
    want = [p if name == "model" else Replicate()
            for name, p in zip(names, tree.placements)]
    if want == list(tree.placements):
        return tree
    return tree.redistribute(mesh, want)


def seq_shard_constraint(x):
    """`activation_constraint` with the sequence over ``"model"``."""
    return activation_constraint(x, seq_over_model=True)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def init_dense(shape, dtype, generator, device, scale: Optional[float] = None):
    """Normal(0, std) made on `device` in `dtype` (never a host copy of a
    full-width weight); std is `scale`, else fan-in^-1/2 with the
    reference's fan-in (``shape[-2]``, or ``shape[-1]`` for vectors)."""
    dtype = torch_dtype(dtype)
    if any(s == 0 for s in shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=generator)


def init_params(shapes, generator, device):
    """Materialize a ``{name: (shape, dtype)}`` tree (nested dicts) on
    `device`: norms ('ln*' / 'scale*' / 'norm*') -> zeros, embeddings
    ('embed*') -> N(0, 0.02), else fan-in normal; draws in the tree's
    order from `generator` (which lives on `device`)."""
    out = {}
    for name, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[name] = init_params(leaf, generator, device)
            continue
        shape, dt = leaf
        if name.startswith(("ln", "scale", "norm")):
            out[name] = torch.zeros(shape, dtype=torch_dtype(dt),
                                    device=device)
        elif name.startswith("embed"):
            out[name] = init_dense(shape, dt, generator, device, scale=0.02)
        else:
            out[name] = init_dense(shape, dt, generator, device)
    return out
