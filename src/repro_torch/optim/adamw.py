"""AdamW with global-norm clipping, a configurable moment dtype and a
warmup + cosine schedule.

The port of `repro.optim.adamw`: functional, (params, grads, state) in,
new params and state out, over parameter trees of nested dicts. The
reference's numerics are kept: `schedule`, the clipping scale and the bias
corrections ``1 - b ** count`` are fp32 tensors (Python doubles would
differ in the last bits), and each leaf's update runs in fp32 and is cast
back to its parameter's dtype and the moments' dtype. Weight decay applies
to every leaf with two or more axes: the layer-stacked norms ``ln1`` /
``ln2`` ``[L, D]`` are decayed and ``ln_f`` ``[D]`` is not, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    count: torch.Tensor   # int32 []
    m: object             # a tree like params
    v: object


def tree_map(fn, *trees):
    """`fn` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_frac * lr; an fp32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(cfg: AdamWConfig, params) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def _like_param(g, p):
    """A DTensor gradient on its parameter's placements (a partial sum is
    reduced there); a plain tensor as it is."""
    from ..parallel.sharding import is_dtensor
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics)."""
    grads = tree_map(_like_param, grads, params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        # the reference's expression, a rounding at a time; the in-place
        # steps reuse temporaries (a full-width leaf is ~1.7 GB in fp32)
        g = g.float() * scale
        m32 = m.float() * cfg.b1
        m32 += (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2
        v32 += g.square_().mul_(1 - cfg.b2)
        step = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:
            step += cfg.weight_decay * p.float()
        newp = p.float() - step.mul_(lr)
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], out)
                           for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(count=count, m=new_m, v=new_v), metrics
