"""The steps a trainer and a server run: train_step (gradient accumulation
+ AdamW), prefill_step, decode_step, and the optimizer state's specs.

The port of `repro.launch.steps`. The train step is functional, as the
reference's: (params, opt_state, batch) in, new ones out; gradients come
from `torch.autograd.grad` (nothing is left in ``.grad``). With
``n_micro`` > 1 each microbatch's gradients are added into fp32 buffers
and divided by ``n_micro``, as the reference accumulates; ``.backward()``
would accumulate in the parameters' dtype (bf16 at full width). The
reference's ``grad_pspec`` (the accumulator's sharding) waits for the
training half of the mesh-only pieces (ROADMAP A7b).
"""
from __future__ import annotations

import torch

from ..models import registry
from ..models.config import ArchConfig
from ..optim import adamw
from ..optim.adamw import AdamWConfig, AdamWState, tree_leaves, tree_map


def make_grad_fn(cfg: ArchConfig):
    """(params, batch) -> ((loss, metrics), grads): the counterpart of
    ``jax.value_and_grad(registry.loss_fn(cfg), has_aux=True)``; loss and
    metrics are detached, grads a tree like params in their dtypes."""
    lf = registry.loss_fn(cfg)

    def grad_fn(params, batch):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(), params)
            l, metrics = lf(ps, batch)
            flat = torch.autograd.grad(l, tree_leaves(ps))
        by_id = {id(p): g for p, g in zip(tree_leaves(ps), flat)}
        grads = tree_map(lambda p: by_id[id(p)], ps)
        return (l.detach(), tree_map(torch.Tensor.detach, metrics)), grads

    return grad_fn


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over `n_micro` microbatches: the leading
    global-batch dim must be divisible by n_micro."""
    grad_fn = make_grad_fn(cfg)

    def train_step(params, opt_state: AdamWState, batch):
        if n_micro == 1:
            (l, metrics), grads = grad_fn(params, batch)
        else:
            mb = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
                  for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(n_micro):
                (l, _), g = grad_fn(params, {k: x[i] for k, x in mb.items()})
                tree_map(lambda a, b: a.add_(b), grads, g)
                del g
                losses.append(l)
            tree_map(lambda g: g.div_(n_micro), grads)
            l = sum(losses) / n_micro
            metrics = {"loss": l}
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    mod = registry.get_module(cfg)

    def prefill_step(params, batch, cache):
        return mod.prefill(cfg, params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    mod = registry.get_module(cfg)

    def decode_step(params, cache, batch):
        return mod.decode(cfg, params, cache, batch)

    return decode_step


def opt_state_specs(cfg: ArchConfig, opt_cfg: AdamWConfig) -> AdamWState:
    """The optimizer state as meta tensors (dry run, no allocation)."""
    mdt = getattr(torch, opt_cfg.moment_dtype)
    mom = tree_map(lambda s: torch.empty(s.shape, dtype=mdt, device="meta"),
                   registry.param_specs(cfg))
    return AdamWState(count=torch.empty((), dtype=torch.int32,
                                        device="meta"), m=mom, v=mom)
