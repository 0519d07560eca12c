"""The steps a trainer and a server run: train_step (gradient accumulation
+ AdamW), prefill_step, decode_step, and the optimizer state's specs.

The port of `repro.launch.steps`. The train step is functional, as the
reference's: (params, opt_state, batch) in, new ones out; gradients come
from `torch.autograd.grad` (nothing is left in ``.grad``). With
``n_micro`` > 1 each microbatch's gradients are added into fp32 buffers
and divided by ``n_micro``, as the reference accumulates; ``.backward()``
would accumulate in the parameters' dtype (bf16 at full width).

On a mesh the parameters and optimizer state are DTensors
(`repro_torch.parallel.sharding.place_state`) and the batch is
`shard_batch`'s: the same step runs SPMD on every process, DTensor placing
the collectives. A microbatch is the reference's rows of the global batch,
re-split over the data axes. ``grad_pspec`` (a tree of placement tuples
like the parameters', e.g. `param_specs`) pins the fp32 accumulator: it is
created with those placements and every microbatch's gradient is
redistributed to them before it is added, so the sum keeps them (the
reference's ``with_sharding_constraint`` after each add).
"""
from __future__ import annotations

import torch

from ..models import layers, registry
from ..models.config import ArchConfig
from ..optim import adamw
from ..optim.adamw import AdamWConfig, AdamWState, tree_leaves, tree_map
from ..parallel.sharding import is_dtensor


def make_grad_fn(cfg: ArchConfig):
    """(params, batch) -> ((loss, metrics), grads): the counterpart of
    ``jax.value_and_grad(registry.loss_fn(cfg), has_aux=True)``; loss and
    metrics are detached, grads a tree like params in their dtypes."""
    lf = registry.loss_fn(cfg)

    def grad_fn(params, batch):
        with torch.enable_grad(), layers.on_mesh(params, batch):
            ps = tree_map(lambda p: p.detach().requires_grad_(), params)
            l, metrics = lf(ps, batch)
            flat = torch.autograd.grad(l, tree_leaves(ps))
        by_id = {id(p): g for p, g in zip(tree_leaves(ps), flat)}
        grads = tree_map(lambda p: by_id[id(p)], ps)
        return (l.detach(), tree_map(torch.Tensor.detach, metrics)), grads

    return grad_fn


def _mesh_of(params):
    """The live mesh the parameters are DTensors on, else None."""
    for p in tree_leaves(params):
        if is_dtensor(p):
            return p.device_mesh
    return None


def _microbatches(batch, n_micro: int) -> list:
    """The reference's microbatches: microbatch i is rows [i * B / n,
    (i + 1) * B / n) of the global batch. On a mesh each is re-split over
    the data axes as the batch is, or replicated where its rows do not
    divide over them (`batch_specs`' rule); the batch, which is small, is
    all-gathered once a step."""
    mb = {}
    for k, x in batch.items():
        if is_dtensor(x):
            from torch.distributed.tensor import Replicate
            from ..parallel.sharding import NamedPlacement
            mesh, rows = x.device_mesh, x.shape[0] // n_micro
            dp = 1
            for i, p in enumerate(x.placements):
                if not isinstance(p, Replicate):
                    dp *= mesh.size(i)
            placements = tuple(x.placements) if rows % dp == 0 else \
                (Replicate(),) * mesh.ndim
            placed = NamedPlacement(mesh, placements)
            whole = x.full_tensor()
            mb[k] = [placed.place(r) for r in whole.reshape(
                n_micro, rows, *whole.shape[1:])]
        else:
            mb[k] = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    return [{k: x[i] for k, x in mb.items()} for i in range(n_micro)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    grad_pspec=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over `n_micro` microbatches: the leading
    global-batch dim must be divisible by n_micro. `grad_pspec` (a tree
    of placement tuples matching params; parameters on a mesh) pins the
    fp32 accumulator's placements."""
    grad_fn = make_grad_fn(cfg)

    def train_step(params, opt_state: AdamWState, batch):
        if n_micro == 1:
            (l, metrics), grads = grad_fn(params, batch)
        else:
            mesh = _mesh_of(params)
            if grad_pspec is not None and mesh is None:
                raise ValueError("grad_pspec places the accumulator on a "
                                 "mesh: the parameters are not DTensors")
            if grad_pspec is None:
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)
                    if not is_dtensor(p) else
                    torch.zeros_like(p, dtype=torch.float32), params)
            else:
                from torch.distributed.tensor import zeros as dzeros
                from ..parallel.sharding import named
                grads = tree_map(lambda p, n: dzeros(
                    p.shape, dtype=torch.float32, device_mesh=n.mesh,
                    placements=n.placements), params,
                    named(mesh, grad_pspec))

            def add(a, b):
                if is_dtensor(a):
                    # the pin: a microbatch's gradient joins the
                    # accumulator on its placements (a partial sum is
                    # reduced there)
                    b = b.float().redistribute(a.device_mesh, a.placements)
                return a.add_(b)

            losses = []
            for micro in _microbatches(batch, n_micro):
                (l, _), g = grad_fn(params, micro)
                tree_map(add, grads, g)
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
