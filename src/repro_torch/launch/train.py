"""End-to-end fault-tolerant trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
        --reduced --device cpu --steps 50 --batch 8 --seq 128 \\
        [--ckpt-dir DIR] [--fail-at 20]

The port of `repro.launch.train`: the synthetic token stream, AdamW with
its schedule, gradient accumulation over ``--n-micro`` microbatches, async
checkpointing, the step watchdog and checkpoint / restart recovery (a
drill with ``--fail-at``). It takes the reference's flags and prints its
lines, plus ``--device`` (the card by default; without a GPU it raises
unless ``--device cpu`` is given) and ``--dtype`` (the parameters' dtype,
the config's by default: ``--reduced --dtype bfloat16`` runs the smoke
config with bf16 weights and checkpoints). `build` also takes a cut depth
(``layers=5`` trains recurrentgemma-9b's first group and its 2-layer tail
at full width). The ssm and hybrid families train as the dense one
does. Parameters are random from seed 0, made on the device.

Under ``torchrun`` (or `launch.mesh.spawn`: ``WORLD_SIZE`` > 1) it trains
on a mesh of processes, as the reference's ``main`` does on its host
mesh: it joins the process group (``--dist-backend``; nccl needs a card
per process, gloo lets them share one), builds the ``(world, 1)``
``("data", "model")`` `DeviceMesh`, places the parameters and the
optimizer state replicated on each process's mesh device and feeds every
step `shard_batch(mesh, batch)`, so each process computes its rows and
DTensor reduces the gradients over ``"data"``. Process 0 alone prints
the lines.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --dist-backend gloo --steps 12
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from .. import configs
from .. import device as _device
from ..checkpoint import ckpt as ckpt_lib
from ..data.pipeline import StreamConfig, TokenStream, shard_batch, to_device
from ..models import registry
from ..optim import adamw
from ..optim.adamw import AdamWConfig
from ..parallel import sharding
from ..runtime import fault
from . import mesh as _mesh
from .steps import make_train_step


def build(arch: str, reduced: bool, batch: int, seq: int, n_micro: int,
          total_steps: int, device="cuda", dtype=None, layers=None):
    """(cfg, params, opt_state, step_fn, stream) of a training run on
    `device`; `dtype` overrides the config's parameter dtype and `layers`
    its depth (a full-width model whose training state does not fit one
    card)."""
    dev = _device.resolve(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=total_steps,
                          moment_dtype=cfg.opt_moment_dtype)
    params = registry.init(cfg, seed=0, device=dev)
    opt_state = adamw.init(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
    stream = TokenStream(StreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        d_model=cfg.d_model, enc_frames=cfg.enc_frames
        if cfg.family == "audio" else 0,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0))
    return cfg, params, opt_state, step_fn, stream


def main(argv=None):
    """Run the trainer; returns (final state, history)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (recovery drill)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="parameter dtype (default: the config's)")
    ap.add_argument("--dist-backend", default="nccl", choices=_mesh.BACKENDS,
                    help="under torchrun: the process group's backend "
                         "(nccl needs a card per process; gloo lets them "
                         "share one)")
    args = ap.parse_args(argv)

    mesh, joined = None, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        joined = not torch.distributed.is_initialized()
        _mesh.init_world(args.dist_backend)
        mesh = _mesh.make_host_mesh(live=True)
    try:
        return _run(args, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _scalar(x) -> float:
    return float(x.full_tensor() if hasattr(x, "placements") else x)


def _run(args, mesh):
    dev = (_device.resolve(args.device) if mesh is None
           else sharding.mesh_device(mesh))
    say = (mesh is None or torch.distributed.get_rank() == 0)
    out = print if say else (lambda *a, **k: None)
    cfg, params, opt_state, step_fn, stream = build(
        args.arch, args.reduced, args.batch, args.seq, args.n_micro,
        args.steps, device=dev, dtype=args.dtype)
    out(f"arch={cfg.name} params="
        f"{sum(p.numel() for p in adamw.tree_leaves(params)):,}")
    if mesh is not None:
        # the reference's main: parameters (and state) replicated
        params, opt_state = (sharding.place(t, sharding.named(
            mesh, sharding.replicated_specs(t))) for t in (params, opt_state))

    def step(state, batch, step_idx):
        params, opt_state = state
        batch = (to_device(batch, dev) if mesh is None
                 else shard_batch(mesh, batch))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step_idx % 5 == 0:
            out(f"step {step_idx}: loss={_scalar(metrics['loss']):.4f} "
                f"gnorm={_scalar(metrics['grad_norm']):.3f} "
                f"lr={_scalar(metrics['lr']):.2e}", flush=True)
        return (params, opt_state), metrics

    injector = fault.FailureInjector([args.fail_at] if args.fail_at else [])
    watchdog = fault.StepWatchdog()
    loop_cfg = fault.TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir)
    state, history = fault.run_with_recovery(
        loop_cfg, init_state=(params, opt_state), step_fn=step,
        make_batch=stream.batch, injector=injector, watchdog=watchdog)
    out(f"done: {len(history['steps'])} steps, "
        f"{history['recoveries']} recoveries, "
        f"{history['stragglers']} straggler events")
    out(f"latest checkpoint: step {ckpt_lib.latest_step(args.ckpt_dir)}")
    return state, history


if __name__ == "__main__":
    main()
