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
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from .. import configs
from .. import device as _device
from ..checkpoint import ckpt as ckpt_lib
from ..data.pipeline import StreamConfig, TokenStream, to_device
from ..models import registry
from ..optim import adamw
from ..optim.adamw import AdamWConfig
from ..runtime import fault
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
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg, params, opt_state, step_fn, stream = build(
        args.arch, args.reduced, args.batch, args.seq, args.n_micro,
        args.steps, device=dev, dtype=args.dtype)
    print(f"arch={cfg.name} params="
          f"{sum(p.numel() for p in adamw.tree_leaves(params)):,}")

    def step(state, batch, step_idx):
        params, opt_state = state
        batch = to_device(batch, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step_idx % 5 == 0:
            print(f"step {step_idx}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}", flush=True)
        return (params, opt_state), metrics

    injector = fault.FailureInjector([args.fail_at] if args.fail_at else [])
    watchdog = fault.StepWatchdog()
    loop_cfg = fault.TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir)
    state, history = fault.run_with_recovery(
        loop_cfg, init_state=(params, opt_state), step_fn=step,
        make_batch=stream.batch, injector=injector, watchdog=watchdog)
    print(f"done: {len(history['steps'])} steps, "
          f"{history['recoveries']} recoveries, "
          f"{history['stragglers']} straggler events")
    print(f"latest checkpoint: step {ckpt_lib.latest_step(args.ckpt_dir)}")
    return state, history


if __name__ == "__main__":
    main()
