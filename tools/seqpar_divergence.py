#!/usr/bin/env python3
"""How far two sound decodes of granite-3-8b at full width drift apart.

    python3 tools/seqpar_divergence.py [--seed N] [--steps S] [--out F]

On the card, 8 x 512 prompt tokens from ``--seed``: the dense decode at
full width through the paged-attention kernel (greedy), then through its
plain version and through `write_attend_seqpar` on a (data=1, model=2)
mesh of 2 processes (gloo on one card), each fed the kernel's tokens.
For bf16 with the config's attn_4d weights and with flat ones (attn_4d
off), and for fp32 at 2, 8 and 40 layers with attn_4d, it prints per
decode step max |logits - the kernel's| / max |logit| on the real
vocabulary and how many greedy tokens agree with the kernel's. The three
attention routes compute the same function; where 40 layers of the
attn_4d init (a one-hot softmax) amplify their rounding, no two agree.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_3_8b"
BATCH, PROMPT = 8, 512
CASES = (("bf16 attn_4d", dict()), ("bf16 flat", dict(attn_4d=False)),
         ("fp32 2 layers", dict(dtype="float32", n_layers=2)),
         ("fp32 8 layers", dict(dtype="float32", n_layers=8)),
         ("fp32 40 layers", dict(dtype="float32")))


def steps_logits(cfg, seed, steps, device, mesh=None, feed=None):
    """Every step's logits on the host (fp32, the real vocabulary)."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.models import registry
    params = registry.init(cfg, seed=seed, device=device)
    prompts = registry.make_prompts(cfg, BATCH, PROMPT, seed=seed,
                                    device=device)
    return [x[:, :cfg.vocab].float().cpu() for x in chip_smoke.seqpar_steps(
        cfg, params, prompts, steps, device, mesh, feed=feed)]


def mesh_worker(seed, steps, feeds):
    """On each process of the (1, 2) mesh: every case fed the kernel's
    tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_mod.make_host_mesh(model=2, live=True)
    base = configs.get(ARCH)
    return {name: steps_logits(dataclasses.replace(base, **kw), seed, steps,
                               device, mesh, feeds[name])
            for name, kw in CASES}


def reading(got, want):
    """(max |got - want| / max |want|, greedy tokens equal) of a step."""
    err = float((got - want).abs().max() / want.abs().max())
    return err, int((got.argmax(-1) == want.argmax(-1)).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("seqpar_divergence: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    _build.load("paged_attention")
    device = torch.device("cuda", 0)
    base = configs.get(ARCH)
    kernel, plain, feeds = {}, {}, {}
    for name, kw in CASES:
        cfg = dataclasses.replace(base, **kw)
        kernel[name] = steps_logits(
            dataclasses.replace(cfg, attend_impl="kernel"), args.seed,
            args.steps, device)
        feeds[name] = torch.stack([x.argmax(-1) for x in kernel[name]],
                                  1)[:, :args.steps]
        plain[name] = steps_logits(
            dataclasses.replace(cfg, attend_impl="ref"), args.seed,
            args.steps, device, feed=feeds[name])
    torch.cuda.empty_cache()
    mesh = mesh_mod.spawn(mesh_worker, 2, args.seed, args.steps, feeds,
                          backend="gloo", timeout=1200)[0]
    out = {}
    for name, _ in CASES:
        rows = [dict(step=k, plain=reading(p, w), mesh=reading(m, w))
                for k, (w, p, m) in enumerate(zip(kernel[name], plain[name],
                                                  mesh[name]))]
        out[name] = rows
        print(f"{name}: step (plain vs kernel: rel. err, tokens equal of "
              f"{BATCH}; mesh vs kernel: the same) " + "; ".join(
                  f"{r['step']} ({r['plain'][0]:.3g}, {r['plain'][1]}; "
                  f"{r['mesh'][0]:.3g}, {r['mesh'][1]})" for r in rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
