#!/usr/bin/env python3
"""Show that chip_smoke's full-width flash-attention checks fail a wrong
kernel: build deliberately broken copies of ``csrc/flash_attention.cu``
and read each through the checks of chip_smoke phase 10.

    python3 tools/flash_mutants.py --work DIR [--seed N] [--out F]

Needs one NVIDIA GPU and nvcc. The broken copies and their libraries are
written under DIR (give a directory outside the checkout); the checkout's
sources are only read. For the sound kernel and each mutant, at each
full-width shape of phase 10 (granite-3-8b prefill and 8192 tokens) and
in bf16 and fp32, it prints the max |diff| against the plain version and
the share of its limit that the worst element uses (above 1 fails), and
exits non-zero unless the sound kernel passes every check and every
mutant fails at least one.

Mutants:
  drop_mid_tile     skip the KV tile in the middle of each CTA's key range;
  p_bf16            round p to bf16 before the p.v product;
  late_rows_skip    the last query tile skips its first KV tile.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (text of the sound source, its replacement)
MUTANTS = {
    "drop_mid_tile": (
        "    __syncthreads();  // the previous tile's readers are done\n",
        "    if (kv0 > 0 && kv0 == (kv_hi / 2 / kKeys) * kKeys) continue;\n"
        "    __syncthreads();  // the previous tile's readers are done\n"),
    "p_bf16": (
        "      p_w[r * kKeys + lane] = p0;\n"
        "      p_w[r * kKeys + lane + 32] = p1;\n",
        "      p_w[r * kKeys + lane] = __bfloat162float(__float2bfloat16(p0));\n"
        "      p_w[r * kKeys + lane + 32] =\n"
        "          __bfloat162float(__float2bfloat16(p1));\n"),
    "late_rows_skip": (
        "for (int kv0 = (kv_lo / kKeys) * kKeys;",
        "for (int kv0 = (kv_lo / kKeys) * kKeys + (iq == nq - 1 ? kKeys : 0);"),
}


def mutate(text: str, name: str) -> str:
    old, new = MUTANTS[name]
    if text.count(old) != 1:
        raise RuntimeError(f"mutant {name}: its anchor is not in the source "
                           f"exactly once")
    return text.replace(old, new)


def readings(seed, device):
    """{(label, dtype): (max |diff|, share of the limit)} of the kernel now
    bound to `flash_attention`, on phase 10's full-width shapes."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for _, label, case in cs.FA_FULL:
        kw = dict(causal=case[6], window=case[7])
        q, k, v = cs.flash_inputs(g, *case[:6], torch.bfloat16, device)
        for dt in (torch.bfloat16, torch.float32):
            x = [t.to(dt) for t in (q, k, v)]
            got = ops.flash_attention_op(*x, **kw)
            want = fa.flash_attention_plain(*x, **kw)
            out[f"{label} {str(dt).split('.')[1]}"] = cs.flash_reading(got,
                                                                       want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True, type=Path,
                    help="directory for the broken sources and libraries")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write results as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_mutants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build

    sound = (_build.CSRC / "flash_attention.cu").read_text()
    args.work.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name in MUTANTS:
        srcs[name] = args.work / f"flash_attention_{name}.cu"
        srcs[name].write_text(mutate(sound, name))
    with ThreadPoolExecutor(max_workers=len(srcs) + 1) as ex:
        futs = [ex.submit(_build.build, "flash_attention")]
        futs += [ex.submit(_build.compile_source, src,
                           src.with_suffix(".so")) for src in srcs.values()]
        for f in futs:
            f.result()

    device = torch.device("cuda", 0)
    results = {"sound": readings(args.seed, device)}
    sound_lib = _build.load("flash_attention")
    try:
        for name, src in srcs.items():
            _build._LOADED["flash_attention"] = _build.bind(
                src.with_suffix(".so"), "flash_attention")
            results[name] = readings(args.seed, device)
    finally:
        _build._LOADED["flash_attention"] = sound_lib

    ok = True
    for name, res in results.items():
        failed = [k for k, (_, share) in res.items() if not share <= 1.0]
        print(f"{name}: " + "; ".join(
            f"{k} max |diff| {d:.4g}, {share:.4g} of the limit"
            for k, (d, share) in res.items())
            + f" -> fails {len(failed)} of {len(res)} checks")
        ok &= (not failed) if name == "sound" else bool(failed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print("the checks pass the sound kernel and fail every mutant" if ok else
          "FAILED: a mutant passed every check, or the sound kernel failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
