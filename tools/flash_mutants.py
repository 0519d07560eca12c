#!/usr/bin/env python3
"""Show that chip_smoke's full-width attention checks fail a wrong kernel:
build deliberately broken copies of ``csrc/flash_attention.cu`` and
``csrc/paged_attention.cu`` and read each through the checks of chip_smoke
phase 10 (flash) or phase 6 (paged).

    python3 tools/flash_mutants.py --work DIR [--seed N] [--out F]

Needs one NVIDIA GPU and nvcc. The broken copies and their libraries are
written under DIR (give a directory outside the checkout); the checkout's
sources are only read. For the sound kernels and each mutant it prints the
max |diff| against the plain version and the share of its limit that the
worst element uses (above 1 fails): for flash at each full-width shape of
phase 10 (granite-3-8b prefill and 8192 tokens) in bf16 and fp32, for
paged attention over phase 6's sweep and its long case in fp32 and bf16.
It exits non-zero unless the sound kernels pass every check and every
mutant fails one by at least `MARGIN` times its limit.

Mutants of the flash kernel's bf16 (tensor-core) route:
  drop_mid_tile     skip the KV tile in the middle of each CTA's key range;
  p_bf16            drop the p_lo product (p rounded to bf16 before p.v);
  late_rows_skip    the last query tile skips its first KV tile.
Mutants of the paged kernel's merge (`PAGED_MUTANTS`):
  merge_drop_split  the merge drops split 1's partial;
  merge_no_rescale  the merge omits the exp(m_i - M) rescale.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARGIN = 2.0  # a mutant must fail some check by this factor

# name -> (text of the sound source, its replacement): flash_attention.cu
MUTANTS = {
    "drop_mid_tile": (
        "    attend_tile<HD, BN, MT>(",
        "    if (!(kv0 > 0 && kv0 == (kv_hi / 2 / BN) * BN))\n"
        "      attend_tile<HD, BN, MT>("),
    "p_bf16": (
        "  const __nv_bfloat162 r =\n"
        "      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));\n",
        "  const __nv_bfloat162 r = __floats2bfloat162_rn(0.f, 0.f);\n"),
    "late_rows_skip": (
        "  const int kv_begin = (kv_lo / BN) * BN;\n",
        "  const int kv_begin = (kv_lo / BN) * BN + (iq == nq - 1 ? BN : 0);\n"),
}
# the same for paged_attention.cu
PAGED_MUTANTS = {
    "merge_drop_split": (
        "  for (int s = 0; s < splits; ++s) {\n",
        "  for (int s = 0; s < splits; ++s) {\n"
        "    if (s == 1) continue;\n"),
    "merge_no_rescale": (
        "    const float w = expf(pm[(s * G + g) * 2] - M);\n",
        "    const float w = 1.f;\n"),
}
KERNEL = {**dict.fromkeys(MUTANTS, "flash_attention"),
          **dict.fromkeys(PAGED_MUTANTS, "paged_attention")}


def mutate(text: str, name: str) -> str:
    old, new = {**MUTANTS, **PAGED_MUTANTS}[name]
    if text.count(old) != 1:
        raise RuntimeError(f"mutant {name}: its anchor is not in the source "
                           f"exactly once")
    return text.replace(old, new)


def flash_readings(seed, device):
    """{label: (max |diff|, share of the limit)} of the kernel now bound to
    `flash_attention`, on phase 10's full-width shapes."""
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


def paged_readings(seed, device):
    """{label: (max |diff|, share of the limit)} of the kernel now bound to
    `paged_attention`, over phase 6's sweep and its long case."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(seed)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for label, cases in (("sweep", cs.PA_CASES), ("long", (cs.PA_LONG,))):
            worst = (0.0, 0.0)
            for H, KVH, D, page, pages, lens in cases:
                args = cs.paged_case(rng, H, KVH, D, page, pages, lens, dt,
                                     device)
                r = cs.pa_reading(pa.paged_attention(*args),
                                  pa.paged_attention_plain(*args),
                                  cs.PA_TOL[name])
                worst = max(worst, r, key=lambda x: x[1] if x[1] == x[1]
                            else math.inf)
            out[f"{label} {name}"] = worst
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

    args.work.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name, kernel in KERNEL.items():
        sound = (_build.CSRC / f"{kernel}.cu").read_text()
        srcs[name] = args.work / f"{kernel}_{name}.cu"
        srcs[name].write_text(mutate(sound, name))
    with ThreadPoolExecutor(max_workers=len(srcs) + 2) as ex:
        futs = [ex.submit(_build.build, k) for k in set(KERNEL.values())]
        futs += [ex.submit(_build.compile_source, src,
                           src.with_suffix(".so")) for src in srcs.values()]
        for f in futs:
            f.result()

    device = torch.device("cuda", 0)
    read = {"flash_attention": flash_readings,
            "paged_attention": paged_readings}
    results = {f"sound {k}": fn(args.seed, device) for k, fn in read.items()}
    sound_libs = {k: _build.load(k) for k in read}
    try:
        for name, src in srcs.items():
            kernel = KERNEL[name]
            _build._LOADED[kernel] = _build.bind(src.with_suffix(".so"),
                                                 kernel)
            results[name] = read[kernel](args.seed, device)
            _build._LOADED[kernel] = sound_libs[kernel]
    finally:
        _build._LOADED.update(sound_libs)

    ok = True
    for name, res in results.items():
        failed = [k for k, (_, share) in res.items() if not share <= 1.0]
        worst = max(share if share == share else math.inf  # NaN fails
                    for _, share in res.values())
        print(f"{name}: " + "; ".join(
            f"{k} max |diff| {d:.4g}, {share:.4g} of the limit"
            for k, (d, share) in res.items())
            + f" -> fails {len(failed)} of {len(res)} checks")
        if name.startswith("sound"):
            ok &= not failed
        else:
            ok &= worst >= MARGIN
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"the checks pass the sound kernels and fail every mutant by "
          f">= {MARGIN}x" if ok else
          f"FAILED: a mutant passed every check by less than {MARGIN}x, or "
          f"a sound kernel failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
