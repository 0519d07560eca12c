#!/usr/bin/env python3
"""Cycles per dependent operation of the warp primitives the heap-step and
buddy kernels' serial chains are made of, measured on the card.

    python3 tools/warp_latency.py [--n 1000] [--out F]

One warp per CTA runs a chain of n operations, each depending on the one
before, between two clock64() reads: a shared-memory load on one lane and on
all lanes, a ballot (with the __ffs that reads it), a warp min-reduction, a
shuffle, an integer multiply-add, and a buddy descent step (a shared-memory
load, a compare, a select). It prints one JSON line of cycles per
operation, with 1 and with 512 CTAs. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
__global__ void chains(int* out, int n, int mode) {
  __shared__ int sm[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) sm[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  int x = lane & 1;
  const int tag = lane, lu = lane;
  const long long t0 = clock64();
  if (mode == 0) {
    if (lane == 0) for (int i = 0; i < n; ++i) x = sm[x];
  } else if (mode == 1) {
    for (int i = 0; i < n; ++i) x = sm[x];
  } else if (mode == 2) {
    for (int i = 0; i < n; ++i)
      x = (x + __ffs(__ballot_sync(0xffffffffu, tag == x))) & 31;
  } else if (mode == 3) {
    for (int i = 0; i < n; ++i)
      x = (__reduce_min_sync(0xffffffffu, lu + x) + 1) & 31;
  } else if (mode == 4) {
    for (int i = 0; i < n; ++i) x = __shfl_sync(0xffffffffu, x, x & 31) + 1;
  } else if (mode == 5) {
    for (int i = 0; i < n; ++i) x = x * 3 + 1;
  } else if (mode == 6) {
    if (lane == 0)
      for (int i = 0; i < n; ++i) {
        const int l = 2 * (x & 511);
        x = sm[l] >= 512 ? l : l + 1;
      }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[2 * blockIdx.x] = static_cast<int>(t1 - t0);
    out[2 * blockIdx.x + 1] = x;
  }
}
extern "C" int chains_launch(int* out, int n, int mode, int ctas) {
  chains<<<ctas, 32>>>(out, n, mode);
  return static_cast<int>(cudaGetLastError());
}
"""
MODES = ("shared load, lane 0", "shared load, all lanes", "ballot + ffs",
         "min-reduction", "shuffle", "integer multiply-add",
         "descent step, lane 0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("warp_latency: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    build = ROOT / "build" / "tools"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "warp_latency.cu", build / "libwarp_latency.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), _build.ARCH, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.chains_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    buf = torch.zeros(2 * 512, dtype=torch.int32, device="cuda")
    res = {}
    for mode, name in enumerate(MODES):
        for ctas in (1, 512):
            for _ in range(2):  # the first launch warms up
                err = lib.chains_launch(buf.data_ptr(), args.n, mode, ctas)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                torch.cuda.synchronize()
            cyc = buf[0::2][:ctas].double() / args.n
            res[f"{name}, {ctas} CTAs"] = round(float(cyc.mean()), 2)
    res["gpu"] = torch.cuda.get_device_name(0)
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
