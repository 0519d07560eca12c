"""Paged-KV serving with PIM-malloc page management and the hand-written
paged-attention kernel, on the PyTorch port.

    PYTHONPATH=src python examples/serve_paged_torch.py [--device cpu] \
        [any flag of repro_torch.launch.serve]

The port of examples/serve_paged.py: a thin wrapper over the serving
entry point (`repro_torch.launch.serve`) at smoke scale, granite-3-8b reduced,
4 requests of 32 prompt tokens, 48 decode steps. Page extents come from
the heap API (PagePool -> Table-2 facade -> heap.step); decode-time page
growth routes through a 2-rank ShardedHeap fleet with FleetRouter
accounting; ``--impl kernel`` (via ArchConfig.attend_impl) runs the
paged-attention kernel (`csrc/paged_attention.cu`) on the card. Flags
given after the defaults override them.

It runs on the card unless ``--device cpu`` is given, and raises without a
GPU. The last line counts the paged-attention kernel's launches (0 on the
CPU, where the wrapper runs the kernel's plain version).
"""
import sys

from repro_torch.kernels import paged_attention
from repro_torch.launch import serve

DEFAULTS = ["--arch", "granite_3_8b", "--reduced", "--batch", "4",
            "--prompt-len", "32", "--decode-steps", "48", "--impl", "kernel",
            "--fleet-ranks", "2"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paged_attention.paged_attention.launches = 0
    res = serve.main(DEFAULTS + list(argv))
    print(f"paged-attention kernel launches: "
          f"{paged_attention.paged_attention.launches}")
    return res


if __name__ == "__main__":
    main()
