"""End-to-end fault-tolerant LM training on the PyTorch port (reduced
granite-3-8b at smoke scale) for a few hundred steps with an injected
failure and checkpoint recovery.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu] \
        [--steps 200]

The port of examples/train_lm.py: `repro_torch.launch.train.main` with
batch 8 x 128 tokens in 2 microbatches, a checkpoint every 25 steps under
the temp directory, and a failure injected at the half-way step. The
training path runs on no hand-written kernel. It runs on the card unless
``--device cpu`` is given, and raises without a GPU.
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    return train.main([
        "--arch", "granite_3_8b", "--reduced", "--steps", str(args.steps),
        "--batch", "8", "--seq", "128", "--n-micro", "2", "--ckpt-dir",
        args.ckpt_dir, "--ckpt-every", "25", "--fail-at",
        str(args.steps // 2), "--device", args.device])


if __name__ == "__main__":
    main()
