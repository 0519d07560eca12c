"""The port's device rule: run on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and no GPU is
    present. Never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
