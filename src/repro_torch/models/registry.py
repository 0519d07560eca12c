"""Family dispatch, parameter init and seeded prompts.

The port of `repro.models.registry` for the dense family; the other
families (ssm, hybrid, audio, moe, vlm) wait for ROADMAP A8.
`make_prompts` stands in for the reference's ``make_train_batch`` on the
serving path.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from . import transformer
from .config import ArchConfig

FAMILY_MODULES = {"dense": transformer}


def get_module(cfg: ArchConfig):
    if cfg.family not in FAMILY_MODULES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP A8); ported: {', '.join(FAMILY_MODULES)}")
    return FAMILY_MODULES[cfg.family]


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device` (the card by default)."""
    return get_module(cfg).init(cfg, seed=seed, device=device)


def make_prompts(cfg: ArchConfig, batch: int, seq_len: int, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """Token ids int64 [batch, seq_len], uniform over the unpadded vocab,
    made from `seed` with NumPy so that every device gets the same prompt."""
    dev = _device.resolve(device)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(batch, seq_len), dtype=np.int64)
    return torch.from_numpy(toks).to(dev)
