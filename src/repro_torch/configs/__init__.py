"""Architecture configs (public-literature specs) and the paper's config.

Each module exposes CONFIG: ArchConfig with the exact published dimensions;
`get(name)` resolves by arch id (dashes or underscores). The port holds the
dense family and the three families that decode through the paged KV cache
(moe, vlm, audio); the recurrent families raise until their models are
ported (ROADMAP A8).
"""
from __future__ import annotations

import importlib

DENSE = ("granite_3_8b", "stablelm_12b", "mistral_large_123b",
         "nemotron_4_340b")
FAMILIES = ("olmoe_1b_7b", "qwen2_moe_a2_7b", "paligemma_3b",
            "whisper_small")
PORTED = DENSE + FAMILIES
NOT_PORTED = ("mamba2_130m", "recurrentgemma_9b")
ARCHS = PORTED + NOT_PORTED


def get(name: str):
    key = name.replace("-", "_").replace(".", "_")
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: its model family is not ported yet (ROADMAP A8); the "
            f"port serves: {', '.join(PORTED)}")
    if key not in PORTED:
        raise ValueError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG
