"""Architecture configs (public-literature specs) and the paper's config.

Each module exposes CONFIG: ArchConfig with the exact published dimensions;
`get(name)` resolves by arch id (dashes or underscores). Every arch of the
reference resolves: the dense family, the three families that decode
through the paged KV cache (moe, vlm, audio) and the two recurrent ones
(ssm, hybrid).
"""
from __future__ import annotations

import importlib

DENSE = ("granite_3_8b", "stablelm_12b", "mistral_large_123b",
         "nemotron_4_340b")
FAMILIES = ("olmoe_1b_7b", "qwen2_moe_a2_7b", "paligemma_3b",
            "whisper_small")
RECURRENT = ("mamba2_130m", "recurrentgemma_9b")
PORTED = DENSE + FAMILIES + RECURRENT
# the reference's order
ARCHS = (
    "mamba2_130m", "nemotron_4_340b", "stablelm_12b", "mistral_large_123b",
    "granite_3_8b", "recurrentgemma_9b", "whisper_small", "olmoe_1b_7b",
    "qwen2_moe_a2_7b", "paligemma_3b",
)


def get(name: str):
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def all_configs():
    return {a: get(a) for a in ARCHS}
