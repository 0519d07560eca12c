"""Family dispatch, parameter init, input specs and seeded batches.

The port of `repro.models.registry` for all six families: dense, moe,
vlm, audio and the recurrent ssm and hybrid. The specs are
``device="meta"`` tensors (the counterpart of the reference's
ShapeDtypeStructs): shapes and dtypes, nothing allocated.

`make_train_batch`, `make_frontends` and `make_prompts` draw from NumPy
with a seed where the reference draws from `jax.random`, which the port
cannot reproduce (ROADMAP C); the tests feed both packages the same NumPy
batch.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from . import encdec, hybrid, layers, moe, ssm, transformer, vlm
from .config import ArchConfig, ShapeConfig

FAMILY_MODULES = {"dense": transformer, "ssm": ssm, "hybrid": hybrid,
                  "audio": encdec, "moe": moe, "vlm": vlm}

META = torch.device("meta")


def get_module(cfg: ArchConfig):
    return FAMILY_MODULES[cfg.family]


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed` on `device` (the card by default)."""
    return get_module(cfg).init(cfg, seed=seed, device=device)


def _meta(shapes):
    """A ``{name: (shape, dtype)}`` tree as meta tensors."""
    return {k: _meta(v) if isinstance(v, dict) else
            torch.empty(v[0], dtype=layers.torch_dtype(v[1]), device=META)
            for k, v in shapes.items()}


def param_specs(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (no allocation; dry run)."""
    return _meta(get_module(cfg).param_shapes(cfg))


def loss_fn(cfg: ArchConfig):
    mod = get_module(cfg)
    return lambda params, batch: mod.loss(cfg, params, batch)


# --------------------------------------------------------------- input specs
def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """VLM text length excludes the patch prefix (total positions =
    seq_len)."""
    if cfg.family == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def _frontend(cfg: ArchConfig, B: int) -> dict:
    """The stub frontends' input shapes of the audio and VLM families."""
    if cfg.family == "audio":
        return {"enc_embeds": ((B, cfg.enc_frames, cfg.d_model), cfg.dtype)}
    if cfg.family == "vlm":
        return {"patch_embeds": ((B, cfg.n_patches, cfg.d_model),
                                 cfg.dtype)}
    return {}


def train_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for one global training batch."""
    B, S = shape.global_batch, _text_len(cfg, shape.seq_len)
    return _meta({"tokens": ((B, S), torch.int32),
                  "labels": ((B, S), torch.int32), **_frontend(cfg, B)})


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(batch spec, cache spec) for a prefill step over the full
    seq_len."""
    B, S = shape.global_batch, _text_len(cfg, shape.seq_len)
    batch = _meta({"tokens": ((B, S), torch.int32), **_frontend(cfg, B)})
    cache = _meta(get_module(cfg).cache_spec(cfg, B, shape.seq_len))
    return batch, cache


def decode_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(batch spec, cache spec) for one decode step with a seq_len-deep
    cache."""
    B = shape.global_batch
    batch = _meta({"tokens": ((B, 1), torch.int32)})
    cache = _meta(get_module(cfg).cache_spec(cfg, B, shape.seq_len))
    return batch, cache


def make_train_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                     global_batch: int | None = None, device="cuda") -> dict:
    """Materialized synthetic batch on `device`: int32 tokens uniform over
    the unpadded vocab, labels = tokens, and the frontends' embeddings
    (standard normal in the config's dtype), drawn from `seed` with
    NumPy."""
    dev = _device.resolve(device)
    B = global_batch or shape.global_batch
    S = _text_len(cfg, shape.seq_len)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S),
                                         dtype=np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    for k, (shp, dt) in _frontend(cfg, B).items():
        batch[k] = torch.from_numpy(rng.standard_normal(
            shp, dtype=np.float32)).to(dev, layers.torch_dtype(dt))
    return batch


def make_frontends(cfg: ArchConfig, batch: int, seed: int = 0,
                   device="cuda") -> dict:
    """The stub frontends' embeddings of `batch` requests (``patch_embeds``
    for vlm, ``enc_embeds`` for audio, none for the other families):
    standard normal in the config's dtype, made from `seed` with NumPy,
    shaped as `_frontend` shapes them."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(
        shp, dtype=np.float32)).to(dev, layers.torch_dtype(dt))
        for k, (shp, dt) in _frontend(cfg, batch).items()}


def make_prompts(cfg: ArchConfig, batch: int, seq_len: int, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """Token ids int64 [batch, seq_len], uniform over the unpadded vocab,
    made from `seed` with NumPy so that every device gets the same prompt."""
    dev = _device.resolve(device)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(batch, seq_len), dtype=np.int64)
    return torch.from_numpy(toks).to(dev)
