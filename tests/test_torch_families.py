"""The moe, vlm and audio families of the port against the reference's, on
the CPU.

olmoe-1b-7b, qwen2-moe-a2.7b, paligemma-3b and whisper-small, **reduced**
(fp32, 2 layers, page 16; the vlm's 8 patches, the audio's 2 encoder
layers over 16 frames), with the reference's parameters carried across by
`convert.params_from_reference` and the stub frontends' embeddings from a
NumPy seed:

  * the registry serves the three families and their parameter trees
    match the reference's (names, shapes, dtypes; the MoE router fp32
    under a bf16 config, the encoder-decoder's nested ``enc`` / ``dec``),
    and `params_from_reference` carries them;
  * `loss` to 1e-5 relative (two layers of fp32 sums in another order);
  * prefill + 4 greedy decode steps (`test_torch_serve._prefill_decode_both`):
    logits to 1e-4 * max|logit| + 1e-5 at every step, tokens exact, the
    pages and the audio's ``enc_k`` / ``enc_v`` to 1e-5 of their max;
  * `serve` end to end against the reference's `serve.main` steps:
    tokens, page ids and pool stats exact;
  * the vlm's cache sizing: the reference's, which leaves out the patch
    prefix, fails once the prefix is longer than a page, where the port's
    serves; and the refusals (an unaligned vlm prefill, ssm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kvcache import paged as jpaged
from repro.models import registry as jreg
from repro.models import vlm as jvlm

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.config import ArchConfig
from repro_torch.models import encdec, moe, registry as treg, vlm

from test_torch_serve import (_prefill_decode_both, _ref_params,
                              _reference_serve, frontends)

ARCHS = ("olmoe_1b_7b", "qwen2_moe_a2_7b", "paligemma_3b", "whisper_small")
MODULES = {"moe": moe, "vlm": vlm, "audio": encdec}


def _dtype_names(tree):
    return {k: _dtype_names(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_families_are_served_with_the_reference_params(name):
    """`get_module`, the full-width parameter specs and the carried
    parameters of a bf16 reduced config."""
    cfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    assert treg.get_module(tcfg) is MODULES[cfg.family]
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jreg.param_sds(cfg))
    assert _dtype_names(treg.param_specs(tcfg)) == want
    rcfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    jparams = jreg.init(rcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")
    assert _dtype_names(tparams) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), jparams)
    if cfg.family == "moe":
        assert tparams["blocks"]["wr"].dtype == torch.float32
        assert tparams["blocks"]["we1"].dtype == torch.bfloat16
    if cfg.family == "audio":
        assert set(tparams["enc"]) < set(tparams["dec"])
        assert tparams["dec"]["xwq"].shape == tparams["dec"]["wq"].shape
    ours = treg.init(dataclasses.replace(tcfg.reduced(), dtype="bfloat16"),
                     seed=1, device="cpu")
    assert _dtype_names(ours) == _dtype_names(tparams)


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "paligemma_3b",
                                  "whisper_small"])
def test_loss_matches_reference(name):
    cfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    jparams, tparams = _ref_params(cfg, seed=3)
    rng = np.random.default_rng(9)
    S = 24
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    front = frontends(cfg, 2, seed=10)
    jl, _ = jreg.loss_fn(cfg)(jparams, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        **{k: jnp.asarray(v) for k, v in front.items()}})
    tl, aux = treg.loss_fn(tcfg)(tparams, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        **{k: torch.from_numpy(v) for k, v in front.items()}})
    assert float(aux["loss"]) == float(tl)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_prefill_decode_matches_reference(name):
    _prefill_decode_both(name)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_reference_end_to_end(name):
    """batch 2, text prompt 16, 8 decode steps (the vlm's 8 patches pad
    its prompt to 24): tokens, page ids and pool stats exact."""
    cfg = dataclasses.replace(jconfigs.get(name).reduced(),
                              attend_impl="kernel")
    jparams, tparams = _ref_params(cfg, seed=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16))
    front = frontends(cfg, 2, seed=12)
    want_toks, want_pages, want_stats = _reference_serve(cfg, jparams, toks,
                                                         8, front)
    res = tserve.serve(tconfigs.get(name).reduced(), batch=2, prompt_len=16,
                       decode_steps=8, impl="kernel", device="cpu",
                       params=tparams, tokens=torch.from_numpy(toks),
                       frontends={k: torch.from_numpy(v)
                                  for k, v in front.items()})
    np.testing.assert_array_equal(res.tokens.numpy(), want_toks)
    np.testing.assert_array_equal(res.page_ids.numpy(), want_pages)
    assert res.stats == want_stats
    assert res.logits_finite and res.stats["fails"] == 0
    assert sorted(res.frontends) == sorted(front)
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    assert res.prompt.shape[1] == (24 if prefix else 16)
    assert int(res.cache["seq_lens"][0]) == prefix + res.prompt.shape[1] + 8


def test_reference_vlm_cache_sizing_fails_for_a_long_patch_prefix():
    """The reference's serve sizes the cache as prompt + decode_steps +
    page (its serve.py:84), without the patch prefix: with 32 patches
    (two pages of 16) and an 8-token prompt the prefill writes 3 pages
    into a cache of 2, and the reference's `vlm.prefill` raises. The
    port's serve counts the prefix and serves the same request."""
    cfg = dataclasses.replace(jconfigs.get("paligemma_3b").reduced(),
                              n_patches=32)
    tcfg = dataclasses.replace(tconfigs.get("paligemma_3b").reduced(),
                               n_patches=32)
    B, S, steps, page = 2, 8, 4, cfg.page_size
    P = jpaged.pages_per_seq(S + steps + page, page)
    written = (cfg.n_patches + S + (-(cfg.n_patches + S)) % page) // page
    assert (P, written) == (2, 3)
    jparams, tparams = _ref_params(cfg, seed=4)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jvlm.cache_spec(cfg, B, S + steps + page))
    front = frontends(cfg, B)
    toks = np.zeros((B, written * page - cfg.n_patches), np.int32)
    with pytest.raises((ValueError, TypeError), match="shape"):
        jvlm.prefill(cfg, jparams, {"tokens": jnp.asarray(toks),
                                    "patch_embeds": jnp.asarray(
                                        front["patch_embeds"])}, cache)
    res = tserve.serve(tcfg, batch=B, prompt_len=S, decode_steps=steps,
                       device="cpu", params=tparams,
                       frontends={k: torch.from_numpy(v)
                                  for k, v in front.items()})
    assert res.logits_finite and res.page_ids.shape == (B, 4)
    assert int(res.cache["seq_lens"][0]) == written * page + steps


def test_vlm_prefill_and_serve_refuse_what_they_cannot_serve():
    tcfg = tconfigs.get("paligemma_3b").reduced()
    params = treg.init(tcfg, seed=0, device="cpu")
    cache = vlm.init_cache(tcfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="page size 16"):
        vlm.prefill(tcfg, params, {
            "tokens": torch.zeros((1, 16), dtype=torch.long),
            "patch_embeds": torch.zeros((1, 8, tcfg.d_model))}, cache)
    ssm = ArchConfig(**dataclasses.asdict(
        jconfigs.get("mamba2_130m").reduced()))
    with pytest.raises(ValueError, match="ssm decode has no paged KV"):
        tserve.serve(ssm, batch=1, prompt_len=16, decode_steps=1,
                     device="cpu")
    fronts = treg.make_frontends(tconfigs.get("whisper_small").reduced(), 3,
                                 seed=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in fronts.items()} == \
        {"enc_embeds": (3, 16, 128)}
    assert treg.make_frontends(tconfigs.get("olmoe_1b_7b"), 3,
                               device="cpu") == {}


def test_serve_main_serves_the_new_archs():
    for arch in ARCHS:
        res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--decode-steps", "2"])
        assert res.logits_finite and res.tokens.shape == (2, 3)
