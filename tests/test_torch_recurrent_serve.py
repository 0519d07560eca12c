"""Serving the recurrent families of the port (ssm: mamba2-130m; hybrid:
recurrentgemma-9b) against the reference's, on the CPU.

Both **reduced** (fp32, d_model 128, SSD chunk 16, window 32, page 16),
with the reference's parameters carried across by
`convert.params_from_reference` and prompts from a NumPy seed:

  * prefill + 4 greedy decode steps through
    `test_torch_serve._prefill_decode_both` (the reference jitted, as its
    serve runs it): logits to 1e-4 of max |logit| at every step, tokens
    exact, every state and window buffer to 1e-5 of its max; mamba2 over
    three SSD chunks; the hybrid also at 5 layers (a 2-layer recurrent
    tail) and with a 40-token prompt, whose 48 padded tokens pass the
    32-token window, so the prefill keeps the last 32 and the decode
    wraps;
  * `serve` of the hybrid end to end against the reference's `serve.main`
    steps: tokens, page ids and pool stats exact, no page table in its
    cache; ssm is refused, as the reference refuses it.

The models' functions, loss and gradients are held in
tests/test_torch_recurrent.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve

from test_torch_recurrent import HYBRID, SSM, _ref_params
from test_torch_serve import _prefill_decode_both, _reference_serve


# --------------------------------------------------------- prefill, decode --
@pytest.mark.parametrize("name,prompt,overrides", [
    (SSM, 40, {}),                 # 48 tokens: three SSD chunks
    (HYBRID, 16, {}),
    # one group and a 2-layer tail, with flat attention weights: under
    # attn_4d the reference's init saturates the softmax, which moves the
    # tail's conv states by 1.2e-5 of their max (1.1e-6 flat)
    (HYBRID, 16, dict(n_layers=5, attn_4d=False)),
    (HYBRID, 40, {}),              # 48 tokens > window 32: the buffer wraps
], ids=["ssm", "hybrid", "hybrid_tail", "hybrid_wrap"])
def test_reduced_prefill_decode_matches_reference(name, prompt, overrides):
    _prefill_decode_both(name, prompt=prompt, jit=True, **overrides)


# ------------------------------------------------------------------- serve --
def test_serve_hybrid_matches_reference_end_to_end():
    """batch 2, prompt 16, 8 decode steps: the pool hands out the extents
    and a decode-time page (the first step crosses a page boundary); the
    cache has no page table. Tokens, page ids and pool stats exact."""
    cfg = dataclasses.replace(jconfigs.get(HYBRID).reduced(),
                              attend_impl="kernel")
    jparams, tparams = _ref_params(cfg, seed=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16))
    want_toks, want_pages, want_stats = _reference_serve(cfg, jparams, toks,
                                                         8)
    res = tserve.serve(tconfigs.get(HYBRID).reduced(), batch=2,
                       prompt_len=16, decode_steps=8, impl="kernel",
                       device="cpu", params=tparams,
                       tokens=torch.from_numpy(toks))
    np.testing.assert_array_equal(res.tokens.numpy(), want_toks)
    np.testing.assert_array_equal(res.page_ids.numpy(), want_pages)
    assert res.stats == want_stats
    assert res.page_allocs == 2 and res.pool_rounds == 3
    assert res.logits_finite and "page_table" not in res.cache
    assert int(res.cache["seq_lens"][0]) == 16 + 8


def test_serve_refuses_ssm_and_main_serves_the_hybrid():
    with pytest.raises(ValueError, match="ssm decode has no paged KV"):
        tserve.serve(tconfigs.get(SSM).reduced(), batch=1, prompt_len=16,
                     decode_steps=1, device="cpu")
    res = tserve.main(["--arch", HYBRID, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--decode-steps", "2"])
    assert res.logits_finite and res.tokens.shape == (2, 3)
