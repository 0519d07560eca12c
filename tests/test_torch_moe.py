"""The port's MoE layer against the reference's, on the CPU.

`models.moe._moe_mlp` is held against `repro.models.moe._moe_mlp` on the
same NumPy inputs and layer weights (fp32, reduced widths: D=128, 8
experts, top-2, expert FF 64, groups of 64 tokens), to 1e-5 of max |y|
(fp32 products summed in another order), in six cases of one test:

  * ``reduced``: olmoe-1b-7b reduced as it is;
  * ``padded``: 6 experts padded to 8 (``pad_experts_to=4``): the two
    dummies are masked off the router and never chosen;
  * ``overflow``: ``capacity_factor=0.25``, so experts fill and tokens
    drop (a dropped (token, k) contributes 0);
  * ``shared``: qwen2-moe-a2.7b reduced (a shared swiglu expert);
  * ``ties``: every router weight 0, so every logit ties: the expert ids
    equal `lax.top_k`'s (lower index first) and the capacity drops the
    rest;
  * ``groups``: 2400 tokens, more than ``moe_parallel_groups`` groups of
    64, where the reference's output order is not the token order (chunk
    ``i_m * n_iter + i_iter`` lands at ``i_iter * m + i_m``): the port
    keeps it.

Besides: `top_k` against `lax.top_k` on tied bf16 probabilities (whose
order `torch.topk` does not promise), the group and capacity sizing
against the reference's formulas, and the parameter shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.models import moe as jmoe

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe

CASES = {
    "reduced": ("olmoe_1b_7b", {}, (2, 16), False),
    "padded": ("olmoe_1b_7b", {"n_experts": 6, "pad_experts_to": 4},
               (2, 16), False),
    "overflow": ("olmoe_1b_7b", {"capacity_factor": 0.25}, (2, 16), False),
    "shared": ("qwen2_moe_a2_7b", {}, (2, 16), False),
    "ties": ("olmoe_1b_7b", {}, (2, 16), True),
    "groups": ("olmoe_1b_7b", {}, (4, 600), False),
}


def _cfgs(name, overrides):
    return (dataclasses.replace(jconfigs.get(name).reduced(), **overrides),
            dataclasses.replace(tconfigs.get(name).reduced(), **overrides))


def _layer(cfg, rng, zero_router=False):
    """One layer's MoE weights, scaled so that y is O(1)."""
    D, E, Fe = cfg.d_model, cfg.padded_experts, cfg.expert_d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    lp = {"wr": np.zeros((D, E), np.float32) if zero_router else w(D, E),
          "we1": w(E, D, Fe), "we2": w(E, Fe, D), "we3": w(E, D, Fe)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        lp.update(ws1=w(D, Fs), ws2=w(Fs, D), ws3=w(D, Fs))
    return lp


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_reference(case):
    name, overrides, (B, S), zero_router = CASES[case]
    cfg, tcfg = _cfgs(name, overrides)
    rng = np.random.default_rng(11)
    lp = _layer(cfg, rng, zero_router)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmoe._moe_mlp(cfg, jnp.asarray(h), {
        k: jnp.asarray(v) for k, v in lp.items()}))
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    got = tmoe._moe_mlp(tcfg, torch.from_numpy(h), tlp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)

    # the routing itself: ids == lax.top_k's, slots and drops
    Gs, C, m, n_iter = tmoe.group_shape(tcfg, B * S)
    assert Gs * m * n_iter >= B * S
    x = np.pad(h.reshape(B * S, -1), ((0, Gs * m * n_iter - B * S), (0, 0)))
    xg = x.reshape(m, n_iter, Gs, -1).transpose(1, 0, 2, 3).reshape(
        m * n_iter, Gs, -1)
    gates, idx = tmoe.route(tcfg, torch.from_numpy(xg), tlp["wr"])
    logits = jnp.asarray(xg) @ jnp.asarray(lp["wr"])
    if cfg.padded_experts != cfg.n_experts:
        logits = jnp.where(jnp.arange(cfg.padded_experts) < cfg.n_experts,
                           logits, -1e30)
    jg, jidx = lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(
        jg / jg.sum(-1, keepdims=True)), atol=1e-6)
    _, keep = tmoe.slots(idx, cfg.padded_experts, C)
    dropped = int((~keep).sum())
    if case == "padded":
        assert int(idx.max()) < cfg.n_experts < cfg.padded_experts
    if case == "overflow":
        assert C == 8 and dropped > 0
    if case == "ties":  # every token picks experts 0..K-1; C of each kept
        assert (idx.numpy() == np.arange(cfg.top_k)).all()
        assert dropped == m * n_iter * (Gs - C) * cfg.top_k
    if case in ("reduced", "shared"):
        assert dropped == 0
    if case == "groups":  # the reference's order is not the token order
        assert m == cfg.moe_parallel_groups and n_iter > 1
        flat = tmoe._moe_mlp(dataclasses.replace(
            tcfg, moe_parallel_groups=1), torch.from_numpy(h), tlp).numpy()
        assert np.abs(flat - want).max() > 0.1


def test_top_k_keeps_lax_tie_order():
    """The lower index first among equal values, as `lax.top_k`; a bf16
    router over 64 experts ties often, and `torch.topk` promises no
    order among ties."""
    row = np.array([.1, .3, .3, .2, .3, 0.], np.float32)
    assert tmoe.top_k(torch.from_numpy(row), 2)[1].tolist() == [1, 2]
    assert np.asarray(lax.top_k(jnp.asarray(row), 2)[1]).tolist() == [1, 2]
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 6, size=(4, 33, 64)).astype(np.float32) / 8
    for k in (1, 4, 8):
        vals, idx = tmoe.top_k(torch.from_numpy(probs).bfloat16(), k)
        jv, ji = lax.top_k(jnp.asarray(probs, jnp.bfloat16), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.float().numpy(),
                                      np.asarray(jv, np.float32))


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "qwen2_moe_a2_7b"])
def test_group_shape_and_params_match_reference(name):
    """Capacity and the adaptive group at the full width (decode: B=8
    tokens is one group of 8, C=8; prefill 8 x 512 is two groups of 2048)
    and reduced; the parameter tree's names, shapes and dtypes (the
    router fp32 under a bf16 config)."""
    for cfg, tcfg in ((jconfigs.get(name), tconfigs.get(name)),
                      _cfgs(name, {})):
        assert tmoe.capacity(tcfg) == jmoe.capacity(cfg)
        assert tmoe.param_shapes(tcfg) == jmoe.param_shapes(cfg)
        for n in (1, 8, 24, 4096, 2400):
            Gs, C, m, n_iter = tmoe.group_shape(tcfg, n)
            E, K = cfg.padded_experts, cfg.top_k
            assert Gs == min(cfg.moe_group, max(8 * -(-n // 8), 8))
            assert C == max(8 * -(-int(Gs * K * cfg.capacity_factor / E)
                                  // 8), 8)
            assert m == max(min(cfg.moe_parallel_groups, -(-n // Gs)), 1)
            assert n_iter * m * Gs >= n > (n_iter - 1) * m * Gs
    full = tconfigs.get(name)
    assert tmoe.group_shape(full, 8)[:2] == (8, 8)
    assert tmoe.group_shape(full, 8 * 512)[::2] == (2048, 2)
    assert tmoe.param_shapes(full)["blocks"]["wr"][1] == "float32"
    assert full.padded_experts == 64
