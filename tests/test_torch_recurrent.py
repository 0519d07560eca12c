"""The recurrent families of the port (ssm: mamba2-130m; hybrid:
recurrentgemma-9b) against the reference's, on the CPU.

Both **reduced** (fp32, d_model 128, SSD chunk 16, window 32, page 16),
with the reference's parameters carried across by
`convert.params_from_reference` and inputs from a NumPy seed:

  * the parameter trees (names, shapes, dtypes, the four fp32 leaves
    ``a_log`` / ``d_skip`` / ``dt_bias`` / ``a_param`` under a bf16
    config) equal the reference's, at full width too, and the port's own
    `init` sets the reference's overrides exactly;
  * `ssd_chunked` at S = 24 (padded to two chunks) and S = 48 (three
    chunks) and `ssd_recurrent_step` to 1e-5, and its gradients finite
    where the reference's overflow to NaN (ROADMAP C); `_rglru_scan` at
    S = 1, 7,
    64 and 100 and `_rglru_step` to 1e-6 relative (the port's scan
    combines in `lax.associative_scan`'s order);
  * `loss` to 1e-5 relative and its autograd gradients against
    `jax.value_and_grad`, per leaf to ``GRAD_TOL`` of max |g| (the
    hybrid's attention weights are `attn_4d`, whose reference init
    saturates the scores: tests/test_torch_train.py); under remat the
    port's loss and gradients are the same bit for bit;
  * decode after prefill == the full forward at the last position, in
    the port itself (the reference's test_decode_consistency);
  * the trainer trains both through a recovery drill; `build` cuts the
    depth.

Prefill, decode and `serve` against the reference's are in
tests/test_torch_recurrent_serve.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import hybrid as jhy
from repro.models import registry as jreg
from repro.models import ssm as jssm

from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import hybrid as thy
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw

from test_torch_serve import _ref_params as _serve_ref_params
from test_torch_train import _assert_trees, _batch, _tb

SSM, HYBRID = "mamba2_130m", "recurrentgemma_9b"
FP32_LEAVES = {"ssm": ("a_log", "d_skip", "dt_bias"), "hybrid": ("a_param",)}
LOSS_TOL = 1e-5
GRAD_TOL = 3e-4   # of max |g| per leaf: the attn_4d init (see the docstring)


def _cfgs(name, **over):
    return (dataclasses.replace(jconfigs.get(name).reduced(), **over),
            dataclasses.replace(tconfigs.get(name).reduced(), **over))


def _ref_params(cfg, seed=0):
    """The reference's parameters (its init jitted) and the port's copy."""
    return _serve_ref_params(cfg, seed, jit=True)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- parameters --
@pytest.mark.parametrize("name,layers", [(SSM, 2), (HYBRID, 5)])
def test_params_match_reference(name, layers):
    """Names, shapes and dtypes of a bf16 config's parameters (reduced and
    at full width), the carried tree, and the port's own init."""
    cfg, tcfg = _cfgs(name, dtype="bfloat16", n_layers=layers)
    fam = cfg.family
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jreg.param_sds(jconfigs.get(name)))
    assert _shapes(treg.param_specs(tconfigs.get(name))) == want
    jparams, tparams = _ref_params(cfg, seed=1)
    assert _shapes(tparams) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), jparams)
    ours = treg.init(tcfg, seed=1, device="cpu")
    assert _shapes(ours) == _shapes(tparams)
    trees = ["blocks"] if fam == "ssm" else \
        [k for k in ("rec1", "rec2", "tail") if k in ours]
    assert ("tail" in ours) == (fam == "hybrid" and layers % 3 > 0)
    for tree in trees:
        for leaf in FP32_LEAVES[fam]:
            assert tparams[tree][leaf].dtype == torch.float32
            np.testing.assert_array_equal(
                tparams[tree][leaf].numpy(),
                np.asarray(jparams[tree][leaf]))
        assert tparams[tree]["ln"].dtype == torch.bfloat16
    if fam == "ssm":
        b = ours["blocks"]
        H = b["a_log"].shape[1]
        want_a = torch.log(torch.linspace(1.0, 16.0, H)).expand(layers, H)
        assert torch.equal(b["a_log"], want_a)
        assert torch.equal(b["dt_bias"], torch.full((layers, H), -4.6))
        # the two packages' log differ in the last bit at some H
        np.testing.assert_allclose(b["a_log"].numpy(), np.asarray(
            jparams["blocks"]["a_log"]), rtol=2e-7, atol=0)
    else:
        for tree in trees:
            assert torch.equal(ours[tree]["a_param"],
                               torch.full_like(ours[tree]["a_param"], 0.65))
    again = treg.init(tcfg, seed=1, device="cpu")
    assert torch.equal(ours["embed"], again["embed"])


# --------------------------------------------------------------------- SSD --
@pytest.mark.parametrize("S", [24, 48])
def test_ssd_chunked_matches_reference(S):
    rng = np.random.default_rng(S)
    b, h, p, n, chunk = 2, 3, 8, 16, 16
    x, B_, C_ = _rand(rng, b, S, h, p), _rand(rng, b, S, n), \
        _rand(rng, b, S, n)
    dt = np.log1p(np.exp(_rand(rng, b, S, h) - 1.0)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    jy, jh = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, B_, C_)), chunk)
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C_)),
                              chunk)
    assert ty.shape == (b, S, h, p) and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    # one recurrent step from the final state
    x1, dt1, B1, C1 = x[:, 0], dt[:, 0], B_[:, 0], C_[:, 0]
    js, jy1 = jssm.ssd_recurrent_step(jh, *map(jnp.asarray,
                                               (x1, dt1, A, B1, C1)))
    ts, ty1 = tssm.ssd_recurrent_step(th, *map(torch.from_numpy,
                                               (x1, dt1, A, B1, C1)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=1e-5,
                               rtol=1e-5)


def _ssd_sequential(x, dt, A, B_, C_):
    """The SSD as its plain recurrence h_t = exp(dt_t A) h_{t-1} + dt_t
    (x_t B_t), y_t = h_t C_t, one step at a time: y [b,s,h,p]."""
    b, S, h, p = x.shape
    state = x.new_zeros((b, h, p, B_.shape[-1]))
    ys = []
    for t in range(S):
        state = state * torch.exp(dt[:, t] * A)[:, :, None, None] + \
            torch.einsum("bh,bn,bhp->bhpn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t], state))
    return torch.stack(ys, 1)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """A chunk whose decay sum passes fp32's exp range (dt = 6, A = -16
    over 16 steps): the reference's exp before its causal where makes
    the gradient of dt NaN (and, in a model, every gradient upstream of
    it); the port masks first, so its outputs equal the reference's and
    its gradient of dt is finite and equals the plain recurrence's, run
    step by step in float64."""
    rng = np.random.default_rng(3)
    b, S, h, p, n = 1, 16, 2, 4, 8
    x, B_, C_ = _rand(rng, b, S, h, p), _rand(rng, b, S, n), \
        _rand(rng, b, S, n)
    dt = np.full((b, S, h), 6.0, np.float32)
    dt[:, ::3] = 0.05
    A = np.array([-16.0, -0.5], np.float32)

    def jf(dt):
        return jssm.ssd_chunked(jnp.asarray(x), dt, *map(
            jnp.asarray, (A, B_, C_)), 16)[0].sum()

    jy = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, B_, C_)), 16)[0]
    assert np.isnan(np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(dt)))).any()
    grads = []
    for fn, dtype, tol in ((lambda *a: tssm.ssd_chunked(*a, 16)[0],
                            torch.float32, 1e-5),
                           (_ssd_sequential, torch.float64, 1e-4)):
        tdt = torch.from_numpy(dt).to(dtype).requires_grad_()
        x_, A_, b_, c_ = (torch.from_numpy(a).to(dtype)
                          for a in (x, A, B_, C_))
        ty = fn(x_, tdt, A_, b_, c_)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   atol=tol, rtol=tol)
        grads.append(torch.autograd.grad(ty.sum(), tdt)[0])
    assert torch.isfinite(grads[0]).all()
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-5 * float(
                                   grads[1].abs().max()))


# ------------------------------------------------------------------ RG-LRU --
@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_rglru_scan_matches_reference(S):
    rng = np.random.default_rng(100 + S)
    B, D = 2, 16
    x = _rand(rng, B, S, D)
    r, i = (1 / (1 + np.exp(-_rand(rng, B, S, D))) for _ in range(2))
    a_param = _rand(rng, D) * 0.5 + 0.65
    args = (x, r.astype(np.float32), i.astype(np.float32), a_param)
    want = np.asarray(jax.jit(jhy._rglru_scan)(*map(jnp.asarray, args)))
    got = thy._rglru_scan(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 *
                               np.abs(want).max())
    # the step from a state
    st = _rand(rng, B, D)
    js, jy = jhy._rglru_step(jnp.asarray(st), *map(
        jnp.asarray, (x[:, 0], args[1][:, 0], args[2][:, 0], a_param)))
    ts, ty = thy._rglru_step(torch.from_numpy(st), *map(
        torch.from_numpy, (x[:, 0], args[1][:, 0], args[2][:, 0], a_param)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)


def test_associative_scan_is_an_inclusive_scan():
    """On integer addition (exact in any order): the cumulative sum, at
    lengths with odd and even halves."""
    for n in (1, 2, 3, 5, 8, 13, 64):
        x = torch.arange(1, 2 * n + 1).reshape(2, n)
        (got,) = thy.associative_scan(lambda a, b: (a[0] + b[0],), (x,), 1)
        assert torch.equal(got, torch.cumsum(x, 1)), n


# --------------------------------------------------------- loss, gradients --
LOSS_CASES = {
    "ssm": (SSM, {}, 40),                          # 3 chunks of 16, padded
    # past the 32-token window, and a 2-layer recurrent tail
    "hybrid": (HYBRID, dict(n_layers=5), 40),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    """Against the reference's, with remat off; with remat on (each block
    or mixer checkpointed) the port gives the same loss and gradients bit
    for bit."""
    name, over, S = LOSS_CASES[case]
    cfg, tcfg = _cfgs(name, **over)
    jparams, tparams = _ref_params(cfg, seed=3)
    batch = _batch(cfg, 2, S, seed=4)
    vg = jax.jit(jax.value_and_grad(jreg.loss_fn(cfg), has_aux=True))
    (l, _), g = vg(jparams, batch)
    (tl_, taux), tg = tsteps.make_grad_fn(tcfg)(tparams, _tb(batch))
    assert abs(float(tl_) - float(l)) <= LOSS_TOL * abs(float(l))
    assert float(taux["loss"]) == float(tl_)
    _assert_trees(tg, g, rel=GRAD_TOL, what=f"{case} grad ")
    (rl, _), rg = tsteps.make_grad_fn(dataclasses.replace(tcfg, remat=True))(
        tparams, _tb(batch))
    assert float(rl) == float(tl_)
    _assert_trees(rg, tg, atol=0.0, what=f"{case} remat grad ")


@pytest.mark.parametrize("name,S,overrides", [
    (SSM, 20, {}), (HYBRID, 20, {}), (HYBRID, 40, dict(n_layers=5))])
def test_decode_after_prefill_equals_forward(name, S, overrides):
    """Prefill S tokens, decode token S: its logits == the full forward's
    at position S (the port alone, as the reference's
    test_decode_consistency holds the reference)."""
    tcfg = dataclasses.replace(tconfigs.get(name).reduced(), **overrides)
    mod = treg.get_module(tcfg)
    params = treg.init(tcfg, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab, (2, S + 1)))
    full = mod.logits_fn(tcfg, params, mod.forward(tcfg, params, toks))
    cache = mod.init_cache(tcfg, 2, S + 1 + tcfg.page_size, device="cpu")
    cache, pl = mod.prefill(tcfg, params, {"tokens": toks[:, :S]}, cache)
    cache, dl = mod.decode(tcfg, params, cache, {"tokens": toks[:, S:]})
    for got, want in ((pl, full[:, S - 1]), (dl, full[:, S])):
        want = want[:, :tcfg.vocab]
        tol = 1e-4 * float(want.abs().max())
        assert float((got[:, :tcfg.vocab] - want).abs().max()) <= tol
    assert cache["seq_lens"].tolist() == [S + 1, S + 1]


@pytest.mark.parametrize("name", [SSM, HYBRID])
def test_trainer_trains_the_recurrent_archs(name, tmp_path):
    """`launch.train.main` on the reduced config with a failure at step 4:
    one recovery from the step-3 checkpoint, steps 0-5 done; `build` cuts
    the depth (the hybrid's 5 layers: one group and a 2-layer tail)."""
    (params, _), hist = ttrain.main([
        "--arch", name, "--reduced", "--device", "cpu", "--steps", "6",
        "--batch", "4", "--seq", "32", "--ckpt-every", "3", "--fail-at", "4",
        "--ckpt-dir", str(tmp_path)])
    assert hist["recoveries"] == 1 and hist["steps"] == list(range(6))
    assert all(bool(torch.isfinite(x).all())
               for x in tadamw.tree_leaves(params))
    cfg, params, _, _, _ = ttrain.build(name, True, 4, 32, 2, 6,
                                        device="cpu", layers=5)
    assert cfg.n_layers == 5 and ("tail" in params) == (name == HYBRID)
