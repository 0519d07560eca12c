"""Training the moe, vlm and audio families: the port against the
reference, on the CPU.

olmoe-1b-7b, qwen2-moe-a2.7b, paligemma-3b and whisper-small **reduced**
(fp32, 2 layers, d_model 128; the MoEs 8 experts top-2 in groups of 64,
the vlm 8 patches, the audio 2 encoder layers over 16 frames), the
reference's parameters carried across by `convert.params_from_reference`,
the same NumPy batches (labels with -100s, the stub frontends' float32
embeddings):

  * the loss and every gradient leaf of `make_grad_fn` against
    ``jax.value_and_grad(registry.loss_fn(cfg))`` (jitted once an arch,
    shared by the cases), with remat off and on (remat gives the same
    values bit for bit). Loss to 1e-5 relative; gradients per leaf to
    ``GRAD_TOL * max |g|``: 3e-4 under the MoEs' ``attn_4d`` (the
    reference's init takes the head count as the 3-D attention weights'
    fan-in, `tests/test_torch_train.py` says why), 1e-5 with flat weights.
    qwen2-moe runs with 6 real experts padded to 8: the two dummies get
    exactly zero expert gradient on both sides;
  * the MoE's router, gates and gathers under autograd: a (token, k)
    dropped at capacity gets exactly zero gate gradient, and the layer's
    vector-Jacobian product equals the reference's `jax.vjp` of
    `_moe_mlp`;
  * one `make_train_step` with ``n_micro=2`` on the reference
    `TokenStream`'s batch (its float32 frontends cut along the batch with
    the tokens) against the reference's jitted step: loss, gradient norm,
    parameters and moments as `tests/test_torch_train.py` holds them; the
    dummy experts take AdamW's decay as the reference's do;
  * the float32 frontend embeddings are cast to the config's dtype inside
    the model (bf16: the same loss as embeddings cast beforehand);
  * `launch.train.main` with ``--fail-at`` for the vlm (a frontend in
    every batch) ends bit for bit in the uninterrupted run's state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import StreamConfig as JStreamConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw

from test_torch_serve import frontends
from test_torch_train import _assert_trees, _named

ARCHS = ("olmoe_1b_7b", "qwen2_moe_a2_7b", "paligemma_3b", "whisper_small")
# qwen2-moe's 60 real experts padded to 64: reduced, 6 padded to 8
OVERRIDES = {"qwen2_moe_a2_7b": dict(n_experts=6, pad_experts_to=4)}
LOSS_TOL = 1e-5
GRAD_TOL = {True: 3e-4, False: 1e-5}   # by attn_4d
S = 24                                  # text tokens of the loss cases
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=20)
OPT_WD = tadamw.AdamWConfig().weight_decay


def _cfgs(name, **over):
    over = {**OVERRIDES.get(name, {}), **over}
    return (dataclasses.replace(jconfigs.get(name).reduced(), **over),
            dataclasses.replace(tconfigs.get(name).reduced(), **over))


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": toks, "labels": labels,
            **frontends(cfg, B, seed=seed + 1)}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(reference params as NumPy, batch, (loss, grads as NumPy)) of the
    reduced `name`: `jax.value_and_grad` jitted once."""
    cfg, _ = _cfgs(name)
    params = jreg.init(cfg, jax.random.PRNGKey(3))
    batch = _batch(cfg, 2, seed=4)
    vg = jax.jit(jax.value_and_grad(jreg.loss_fn(cfg), has_aux=True))
    (l, _), g = vg(params, batch)
    return (jax.tree.map(np.asarray, params), batch,
            (float(l), jax.tree.map(np.asarray, g)))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------ loss and gradients --
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name, remat):
    _, tcfg = _cfgs(name, remat=remat)
    params, batch, (l, g) = _reference(name)
    tparams = convert.params_from_reference(params, device="cpu")
    (tl_, taux), tg = tsteps.make_grad_fn(tcfg)(tparams, _tb(batch))
    assert abs(float(tl_) - l) <= LOSS_TOL * abs(l)
    assert float(taux["loss"]) == float(tl_)
    _assert_trees(tg, g, rel=GRAD_TOL[tcfg.attn_4d], what=f"{name} grad ")
    if tcfg.family == "vlm":   # the stub patches are an input, not a leaf
        assert "patch_embeds" not in _named(tg)
    if tcfg.padded_experts != tcfg.n_experts:
        E = tcfg.n_experts
        for k in ("we1", "we2", "we3"):
            assert not np.any(g["blocks"][k][:, E:])
            assert torch.count_nonzero(tg["blocks"][k][:, E:]) == 0
            assert torch.count_nonzero(tg["blocks"][k][:, :E]) > 0


def test_remat_gives_the_same_gradients_bit_for_bit():
    """Whisper's encoder and decoder blocks checkpointed (dict-valued
    layer parameters under `use_reentrant=False`): the same ops again."""
    params, batch, _ = _reference("whisper_small")
    outs = []
    for remat in (False, True):
        _, tcfg = _cfgs("whisper_small", remat=remat)
        tparams = convert.params_from_reference(params, device="cpu")
        outs.append(tsteps.make_grad_fn(tcfg)(tparams, _tb(batch)))
    assert float(outs[0][0][0]) == float(outs[1][0][0])
    _assert_trees(outs[1][1], outs[0][1], atol=0.0, what="remat ")
    enc = _named(outs[0][1])
    assert all(np.any(enc[k]) for k in enc if k.startswith("enc/"))


def test_dropped_pair_gets_zero_gate_gradient():
    """capacity_factor 0.25: experts fill and (token, k) pairs drop. The
    gates of the dropped pairs get exactly zero gradient, the kept ones
    not; the layer's VJP (in h and every weight) == the reference's."""
    cfg, tcfg = _cfgs("olmoe_1b_7b", capacity_factor=0.25)
    rng = np.random.default_rng(11)
    D, E, Fe = cfg.d_model, cfg.padded_experts, cfg.expert_d_ff
    lp = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
          for k, s in (("wr", (D, E)), ("we1", (E, D, Fe)),
                       ("we2", (E, Fe, D)), ("we3", (E, D, Fe)))}
    h = rng.standard_normal((2, 16, D)).astype(np.float32)
    ct = rng.standard_normal(h.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda h, lp: jmoe._moe_mlp(cfg, h, lp), h, lp)
    gh, glp = vjp(jnp.asarray(ct))

    seen = {}
    route = tmoe.route

    def spy(cfg, xg, wr):
        gates, idx = route(cfg, xg, wr)
        gates.retain_grad()
        seen["gates"], seen["idx"] = gates, idx
        return gates, idx

    th = torch.from_numpy(h).requires_grad_()
    tlp = {k: torch.from_numpy(v).requires_grad_() for k, v in lp.items()}
    tmoe.route = spy
    try:
        ty = tmoe._moe_mlp(tcfg, th, tlp)
    finally:
        tmoe.route = route
    (ty * torch.from_numpy(ct)).sum().backward()
    gates, idx = seen["gates"], seen["idx"]
    _, C, _, _ = tmoe.group_shape(tcfg, h.shape[0] * h.shape[1])
    _, keep = tmoe.slots(idx, E, C)
    keep = keep.reshape(gates.shape)
    assert 0 < int((~keep).sum()) < keep.numel()
    assert torch.count_nonzero(gates.grad[~keep]) == 0
    assert torch.count_nonzero(gates.grad[keep]) == int(keep.sum())
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh),
                               atol=1e-5 * float(np.abs(gh).max()))
    _assert_trees({k: v.grad for k, v in tlp.items()}, glp, rel=1e-5,
                  what="moe vjp ")


# --------------------------------------------------------------- train step --
@pytest.mark.parametrize("name", ["qwen2_moe_a2_7b", "whisper_small"])
def test_train_step_with_two_microbatches_matches_reference(name):
    """The reference TokenStream's batch (whisper's float32 enc_embeds cut
    along B with the tokens), n_micro 2: one step against the reference's
    jitted step. qwen2-moe's dummy experts get zero gradient and still
    decay: p * (1 - lr * weight_decay), on both sides."""
    cfg, tcfg = _cfgs(name)
    opt, topt = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    params = jreg.init(cfg, jax.random.PRNGKey(0))
    st = jadamw.init(opt, params)
    np_tree = jax.tree.map(np.asarray, (params, st))
    tp = convert.params_from_reference(np_tree[0], device="cpu")
    tst = convert.opt_state_from_reference(np_tree[1], device="cpu")
    stream = JTokenStream(JStreamConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=4, d_model=cfg.d_model,
        enc_frames=cfg.enc_frames if cfg.family == "audio" else 0))
    b = stream.batch(0)
    if cfg.family == "audio":
        assert b["enc_embeds"].dtype == np.float32
    params, st, m = jax.jit(jsteps.make_train_step(cfg, opt, n_micro=2))(
        params, st, b)
    tp, tst, tm = tsteps.make_train_step(tcfg, topt, n_micro=2)(
        tp, tst, _tb(b))
    assert sorted(tm) == sorted(m) == ["grad_norm", "loss", "lr"]
    assert float(tm["lr"]) == float(m["lr"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-4)
    _assert_trees(tp, params, atol=0.5 * float(m["lr"]), what="params ")
    _assert_trees(tst.m, st.m, rel=1e-3, what="m ")
    _assert_trees(tst.v, st.v, rel=1e-3, what="v ")
    if tcfg.padded_experts != tcfg.n_experts:
        E, lr = tcfg.n_experts, float(m["lr"])
        for k in ("we1", "we2", "we3"):
            old = np_tree[0]["blocks"][k][:, E:]
            got = tp["blocks"][k][:, E:].numpy()
            assert not np.any(tst.m["blocks"][k][:, E:].numpy())
            np.testing.assert_allclose(got, old * (1 - lr * OPT_WD),
                                       rtol=1e-6)
            np.testing.assert_allclose(got, np.asarray(params["blocks"][k])
                                       [:, E:], rtol=1e-6)


@pytest.mark.parametrize("name", ["paligemma_3b", "whisper_small"])
def test_frontend_embeddings_are_cast_inside_the_model(name):
    """bf16 parameters, the stream's float32 frontend: the loss equals the
    loss on embeddings cast to bf16 beforehand, bit for bit."""
    _, tcfg = _cfgs(name, dtype="bfloat16")
    params = treg.init(tcfg, seed=1, device="cpu")
    batch = _tb(_batch(tcfg, 2, seed=6))
    key = "patch_embeds" if tcfg.family == "vlm" else "enc_embeds"
    assert batch[key].dtype == torch.float32
    lf = treg.loss_fn(tcfg)
    cast = dict(batch, **{key: batch[key].to(torch.bfloat16)})
    assert float(lf(params, batch)[0]) == float(lf(params, cast)[0])


# ----------------------------------------------------------------- trainer --
def test_trainer_drill_resumes_the_vlm_bit_for_bit(tmp_path):
    """`launch.train.main` on paligemma-3b reduced with a failure at step
    2: one recovery from the step-1 checkpoint, then the uninterrupted
    run's final parameters and optimizer state bit for bit (the stream's
    patch embeddings are a pure function of the step)."""
    args = ["--arch", "paligemma_3b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt-every",
            "1"]
    (p1, o1), h1 = ttrain.main(args + ["--fail-at", "2", "--ckpt-dir",
                                       str(tmp_path / "drill")])
    (p2, o2), h2 = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "clean")])
    assert h1["recoveries"] == 1 and h2["recoveries"] == 0
    assert h1["steps"] == h2["steps"] == [0, 1, 2]
    a, b = ckpt._flatten((p1, o1)), ckpt._flatten((p2, o2))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    stream = ttrain.build("paligemma_3b", True, 4, 16, 2, 3, device="cpu")[4]
    assert stream.batch(0)["patch_embeds"].shape == (4, 8, 128)
