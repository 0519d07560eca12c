"""The port's training path against the reference's, on the CPU.

granite-3-8b `reduced()` (fp32, 2 layers, d_model 128) through both
packages on the same NumPy batches and the same parameters (the
reference's, carried across by `convert.params_from_reference`):

  * `transformer.loss` and its autograd gradients against the reference's
    `loss` and `jax.value_and_grad`, with remat on and off, `gqa_expand` on
    and off, `attn_4d` on and off, and a lowered `flash_min_seq` (the
    chunked branch: at 2048 tokens, two blocks a side, and with remat);
    `_block` with a window, and both attentions' vector-Jacobian products
    with and without one. Loss to 1e-5 relative. Gradients per leaf to
    ``GRAD_TOL * max |g|``: 3e-4 under ``attn_4d`` at 32 tokens (measured
    ~1e-4: the reference's init takes fan-in = shape[-2], the head count,
    for the 3-D attention weights, so |q|, |k| ~ 6-8, the scores reach ~45
    and the softmax amplifies fp32 rounding; at 2048 tokens it reaches
    4e-4 to 6e-4 on either attention branch, so the long case runs with
    flat weights), 1e-5 with flat weights (measured ~1e-6 at 32 and 2048
    tokens);
  * `cross_entropy` with -100 labels and a padded vocab, value and
    gradient; the masked scores get exactly zero gradient;
  * `make_train_step` with ``n_micro`` 1 and 2 against the reference's
    jitted step over 2 steps, and one step from a state carried across
    with `convert.opt_state_from_reference`. Adam's first steps are close
    to ``sign(g)``, so where a gradient is near its rounding noise the two
    packages may step in opposite directions: parameters are held to
    ``0.5 * sum(lr)`` absolute (measured 0.11), moments to 1e-3 of their
    largest element, loss and gradient norm to 1e-4 relative, lr and count
    exactly;
  * the fault-tolerant loop: the reference's own recovery test on the
    port, and the trainer with ``--fail-at`` against the reference's
    trainer: its printed history, and its final checkpoint restored into
    the port (a checkpoint crossing packages) against the port's final
    state (with flat attention weights; the test says why);
  * the device rule: the trainer runs on the card by default and raises
    here.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.runtime import fault as jfault
from repro.data.pipeline import StreamConfig as JStreamConfig
from repro.data.pipeline import TokenStream as JTokenStream

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tl
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import fault as tfault

ARCH = "granite_3_8b"
LOSS_TOL = 1e-5
GRAD_TOL = {True: 3e-4, False: 1e-5}   # by attn_4d
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=20)

CASES = {
    "base": ({}, 32),
    "remat": (dict(remat=True), 32),
    "no_gqa_expand": (dict(gqa_expand=False), 32),
    "flat": (dict(attn_4d=False), 32),
    "flat_no_expand_remat": (dict(attn_4d=False, gqa_expand=False,
                                  remat=True), 32),
    "flash": (dict(flash_min_seq=1024, attn_4d=False), 2048),
    "flash_remat": (dict(flash_min_seq=16, remat=True), 32),
}


def _cfgs(**over):
    return (dataclasses.replace(jconfigs.get(ARCH).reduced(), **over),
            dataclasses.replace(tconfigs.get(ARCH).reduced(), **over))


def _ref_params(cfg, seed=0):
    params = jreg.init(cfg, jax.random.PRNGKey(seed))
    return params, convert.params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def _named(tree, pre=""):
    """{path: numpy leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(
                v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
    return out


def _assert_trees(got, want, rel=None, atol=None, what=""):
    g, w = _named(got), _named(want)
    assert sorted(g) == sorted(w)
    for k in w:
        d = float(np.abs(g[k] - w[k]).max())
        lim = atol if atol is not None else rel * float(np.abs(w[k]).max())
        assert d <= lim, f"{what}{k}: max |diff| {d} > {lim}"


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = toks.copy()
    labels[0, :3] = -100
    return {"tokens": toks, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------ loss and gradients --
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(case):
    over, S = CASES[case]
    cfg, tcfg = _cfgs(**over)
    params, tparams = _ref_params(cfg)
    batch = _batch(cfg, 2 if S <= 32 else 1, S)
    (l, aux), g = jax.value_and_grad(jreg.loss_fn(cfg), has_aux=True)(
        params, batch)
    (tl_, taux), tg = tsteps.make_grad_fn(tcfg)(tparams, _tb(batch))
    assert abs(float(tl_) - float(l)) <= LOSS_TOL * abs(float(l))
    assert float(taux["loss"]) == float(tl_)
    assert not tl_.requires_grad
    _assert_trees(tg, g, rel=GRAD_TOL[tcfg.attn_4d], what=f"{case} grad ")


def test_remat_gives_the_same_loss_and_grads():
    """Checkpointing each block recomputes the same ops: bit for bit."""
    outs = []
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat)
        tparams = treg.init(tcfg, seed=0, device="cpu")
        outs.append(tsteps.make_grad_fn(tcfg)(
            tparams, _tb(_batch(tcfg, 2, 32))))
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert float(l0) == float(l1)
    for k, x in _named(g0).items():
        np.testing.assert_array_equal(x, _named(g1)[k], err_msg=k)


@pytest.mark.parametrize("window", [0, 8])
def test_block_with_window_matches_reference(window):
    """`_block` (the layer the scan runs) with and without a sliding
    window: output and its VJP against the reference's."""
    cfg, tcfg = _cfgs(attn_4d=False)
    params, tparams = _ref_params(cfg)
    rng = np.random.default_rng(3)
    B, S, D = 2, 32, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    lp = jax.tree.map(lambda w: w[0], params["blocks"])

    def jf(x, lp):
        return jtr._block(cfg, x, pos, lp, window=window)

    y, vjp = jax.vjp(jf, jnp.asarray(x), lp)
    gx, glp = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    tlp = {k: v[0].detach().clone().requires_grad_()
           for k, v in tparams["blocks"].items()}
    ty = ttr._block(tcfg, tx, torch.from_numpy(pos.copy()), tlp,
                    window=window)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=1e-5, rtol=1e-5)
    _assert_trees({k: v.grad for k, v in tlp.items()}, glp, rel=1e-5,
                  what="block grad ")


@pytest.mark.parametrize("kind", ["attention", "flash_attention"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_vjp_matches_reference(kind, window):
    """Both attentions (GQA, 2 query and 2 KV blocks for the chunked one)
    and their gradients in q, k, v against the reference's."""
    rng = np.random.default_rng(11)
    B, S, H, KVH, D = 2, 16, 4, 2, 8
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D)))
    kw = dict(causal=True, window=window)
    if kind == "flash_attention":
        kw.update(block_q=8, block_kv=8)
    jfn, tfn = getattr(jl, kind), getattr(tl, kind)
    y, vjp = jax.vjp(lambda *a: jfn(*a, **kw), q, k, v)
    want = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ty = tfn(*ts, **kw)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=1e-5)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_masked_scores_get_zero_gradient():
    """Under the causal mask the first query sees only the first key: the
    gradient of its output reaches no later key or value, exactly."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    for fn in (tl.attention, lambda *a, **kw: tl.flash_attention(
            *a, block_q=4, block_kv=4, **kw)):
        for t in (q, k, v):
            t.grad = None
        fn(q, k, v, causal=True)[:, 0].sum().backward()
        assert torch.count_nonzero(k.grad[:, 1:]) == 0
        assert torch.count_nonzero(v.grad[:, 1:]) == 0
        assert torch.count_nonzero(v.grad[:, 0]) > 0


# ------------------------------------------------------------ cross entropy --
def test_cross_entropy_matches_reference():
    """-100 labels masked, the padded vocab's columns at NEG_INF; value
    and gradient; all labels ignored -> 0 (the divisor clamps at 1)."""
    rng = np.random.default_rng(2)
    vocab, vp = 500, 512
    logits = rng.standard_normal((3, 7, vp)).astype(np.float32) * 4
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, 6] = -100

    def jf(x, lab):
        return jl.cross_entropy(jl.mask_padded_logits(x, vocab), lab)

    val, g = jax.value_and_grad(jf)(logits, labels)
    tx = torch.from_numpy(logits).requires_grad_()
    tv = tl.cross_entropy(tl.mask_padded_logits(tx, vocab),
                          torch.from_numpy(labels))
    tv.backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(val), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-7)
    assert torch.count_nonzero(tx.grad[..., vocab:]) == 0
    none = np.full_like(labels, -100)
    assert float(tl.cross_entropy(tx, torch.from_numpy(none))) == 0.0 == \
        float(jl.cross_entropy(jnp.asarray(logits), none))


# --------------------------------------------------------------- train step --
def _step_both(n_micro, steps=2, carried=False):
    cfg, tcfg = _cfgs()
    opt, topt = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    params = jreg.init(cfg, jax.random.PRNGKey(0))
    st = jadamw.init(opt, params)
    stream = JTokenStream(JStreamConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=4))
    f = jax.jit(jsteps.make_train_step(cfg, opt, n_micro=n_micro))
    tf = tsteps.make_train_step(tcfg, topt, n_micro=n_micro)
    tp = tst = None
    lrs = []
    for i in range(steps):
        if tp is None or (carried and i == steps - 1):
            np_tree = jax.tree.map(np.asarray, (params, st))
            tp = convert.params_from_reference(np_tree[0], device="cpu")
            tst = convert.opt_state_from_reference(np_tree[1], device="cpu")
            lrs = []
        b = stream.batch(i)
        params, st, m = f(params, st, b)
        tp, tst, tm = tf(tp, tst, _tb(b))
        assert sorted(tm) == sorted(m) == ["grad_norm", "loss", "lr"]
        assert float(tm["lr"]) == float(m["lr"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-4)
        lrs.append(float(m["lr"]))
    assert int(tst.count) == int(st.count) == steps
    assert tst.count.dtype == torch.int32
    _assert_trees(tp, params, atol=0.5 * sum(lrs), what="params ")
    _assert_trees(tst.m, st.m, rel=1e-3, what="m ")
    _assert_trees(tst.v, st.v, rel=1e-3, what="v ")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    _step_both(n_micro)


def test_state_carried_across_gives_the_references_next_step():
    """After one reference step, (params, AdamWState) carried across with
    `convert` give the reference's second step."""
    _step_both(2, steps=2, carried=True)


def test_train_step_accumulates_in_fp32(monkeypatch):
    """bf16 parameters, two microbatches: the gradients reach AdamW as the
    fp32 mean of the microbatches' bf16 gradients."""
    _, tcfg = _cfgs(dtype="bfloat16")
    params = treg.init(tcfg, seed=1, device="cpu")
    batch = treg.make_train_batch(tcfg, ShapeConfig("t", 16, 4, "train"),
                                  seed=2, device="cpu")
    seen = {}
    real = tadamw.update

    def spy(cfg, grads, state, p):
        seen["g"] = grads
        return real(cfg, grads, state, p)

    gf = tsteps.make_grad_fn(tcfg)
    halves = [gf(params, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    opt = tadamw.AdamWConfig(**OPT)
    monkeypatch.setattr(tadamw, "update", spy)
    new, st, m = tsteps.make_train_step(tcfg, opt, n_micro=2)(
        params, tadamw.init(opt, params), batch)
    assert {g.dtype for g in tadamw.tree_leaves(seen["g"])} == \
        {torch.float32}
    for name, g in _named(seen["g"]).items():
        a, b = (_named(h[1])[name] for h in halves)
        np.testing.assert_array_equal(g, (a + b) / 2, err_msg=name)
    assert float(m["loss"]) == float((halves[0][0][0]
                                      + halves[1][0][0]) / 2)
    assert new["embed"].dtype == torch.bfloat16


# ------------------------------------------------------ fault-tolerant loop --
def test_recovery_resumes_from_checkpoint(tmp_path):
    """The reference's own recovery test, on the port."""
    calls = []

    def step_fn(state, batch, step):
        calls.append(step)
        return {"x": state["x"] + 1}, {}

    injector = tfault.FailureInjector([7])
    cfg = tfault.TrainLoopConfig(total_steps=12, ckpt_every=3,
                                 ckpt_dir=str(tmp_path))
    state, hist = tfault.run_with_recovery(
        cfg, init_state={"x": torch.zeros(())}, step_fn=step_fn,
        make_batch=lambda s: None, injector=injector)
    assert hist["recoveries"] == 1
    # restored at step 6+1: steps 7..11 re-run; final x == completed steps
    assert float(state["x"]) == len(set(calls))
    assert sorted(set(calls)) == list(range(12))
    assert hist["steps"] == list(range(12))


def test_watchdog_flags_stragglers():
    wd = tfault.StepWatchdog(factor=3.0)
    for _ in range(6):
        wd.observe(0, 0.1)
    assert wd.observe(6, 1.0)
    assert not wd.observe(7, 0.12)


def test_loop_gives_up_after_max_failures(tmp_path):
    def step_fn(state, batch, step):
        raise RuntimeError("always")

    cfg = tfault.TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path),
                                 max_failures=2)
    with pytest.raises(RuntimeError, match="always"):
        tfault.run_with_recovery(cfg, init_state={"x": torch.zeros(())},
                                 step_fn=step_fn, make_batch=lambda s: None)


TRAIN_ARGS = ["--arch", ARCH, "--reduced", "--steps", "12", "--batch", "4",
              "--seq", "32", "--ckpt-every", "1", "--fail-at", "7"]


def _ref_trainer(ckpt_dir):
    """The reference's `train.main` for TRAIN_ARGS, its lines included,
    without the host mesh: under JAX 0.9 its `shard_batch` placement makes
    the jitted step raise ("Resource axis: data ... is not found in mesh",
    or with n_micro 2 "0th dimension of all xs should be replicated"), and
    the port's `to_device` has no mesh either. Returns (its lines, its
    final (params, opt_state), its history)."""
    cfg, params, opt_state, step_fn, stream = jtrain.build(
        ARCH, True, 4, 32, 2, 12)
    lines = [f"arch={cfg.name} params="
             f"{sum(np.prod(p.shape) for p in jax.tree.leaves(params)):,}"]

    def step(state, batch, step_idx):
        params, opt_state, metrics = step_fn(*state, batch)
        if step_idx % 5 == 0:
            lines.append(f"step {step_idx}: loss={float(metrics['loss']):.4f}"
                         f" gnorm={float(metrics['grad_norm']):.3f} "
                         f"lr={float(metrics['lr']):.2e}")
        return (params, opt_state), metrics

    state, hist = jfault.run_with_recovery(
        jfault.TrainLoopConfig(total_steps=12, ckpt_every=1,
                               ckpt_dir=ckpt_dir),
        init_state=(params, opt_state), step_fn=step,
        make_batch=stream.batch, injector=jfault.FailureInjector([7]),
        watchdog=jfault.StepWatchdog())
    lines.append(f"done: {len(hist['steps'])} steps, "
                 f"{hist['recoveries']} recoveries")
    return lines, state, hist


def test_trainer_with_fail_at_matches_reference(tmp_path, monkeypatch,
                                                capsys):
    """`--fail-at 7`: the port's trainer prints the reference's lines
    (numbers to 1e-4: losses are printed to 4 decimals), has its history,
    and ends in its state; the reference's final checkpoint (step 11)
    restores into the port.

    With flat attention weights: under the reduced config's ``attn_4d``
    the reference's init leaves gradients ~1e-4 apart (module docstring),
    and 12 Adam steps at lr up to 1e-3 grow that into a different run (the
    gradient norm 31.6 against 64.5 at step 10). With flat weights the
    runs agree: parameters to 0.01 of the summed lr (measured 4e-4 of it),
    moments to 1e-4 of their largest element (measured 2e-6)."""
    for mod in (jconfigs, tconfigs):
        monkeypatch.setattr(mod, "get", lambda name, get=mod.get: (
            dataclasses.replace(get(name), attn_4d=False)))
    want, (jp, jst), jhist = _ref_trainer(str(tmp_path / "ref"))
    cfg, _ = _cfgs(attn_4d=False)
    ref_params = jreg.init(cfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(treg, "init", lambda cfg, seed, device: (
        convert.params_from_reference(jax.tree.map(np.asarray, ref_params),
                                      device=device)))
    (tp, tst), hist = ttrain.main([*TRAIN_ARGS, "--device", "cpu",
                                   "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert hist == {**jhist, "stragglers": hist["stragglers"]}
    assert hist["steps"] == list(range(12)) and hist["recoveries"] == 1
    got = [ln for ln in out.splitlines()
           if ln.startswith(("arch=", "step ", "done:"))]
    assert len(got) == len(want) == 5
    assert got[0] == want[0]
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
    for a, b in zip(got[1:-1], want[1:-1]):
        assert num.sub("#", a) == num.sub("#", b)
        np.testing.assert_allclose([float(x) for x in num.findall(a)],
                                   [float(x) for x in num.findall(b)],
                                   rtol=1e-4, atol=1e-4)
    assert got[-1].startswith(want[-1])
    assert out.splitlines()[-1] == "latest checkpoint: step 11"
    ref_final = ckpt.restore((tp, tst), 11, str(tmp_path / "ref"))
    lrs = [float(jst_lr) for jst_lr in (jadamw.schedule(
        jadamw.AdamWConfig(**{**OPT, "total_steps": 12}), jnp.int32(c))
        for c in range(1, 13))]
    for final in (ref_final, (jp, jst)):
        _assert_trees(tp, final[0], atol=0.01 * sum(lrs), what="params ")
        _assert_trees(tst.m, final[1].m, rel=1e-4, what="m ")
        _assert_trees(tst.v, final[1].v, rel=1e-4, what="v ")
        assert int(final[1].count) == int(tst.count) == 12


def test_trainer_runs_on_the_card_by_default():
    """No GPU here: the trainer raises instead of falling back."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--reduced", "--steps", "1"])
