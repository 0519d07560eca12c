"""The port's optimizer and gradient compression against the reference's,
on the CPU.

  * `adamw.schedule` at counts 0, 1, warmup, mid-decay, total and past it:
    equal to the reference's fp32 value (exactly);
  * one `adamw.update` with and without clipping, fp32 and bf16 moments,
    on a tree with 3-D weights, layer-stacked norms ``[L, D]`` and a final
    norm ``[D]``: metrics equal, moments to 1e-6 of their largest element
    (bf16 moments: within one bf16 rounding, 2^-8 relative), parameters to
    1e-3 of lr absolute (a gradient whose normalized step sits on a rounding
    boundary may move by one fp32 ulp of the step);
  * the decay quirk: every leaf with two or more axes is decayed, the
    stacked norms included, ``ln_f`` not;
  * the reference's own optimizer tests, on the port;
  * `compression`: quantize / dequantize / quantization_error /
    ef_compress equal the reference's bit for bit (int8 values, scales,
    residuals), and `compressed_psum` on a one-process mesh within
    tests/test_substrate.py's bound of its input (4 processes:
    tests/test_torch_mesh_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp

from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

L, D = 3, 16


def _tree(rng, scale=1.0):
    return {"blocks": {"ln1": rng.standard_normal((L, D)),
                       "wq": rng.standard_normal((L, D, 2, 4)),
                       "w1": rng.standard_normal((L, D, 8))},
            "embed": rng.standard_normal((10, D)),
            "ln_f": rng.standard_normal((D,))}


def _f32(tree, scale=1.0):
    return jax.tree.map(lambda a: (a * scale).astype(np.float32), tree)


def _t(tree, dtype=torch.float32):
    return tadamw.tree_map(lambda a: torch.from_numpy(np.asarray(
        a, np.float32)).to(dtype), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, np.float32)


def _flat(tree, pre=""):
    out = {}
    for k, v in _np(tree).items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _close(got, want, rel=None, atol=None):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        lim = atol if atol is not None else rel * np.abs(w[k]).max()
        d = np.abs(g[k] - w[k]).max()
        assert d <= lim, (k, d, lim)


@pytest.mark.parametrize("count", [0, 1, 10, 55, 100, 150])
def test_schedule_matches_reference(count):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = tadamw.schedule(tadamw.AdamWConfig(**kw),
                          torch.tensor(count, dtype=torch.int32))
    want = jadamw.schedule(jadamw.AdamWConfig(**kw), jnp.int32(count))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e6, 1.0])
def test_update_matches_reference(moments, clip):
    rng = np.random.default_rng(0)
    params, grads = _f32(_tree(rng)), _f32(_tree(rng), 0.3)
    m0, v0 = _f32(_tree(rng), 0.01), _f32(_tree(rng), 1e-3)
    v0 = jax.tree.map(np.abs, v0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip,
              moment_dtype=moments)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    mdt = jnp.dtype(moments)
    jst = jadamw.AdamWState(jnp.int32(3), jax.tree.map(
        lambda a: jnp.asarray(a, mdt), m0), jax.tree.map(
        lambda a: jnp.asarray(a, mdt), v0))
    tmd = getattr(torch, moments)
    tst = tadamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                            _t(m0, tmd), _t(v0, tmd))
    jp, jst2, jm = jadamw.update(jcfg, grads, jst, params)
    tp, tst2, tm = tadamw.update(tcfg, _t(grads), tst, _t(params))
    assert int(tst2.count) == int(jst2.count) == 4
    assert float(tm["lr"]) == float(jm["lr"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert (float(jm["grad_norm"]) > clip) == (clip == 1.0)
    assert {x.dtype for x in tadamw.tree_leaves(tst2.m)
            + tadamw.tree_leaves(tst2.v)} == {tmd}
    rel = 1e-6 if moments == "float32" else 2.0 ** -8
    _close(tst2.m, jst2.m, rel=rel)
    _close(tst2.v, jst2.v, rel=rel)
    _close(tp, jp, atol=1e-3 * 1e-2)


def test_weight_decay_reaches_every_leaf_with_two_axes():
    """Zero gradients: Adam's step is 0, so each parameter moves by
    lr * weight_decay * p exactly where it has two or more axes: the
    layer-stacked norms [L, D] are decayed, ln_f [D] is not (the
    reference's `p.ndim >= 2`)."""
    rng = np.random.default_rng(1)
    params = _f32(_tree(rng))
    zeros = jax.tree.map(np.zeros_like, params)
    kw = dict(lr=0.5, warmup_steps=0, total_steps=10, weight_decay=0.1)
    tcfg = tadamw.AdamWConfig(**kw)
    tp, _, m = tadamw.update(tcfg, _t(zeros), tadamw.init(tcfg, _t(params)),
                             _t(params))
    jp, _, _ = jadamw.update(jadamw.AdamWConfig(**kw), zeros,
                             jadamw.init(jadamw.AdamWConfig(**kw), params),
                             params)
    lr = float(m["lr"])
    got, want = _flat(tp), _flat(params)
    for k in want:
        moved = not np.array_equal(got[k], want[k])
        assert moved == (k != "ln_f"), k
        if moved:
            np.testing.assert_allclose(got[k], want[k] * (1 - lr * 0.1),
                                       rtol=1e-6)
    _close(tp, jp, atol=0.0)


def test_adamw_decreases_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                             weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = tadamw.init(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}  # d/dw ||w||^2
        params, state, m = tadamw.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_clipping_and_schedule():
    cfg = tadamw.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=10,
                             total_steps=100)
    params = {"w": torch.zeros(4)}
    state = tadamw.init(cfg, params)
    big = {"w": torch.full((4,), 1e6)}
    params, state, m = tadamw.update(cfg, big, state, params)
    assert float(m["grad_norm"]) > 1e5
    assert float(m["lr"]) == pytest.approx(0.1, rel=1e-3)  # warmup 1/10
    assert bool(torch.isfinite(params["w"]).all())


def test_adamw_bf16_moments():
    cfg = tadamw.AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((8, 8))}
    state = tadamw.init(cfg, params)
    assert state.m["w"].dtype == torch.bfloat16
    assert state.count.dtype == torch.int32 and state.count.dim() == 0
    params, state, _ = tadamw.update(cfg, {"w": torch.ones((8, 8))}, state,
                                     params)
    assert state.v["w"].dtype == torch.bfloat16
    assert params["w"].dtype == torch.float32


# -------------------------------------------------------------- compression --
@pytest.mark.parametrize("n,scale", [(300, 1.0), (256, 1e-3), (1000, 1e3),
                                     (7, 1.0)])
def test_quantize_matches_reference_bit_for_bit(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    if n == 1000:
        x[256:512] = 0.0                 # an all-zero block: scale 1e-12
        x = x.reshape(10, 100)
    q, s, m = tcomp.quantize(torch.from_numpy(x))
    jq, js, jm = jcomp.quantize(jnp.asarray(x))
    assert m == jm and q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = tcomp.dequantize(q, s, m, x.shape)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jcomp.dequantize(jq, js, jm, x.shape)))
    np.testing.assert_array_equal(
        tcomp.quantization_error(torch.from_numpy(x)).numpy(),
        np.asarray(jcomp.quantization_error(jnp.asarray(x))))
    # the reference's error bound
    assert np.abs(x - y.numpy()).max() <= np.abs(x).max() / 127.0 + 1e-6


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(4)
    grads = {"a": (rng.standard_normal((3, 100)) * 0.1).astype(np.float32),
             "b": {"c": np.array([1e-9, 1.0, -1.0, 0.5], np.float32)}}
    tef = tcomp.ef_init(_t(grads))
    jef = jcomp.ef_init(grads)
    for i in range(3):
        tsent, tef = tcomp.ef_compress(tef, _t(grads))
        jsent, jef = jcomp.ef_compress(jef, grads)
        _close(tsent, jsent, atol=0.0)
        _close(tef.residual, jef.residual, atol=0.0)
        if i == 0:   # the residual carries the quantization error
            np.testing.assert_allclose(
                (tsent["b"]["c"] + tef.residual["b"]["c"]).numpy(),
                grads["b"]["c"], rtol=1e-6)


def test_compressed_psum_on_a_one_process_mesh():
    """The reference's test_compressed_psum_matches_fp32 on the port: one
    participant, so the sum is its own dequantized input, held to that
    test's bound; the payloads are this process's quantization."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import free_port
    x = torch.from_numpy(np.random.RandomState(0).randn(256).astype(
        np.float32))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        y = tcomp.compressed_psum(x, "data", mesh)
        qs, scales, n = tcomp.gather_quantized(x, "data", mesh)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=0.1, rtol=0.02)
    q, s, n1 = tcomp.quantize(x)
    assert n == n1 and torch.equal(qs[0], q) and torch.equal(scales[0], s)
    assert torch.equal(y, tcomp.dequantize(q, s, n, x.shape))
