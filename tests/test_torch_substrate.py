"""The port's training substrate against the reference's, on the CPU: the
token stream, training-state and bfloat16 checkpoints, the specs and
seeded batches of `models.registry` and `launch.steps`.

  * `TokenStream` equals the reference's byte for byte at several steps,
    with and without the audio and VLM frontends' arrays; `to_device`
    keeps dtypes and values;
  * a training state ``(params, AdamWState)`` saved by either package
    restores into the other exactly (fp32 leaves, int32 count), with equal
    manifests (leaf names such as ``1/.m/blocks/w1``);
  * bfloat16 leaves: written as ``|V2`` with ``bfloat16`` in the manifest,
    as the reference writes them; they round-trip bit for bit in the port
    (NaN payloads, infinities and -0 included, through the async saver
    too), a reference-written bf16 training state restores into the port
    bit for bit (the reference's own restore raises on it), and casts into
    or out of bf16 are refused where lossy;
  * `param_specs`, `train_specs`, `prefill_specs`, `decode_specs` and
    `opt_state_specs` are meta tensors with the reference's shapes and
    dtypes; `make_train_batch` is seeded NumPy; `make_prefill_step` and
    `make_decode_step` run the model's prefill and decode.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import StreamConfig as JStreamConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.models import config as jconfig
from repro.models import registry as jreg
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import StreamConfig, TokenStream, to_device
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw

ARCH = "granite_3_8b"


def _bits(x):
    """A leaf's raw bytes and shape (bf16 compared by bit pattern)."""
    a = np.asarray(x.detach().cpu().view(torch.int16) if isinstance(
        x, torch.Tensor) and x.dtype == torch.bfloat16 else ckpt._host(x))
    return a.tobytes(), a.shape


def _assert_bits(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k
        assert getattr(fa[k], "dtype", None) == getattr(fb[k], "dtype", None)


# ------------------------------------------------------------------- stream --
@pytest.mark.parametrize("frontends", [dict(),
                                       dict(d_model=8, enc_frames=3),
                                       dict(d_model=8, n_patches=5)])
def test_stream_byte_identical_to_reference(frontends):
    kw = dict(vocab=1000, seq_len=16, global_batch=4, seed=7, **frontends)
    got, want = TokenStream(StreamConfig(**kw)), JTokenStream(
        JStreamConfig(**kw))
    for step in (0, 1, 5, 1000):
        g, w = got.batch(step), want.batch(step)
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == \
                w[k].tobytes(), (step, k)
    assert not np.array_equal(got.batch(5)["tokens"], got.batch(6)["tokens"])
    dev = to_device(got.batch(3), "cpu")
    assert dev["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(dev["tokens"].numpy(),
                                  got.batch(3)["tokens"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_device(got.batch(0))


# ------------------------------------------------------------- checkpoints --
def _ref_state(dtype="float32", moments="float32"):
    cfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype=dtype)
    opt = jadamw.AdamWConfig(moment_dtype=moments)
    params = jreg.init(cfg, jax.random.PRNGKey(0))
    st = jadamw.init(opt, params)
    # one update so that the moments and the count are not zeros
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, st, _ = jadamw.update(opt, grads, st, params)
    return params, st


def _port_state(ref):
    np_tree = jax.tree.map(np.asarray, ref)
    return (convert.params_from_reference(np_tree[0], device="cpu"),
            convert.opt_state_from_reference(np_tree[1], device="cpu"))


def test_training_state_crosses_between_the_packages(tmp_path):
    ref = _ref_state()
    port = _port_state(ref)
    jckpt.save(ref, 2, str(tmp_path / "ref"))
    ckpt.save(port, 2, str(tmp_path / "port"))
    manifests = [json.loads((tmp_path / d / "step_00000002" /
                             "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert "1/.m/blocks/w1" in manifests[0]["leaves"]
    assert manifests[0]["leaves"]["1/.count"] == {"shape": [],
                                                 "dtype": "int32"}
    # the port restores the reference's, the reference the port's
    zeros = ckpt._map(lambda _, x: torch.zeros_like(x), port)
    _assert_bits(ckpt.restore(zeros, 2, str(tmp_path / "ref")), port)
    back = jckpt.restore(ref, 2, str(tmp_path / "port"))
    for k, x in jckpt._flatten(back).items():
        np.testing.assert_array_equal(np.asarray(x),
                                      np.asarray(jckpt._flatten(ref)[k]),
                                      err_msg=k)
    assert isinstance(ckpt.restore(port, 2, str(tmp_path / "ref"))[1],
                      tadamw.AdamWState)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    bits = rng.integers(-2 ** 15, 2 ** 15, (64, 33)).astype(np.int16)
    bits[0, :5] = [0x7F80, -0x80, 0x7FC1, -0x8000, 0x0001]  # inf -inf NaN -0
    tree = {"w": torch.from_numpy(bits.copy()).view(torch.bfloat16),
            "s": torch.tensor(1.5, dtype=torch.bfloat16),
            "f": torch.arange(3, dtype=torch.float32)}
    path = ckpt.save(tree, 0, str(tmp_path))
    man = json.loads(open(f"{path}/manifest.json").read())
    assert man["leaves"]["w"] == {"shape": [64, 33], "dtype": "bfloat16"}
    with np.load(f"{path}/leaves.npz") as data:
        assert data["w"].dtype.str == "|V2"
        assert data["w"].view(np.int16).tobytes() == bits.tobytes()
    back = ckpt.restore(tree, 0, str(tmp_path))
    _assert_bits(back, tree)
    assert back["w"].dtype == torch.bfloat16
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(tree, 1)
    tree["w"].zero_()                 # the saver copied before returning
    saver.wait()
    assert ckpt.restore(tree, 1, str(tmp_path))["w"].view(
        torch.int16).numpy().tobytes() == bits.tobytes()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_bf16_checkpoint_restores_into_the_port(moments, tmp_path):
    """A bf16 training state written by the reference: the port restores
    it bit for bit; the reference's own restore cannot (``astype`` of
    ``|V2``)."""
    ref = _ref_state(dtype="bfloat16", moments=moments)
    jckpt.save(ref, 0, str(tmp_path))
    want = _port_state(ref)
    assert want[0]["embed"].dtype == torch.bfloat16
    zeros = ckpt._map(lambda _, x: torch.zeros_like(x), want)
    back = ckpt.restore(zeros, 0, str(tmp_path))
    _assert_bits(back, want)
    ckpt.save(back, 1, str(tmp_path))
    man = [json.loads((tmp_path / f"step_0000000{i}" /
                       "manifest.json").read_text()) for i in (0, 1)]
    assert man[0]["leaves"] == man[1]["leaves"]
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore(ref, 0, str(tmp_path))


def test_bf16_casts_are_lossless_or_refused(tmp_path):
    """fp32 saved into a bf16 template: cast where exact, else refused;
    bf16 bits into an fp32 template (tensor or numpy): widened
    exactly."""
    ckpt.save({"x": torch.tensor([1.5, -2.0, 0.25])}, 0, str(tmp_path))
    back = ckpt.restore({"x": torch.zeros(3, dtype=torch.bfloat16)}, 0,
                        str(tmp_path))
    assert back["x"].dtype == torch.bfloat16
    assert back["x"].tolist() == [1.5, -2.0, 0.25]
    ckpt.save({"x": torch.tensor([1.0 + 2 ** -12])}, 1, str(tmp_path))
    with pytest.raises(ValueError, match="lossy"):
        ckpt.restore({"x": torch.zeros(1, dtype=torch.bfloat16)}, 1,
                     str(tmp_path))
    ckpt.save({"x": torch.tensor([3.140625], dtype=torch.bfloat16)}, 2,
              str(tmp_path))
    for like in (torch.zeros(1), np.zeros(1, np.float32)):
        got = ckpt.restore({"x": like}, 2, str(tmp_path))["x"]
        assert type(got) is type(like)
        assert float(got[0]) == 3.140625
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"x": torch.zeros(2, dtype=torch.bfloat16)}, 2,
                     str(tmp_path))


# -------------------------------------------------------------------- specs --
def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _spec_shapes(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return (tuple(tree.shape), str(tree.dtype).split(".")[1])
    return (tuple(tree.shape), str(jnp.dtype(tree.dtype)))


@pytest.mark.parametrize("name", tconfigs.PORTED)
def test_specs_match_reference(name):
    cfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    assert _spec_shapes(treg.param_specs(tcfg)) == \
        _spec_shapes(jreg.param_sds(cfg))
    opt = dict(moment_dtype=cfg.opt_moment_dtype)
    assert _spec_shapes(tsteps.opt_state_specs(
        tcfg, tadamw.AdamWConfig(**opt))) == _spec_shapes(
        jsteps.opt_state_sds(cfg, jadamw.AdamWConfig(**opt)))
    for sname in tconfig.SHAPES:
        shape, jshape = tconfig.SHAPES[sname], jconfig.SHAPES[sname]
        assert _spec_shapes(treg.train_specs(tcfg, shape)) == \
            _spec_shapes(jreg.train_specs(cfg, jshape))
        for fn in ("prefill_specs", "decode_specs"):
            got = getattr(treg, fn)(tcfg, shape)
            want = getattr(jreg, fn)(cfg, jshape)
            assert [_spec_shapes(x) for x in got] == \
                [_spec_shapes(x) for x in want]


def test_make_train_batch_is_seeded_numpy():
    tcfg = tconfigs.get(ARCH).reduced()
    shape = tconfig.SHAPES["train_4k"]
    b = treg.make_train_batch(tcfg, shape, seed=5, global_batch=2,
                              device="cpu")
    assert sorted(b) == ["labels", "tokens"]
    assert b["tokens"].shape == (2, 4096) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["labels"], b["tokens"])
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < tcfg.vocab
    want = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 4096),
                                             dtype=np.int32)
    np.testing.assert_array_equal(b["tokens"].numpy(), want)
    vlm = dataclasses.replace(tcfg, family="vlm", n_patches=8)
    vb = treg.make_train_batch(vlm, shape, seed=5, global_batch=2,
                               device="cpu")
    assert vb["tokens"].shape == (2, 4088)
    assert vb["patch_embeds"].shape == (2, 8, tcfg.d_model)


def test_prefill_and_decode_steps_are_the_models():
    """`make_prefill_step` / `make_decode_step` run the family's prefill
    and decode: the same logits and cache as calling the model."""
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as ttr
    tcfg = tconfigs.get(ARCH).reduced()
    params = treg.init(tcfg, seed=0, device="cpu")
    toks = treg.make_prompts(tcfg, 2, 16, seed=1, device="cpu")
    got, want = [], []
    for fns, out in (((st.make_prefill_step(tcfg),
                       st.make_decode_step(tcfg)), got),
                     ((lambda p, b, c: ttr.prefill(tcfg, p, b, c),
                       lambda p, c, b: ttr.decode(tcfg, p, c, b)), want)):
        cache = ttr.init_cache(tcfg, 2, 32, device="cpu")
        cache, logits = fns[0](params, {"tokens": toks}, cache)
        cache, logits2 = fns[1](params, cache, {
            "tokens": logits.argmax(-1, keepdim=True)})
        out += [logits, logits2, cache["k_pages"], cache["seq_lens"]]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
