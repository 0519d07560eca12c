"""The port's paged-KV serving path against the reference's, on the CPU.

Held on the same NumPy inputs and the same parameters (the reference's,
carried across by `convert.params_from_reference`):

  * every ported `models.layers` function (fp32 to 1e-5, bf16 to 2e-2:
    sums in another order; bf16 outputs rounded once);
  * granite-3-8b **reduced** (fp32, 2 layers, page 16): prefill + 4 decode
    steps in three attention settings, and the other dense configs
    reduced (squared-ReLU, flat weights); logits to 1e-4 * max|logit| + 1e-5
    (two layers of fp32 matmuls and softmaxes summed in another order),
    K/V pages to 1e-5 * max|K/V| (|K| and |V| reach ~30, because the
    reference's init takes fan-in = shape[-2] = KVH for wk / wv, so one
    fp32 ulp there is ~2e-6), greedy tokens and seq_lens exact;
  * `PagePool` / `HeapClient` against the reference's: at the default
    kind (``sw`` on both sides) and as ``fused`` against ``pallas``: page
    ids, responses (latencies included), stats, telemetry and `gc`
    exact; the two kinds' page ids against each other;
  * `serve` end to end against the reference's `serve.main` steps replayed
    here: tokens, page ids and pool stats exact;
  * `_prefill_decode_both` and `_reference_serve` take any family (the
    moe, vlm and audio families use them in tests/test_torch_families.py,
    with their stub frontends' embeddings, the recurrent ones in
    tests/test_torch_recurrent.py, whose caches have no page table);
  * every arch of the reference resolves in the port with equal fields,
    and `all_configs` matches;
  * the device rule: the entry points default to the card and raise here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kvcache import paged as jpaged
from repro.models import config as jconfig
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.kvcache import paged as tpaged
from repro_torch.launch import serve as tserve
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tl
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr

F32 = 1e-5
BF16 = 2e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# --------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", tconfigs.PORTED)
def test_dense_configs_match_reference(name):
    got, want = tconfigs.get(name), jconfigs.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.padded_vocab == want.padded_vocab
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_every_arch_resolves_like_the_reference(name):
    """Every arch of the reference resolves in the port, by its id with
    underscores or dashes, with equal fields, to the module of its
    family."""
    got = tconfigs.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfigs.get(name))
    assert tconfigs.get(name.replace("_", "-")) is got
    assert treg.get_module(got).__name__.split(".")[-1] == \
        jreg.get_module(jconfigs.get(name)).__name__.split(".")[-1]


def test_all_configs_match_reference():
    got, want = tconfigs.all_configs(), jconfigs.all_configs()
    assert list(got) == list(want) == list(tconfigs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get("llama_7b")


# ---------------------------------------------------------------- layers --
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
def test_rms_norm_and_rope_match_reference(dtype, tol):
    rng = np.random.default_rng(0)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x, scale = _rand(rng, 2, 7, 4, 32), _rand(rng, 32)
    _close(tl.rms_norm(_t(x, dtype), _t(scale, dtype)),
           jl.rms_norm(_j(x, jdt), _j(scale, jdt)), tol)
    pos = rng.integers(0, 1000, size=(2, 7))
    _close(tl.rope(_t(x, dtype), torch.from_numpy(pos), 10_000.0),
           jl.rope(_j(x, jdt), jnp.asarray(pos), 10_000.0), tol)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (True, 5, 0),
                                                    (False, 0, 0),
                                                    (True, 0, 3)])
def test_attention_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 9, 8, 32), _rand(rng, 2, 12, 2, 32), \
        _rand(rng, 2, 12, 2, 32)
    _close(tl.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        q_offset=q_offset),
           jl.attention(_j(q), _j(k), _j(v), causal=causal, window=window,
                        q_offset=q_offset), F32)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_attention_matches_reference(causal, window):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 64, 4, 32), _rand(rng, 2, 64, 1, 32), \
        _rand(rng, 2, 64, 1, 32)
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, block_q=16, block_kv=32)
    _close(got, jl.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                   window=window, block_q=16, block_kv=32),
           F32)
    _close(got, tl.attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window).numpy(), F32)
    assert tl.pick_attention(64, 64, 8193) is tl.attention
    assert tl.pick_attention(64, 8193, 8193) is tl.flash_attention


@pytest.mark.parametrize("attn_4d", [False, True])
def test_projections_match_reference(attn_4d):
    rng = np.random.default_rng(3)
    D, H, hd = 48, 4, 16
    h = _rand(rng, 2, 3, D)
    wq = _rand(rng, D, H, hd) if attn_4d else _rand(rng, D, H * hd)
    wo = _rand(rng, H, hd, D) if attn_4d else _rand(rng, H * hd, D)
    q = tl.qk_proj(_t(h), _t(wq), H, hd)
    _close(q, jl.qk_proj(_j(h), _j(wq), H, hd), F32)
    _close(tl.out_proj(q, _t(wo)),
           jl.out_proj(_j(q.numpy()), _j(wo)), F32)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
def test_mlp_matches_reference(kind, dtype, tol):
    rng = np.random.default_rng(4)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x = _rand(rng, 2, 3, 32) * 0.5
    w1, w2, w3 = _rand(rng, 32, 64) / 6, _rand(rng, 64, 32) / 8, \
        _rand(rng, 32, 64) / 6
    _close(tl.mlp(_t(x, dtype), _t(w1, dtype), _t(w2, dtype), _t(w3, dtype),
                  kind),
           jl.mlp(_j(x, jdt), _j(w1, jdt), _j(w2, jdt), _j(w3, jdt), kind),
           tol)
    assert tl.mlp_n_mats(kind) == jl.mlp_n_mats(kind)


def test_mask_padded_logits_and_init_rule():
    rng = np.random.default_rng(5)
    lg = _rand(rng, 2, 16)
    _close(tl.mask_padded_logits(_t(lg), 11),
           jl.mask_padded_logits(_j(lg), 11), 0)
    assert torch.equal(tl.mask_padded_logits(_t(lg), 16), _t(lg))
    cfg = jconfigs.get("granite_3_8b").reduced()
    shapes = ttr.param_shapes(cfg)
    want = jtr.param_shapes(cfg)
    assert shapes == want  # same names, nesting, shapes and dtype names
    p = ttr.init(cfg, seed=0, device="cpu")
    assert not p["blocks"]["ln1"].any() and not p["ln_f"].any()
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    wq = p["blocks"]["wq"]  # [L, D, H, hd]: the reference's fan-in, shape[-2]
    assert abs(float(wq.std()) - wq.shape[-2] ** -0.5) < 0.02
    again = ttr.init(cfg, seed=0, device="cpu")
    assert torch.equal(p["head"], again["head"])


# ------------------------------------------------- granite reduced decode --
B, S, STEPS = 2, 16, 4
SETTINGS = {
    # the reference's default: its decode takes write_attend_seqpar, which
    # without a mesh falls back to the plain gather whatever attend_impl
    # says; the port's decode reaches its kernel route
    "seqpar_fallback": dict(kv_seq_parallel=True, attend_impl="kernel"),
    "kernel": dict(kv_seq_parallel=False, attend_impl="kernel"),
    "ref": dict(kv_seq_parallel=False, attend_impl="ref"),
}


def _ref_params(cfg, seed=0, jit=False):
    init = jax.jit(jreg.init, static_argnums=0) if jit else jreg.init
    params = init(cfg, jax.random.PRNGKey(seed))
    return params, convert.params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


def frontends(cfg, batch, seed=8):
    """The stub frontends' embeddings (vlm patches, audio frames) as
    NumPy fp32 from `seed`, shaped as the registry shapes them."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shp).astype(np.float32)
            for k, (shp, _) in treg._frontend(cfg, batch).items()}


def prefix_len(cfg):
    """Positions before the text: the vlm's patch prefix."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _prefill_decode_both(name, prompt=S, jit=False, **overrides):
    """Prefill + STEPS greedy decode steps of `name` reduced through both
    packages (its family's module on each side, the stub frontends from a
    NumPy seed), with the reference's parameters; asserts at every
    step. The text prompt is `prompt` tokens, more where they (after the
    vlm's patch prefix) do not fill whole pages. The page table is set
    where the family's cache has one. With `jit` the reference's init,
    prefill and decode run jitted (as its serve runs them)."""
    cfg = dataclasses.replace(jconfigs.get(name).reduced(), **overrides)
    tcfg = dataclasses.replace(tconfigs.get(name).reduced(), **overrides)
    jmod, tmod = jreg.get_module(cfg), treg.get_module(tcfg)
    jparams, tparams = _ref_params(cfg, jit=jit)
    jprefill, jdecode = jmod.prefill, jmod.decode
    if jit:
        jprefill = jax.jit(jprefill, static_argnums=0)
        jdecode = jax.jit(jdecode, static_argnums=0)
    prefix = prefix_len(cfg)
    St = prompt + (-(prefix + prompt)) % cfg.page_size
    max_seq = prefix + St + STEPS + cfg.page_size
    P = jpaged.pages_per_seq(max_seq, cfg.page_size)
    pt = np.stack([(np.arange(P) + b + 1) % P for b in range(B)]).astype(
        np.int32)  # rotated extents, as serving hands them out
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, St))
    front = frontends(cfg, B)

    jspec = jmod.cache_spec(cfg, B, max_seq)
    assert {k: v[0] for k, v in tmod.cache_spec(tcfg, B, max_seq).items()} \
        == {k: v.shape for k, v in jspec.items()}
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspec)
    tcache = tmod.init_cache(tcfg, B, max_seq, device="cpu")
    if "page_table" in jspec:
        jcache["page_table"] = jnp.asarray(pt)
        tcache["page_table"] = torch.from_numpy(pt)

    jcache, jlog = jprefill(
        cfg, jparams, {"tokens": jnp.asarray(toks),
                       **{k: jnp.asarray(v) for k, v in front.items()}},
        jcache)
    tcache, tlog = tmod.prefill(
        tcfg, tparams, {"tokens": torch.from_numpy(toks),
                        **{k: torch.from_numpy(v) for k, v in front.items()}},
        tcache)
    for step in range(STEPS + 1):
        want = np.asarray(jlog)
        tol = 1e-4 * np.abs(want[:, :cfg.vocab]).max() + 1e-5
        np.testing.assert_allclose(tlog.numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"{name} step {step}")
        jtok = jnp.argmax(jlog, axis=-1)[:, None]
        ttok = torch.argmax(tlog, dim=-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        if step < STEPS:
            jcache, jlog = jdecode(cfg, jparams, jcache, {"tokens": jtok})
            tcache, tlog = tmod.decode(tcfg, tparams, tcache,
                                       {"tokens": ttok})
    assert set(tcache) == set(jcache)
    for key in sorted(set(jcache) - {"page_table", "seq_lens"}):
        want = np.asarray(jcache[key])
        np.testing.assert_allclose(tcache[key].numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=key)
    np.testing.assert_array_equal(tcache["seq_lens"].numpy(),
                                  np.asarray(jcache["seq_lens"]))
    assert int(tcache["seq_lens"][0]) == prefix + St + STEPS


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_granite_reduced_prefill_decode_matches_reference(setting):
    _prefill_decode_both("granite_3_8b", **SETTINGS[setting])


@pytest.mark.parametrize("name,overrides", [
    ("nemotron_4_340b", {}),                     # squared-ReLU, two mats
    ("stablelm_12b", {"attn_4d": False}),        # flat attention weights
    ("mistral_large_123b", SETTINGS["kernel"]),
])
def test_dense_reduced_prefill_decode_matches_reference(name, overrides):
    _prefill_decode_both(name, **overrides)


def test_decode_writes_the_cache_in_place():
    cfg = tconfigs.get("granite_3_8b").reduced()
    params = ttr.init(cfg, seed=1, device="cpu")
    cache = ttr.init_cache(cfg, B, 48, device="cpu")
    kp = cache["k_pages"]
    cache, _ = ttr.prefill(cfg, params, {"tokens": torch.zeros(
        (B, 16), dtype=torch.long)}, cache)
    cache, _ = ttr.decode(cfg, params, cache, {"tokens": torch.zeros(
        (B, 1), dtype=torch.long)})
    assert cache["k_pages"] is kp and kp[:, :, 1, 0].any()


# ------------------------------------------------------ PagePool / client --
def _script(pool, np_):
    """One serving-shaped sequence of pool calls; returns every page-id
    result and every round's response as NumPy."""
    out = []

    def info():
        out.append({f: np_(getattr(pool.client.last_info, f))
                    for f in pool.client.last_info._fields})

    exts = []
    for n, th in ((6, 0), (6, 1), (40, 2), (300, 3), (1 << 17, 4)):
        ids = np_(pool.alloc_pages(n, thread=th))  # 96 B .. 2 MiB (OOM)
        exts.append(ids)
        out.append(ids)
        info()
    need = np.zeros(16, bool)
    need[[0, 2, 3, 9]] = True
    ids, resp = pool.alloc_page_batch(need)
    out += [np_(ids), {f: np_(x) for f, x in zip(resp._fields, resp)}]
    pages = np.where(need, np_(ids), -1).astype(np.int32)
    pages[5] = (1 << 16) + 5  # a page past the pool: a dropped free
    resp = pool.free_page_batch(pages)
    out.append({f: np_(x) for f, x in zip(resp._fields, resp)})
    grown, moved = pool.grow_extent(int(exts[0][0]), 12, thread=0)
    out += [np_(grown), moved]
    info()
    out.append(pool.evict(int(exts[2][0]), [int(exts[1][0]), -1],
                          thread=2))
    out.append(pool.stats)
    pool.gc()  # merges fully free blocks back; live bytes unchanged
    out += [pool.stats, pool.client.telemetry()]
    return out


def _assert_same(got, want, path="script"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_page_pool_matches_reference_pallas_and_sw():
    n_pages = 1 << 16  # the serve path's pool: a 1 MiB heap
    jpool, tpool = jpaged.PagePool(n_pages), tpaged.PagePool(n_pages,
                                                             device="cpu")
    assert tpool.client.kind == jpool.client.kind == "sw"
    got, want = _script(tpool, _np), _script(jpool, np.asarray)
    fused = _script(tpaged.PagePool(n_pages, kind="fused", device="cpu"),
                    _np)
    pallas = _script(jpaged.PagePool(n_pages, kind="pallas"), np.asarray)
    for g_all, w_all in ((got, want), (fused, pallas)):
        assert len(g_all) == len(w_all)
        for i, (g, w) in enumerate(zip(g_all, w_all)):
            _assert_same(g, w, f"call {i}")
    # the two kinds hand out the same pages
    for i in (0, 2, 4, 6, 8, 10, 13):
        np.testing.assert_array_equal(got[i], fused[i], err_msg=f"call {i}")
    stats = got[-3]
    assert stats["front_hits"] > 0 and stats["fails"] == 1
    assert stats["dropped_frees"] == 1
    assert got[-2]["gc_blocks"] > 0


def test_heap_client_matches_reference():
    """At the default kind, the reference's ``sw`` on both sides."""
    from repro.core import api as japi
    jc = japi.HeapClient(heap_bytes=1 << 20)
    tc = tapi.HeapClient(heap_bytes=1 << 20, device="cpu")
    _client_script(jc, tc)
    assert (tc.kind, tc.num_threads, tc.heap_bytes) == \
        ("sw", jc.num_threads, jc.heap_bytes)


def test_heap_client_fused_matches_reference_pallas():
    from repro.core import api as japi
    jc = japi.HeapClient(heap_bytes=1 << 20, kind="pallas")
    tc = tapi.HeapClient(heap_bytes=1 << 20, kind="fused", device="cpu")
    _client_script(jc, tc)
    assert tc.kind == "fused"


def _client_script(jc, tc):
    """Every call's result, the stats, the telemetry, then `gc` and the
    state it leaves, the reference's client `jc` against the port's
    `tc`."""
    assert jc.malloc(100, thread=3) == tc.malloc(100, thread=3)
    p = jc.calloc(4, 300, thread=1)
    assert p == tc.calloc(4, 300, thread=1)
    assert jc.realloc(p, 9000, thread=1) == tc.realloc(p, 9000, thread=1)
    jc.free(p, thread=2)
    tc.free(p, thread=2)
    sizes = np.arange(16, dtype=np.int32) * 40
    np.testing.assert_array_equal(
        tc.malloc_batch(sizes).ptr.numpy(),
        np.asarray(jc.malloc_batch(jnp.asarray(sizes)).ptr))
    ptrs = np.array(jc.last_info.ptr)
    jr = jc.realloc_batch(jnp.asarray(ptrs), jnp.asarray(sizes * 3))
    tr = tc.realloc_batch(ptrs, sizes * 3)
    jf = jc.calloc_batch(jnp.full(16, 3), jnp.asarray(sizes))
    tf = tc.calloc_batch(np.full(16, 3), sizes)
    jx = jc.free_batch(jr.ptr)
    tx = tc.free_batch(tr.ptr)
    for g, w in ((tr, jr), (tf, jf), (tx, jx)):
        for f in g._fields:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)), f)
    je, te = jc.epoch_reset(), tc.epoch_reset()
    for f in te._fields:
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), f)
    assert tc.stats == jc.stats
    assert tc.telemetry() == jc.telemetry()
    jc.gc()
    tc.gc()
    assert tc.stats == jc.stats and tc.stats["gc_blocks"] > 0
    assert tc.telemetry() == jc.telemetry()
    for a, b in zip(convert.leaves(tc.state), jax.tree.leaves(jc.state)):
        np.testing.assert_array_equal(a.numpy()[0], np.asarray(b))


# ------------------------------------------------------------ serve e2e --
def _reference_serve(cfg, params, toks, decode_steps, front=None):
    """The reference's `serve.main` steps (single PagePool, kind sw), with
    the given parameters, text prompt and stub frontends' embeddings
    (`frontends`); returns (tokens, page ids, stats). Its cache holds
    S + decode_steps + page positions, without the vlm's patch prefix."""
    mod = jreg.get_module(cfg)
    B, S = toks.shape
    max_seq = S + decode_steps + cfg.page_size
    P = jpaged.pages_per_seq(max_seq, cfg.page_size)
    n_pages = max(1 << (B * P - 1).bit_length(), 1 << 16)
    pool = jpaged.PagePool(n_pages=n_pages)
    rows = [pool.alloc_pages(P, thread=b % pool.cfg.num_threads)
            for b in range(B)]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         mod.cache_spec(cfg, B, max_seq))
    if "page_table" in cache:
        cache["page_table"] = jnp.stack(rows) % P
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in (front or {}).items()}}
    pad = (-(S + prefix_len(cfg))) % cfg.page_size
    if pad:
        batch["tokens"] = jnp.pad(batch["tokens"], ((0, 0), (0, pad)))
    prefill = jax.jit(lambda p, b, c: mod.prefill(cfg, p, b, c))
    decode = jax.jit(lambda p, c, b: mod.decode(cfg, p, c, b))
    cache, logits = prefill(params, batch, cache)
    toks_out = [jnp.argmax(logits, axis=-1)[:, None]]
    for _ in range(decode_steps):
        pos = np.asarray(cache["seq_lens"])
        need = (pos % cfg.page_size) == 0
        if need.any():
            pool.alloc_page_batch(np.pad(need, (0, pool.cfg.num_threads - B)))
        cache, logits = decode(params, cache, {"tokens": toks_out[-1]})
        toks_out.append(jnp.argmax(logits, axis=-1)[:, None])
    return (np.asarray(jnp.concatenate(toks_out, axis=1)),
            np.asarray(jnp.stack(rows)), pool.stats)


def test_serve_matches_reference_end_to_end():
    """batch 2, prompt 16, 8 decode steps: the first step crosses a page
    boundary (page 16), so the frontend serves decode-time pages."""
    cfg = dataclasses.replace(jconfigs.get("granite_3_8b").reduced(),
                              attend_impl="kernel")
    jparams, tparams = _ref_params(cfg, seed=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16))
    want_toks, want_pages, want_stats = _reference_serve(cfg, jparams, toks,
                                                         8)
    res = tserve.serve(tconfigs.get("granite_3_8b").reduced(), batch=2,
                       prompt_len=16, decode_steps=8, impl="kernel",
                       device="cpu", params=tparams,
                       tokens=torch.from_numpy(toks))
    np.testing.assert_array_equal(res.tokens.numpy(), want_toks)
    np.testing.assert_array_equal(res.page_ids.numpy(), want_pages)
    assert res.stats == want_stats
    assert res.page_allocs == 2 and res.pool_rounds == 3
    assert res.stats["front_hits"] > 0 and res.stats["fails"] == 0
    assert res.tokens.shape == (2, 9)


def test_serve_main_runs_on_the_cpu_and_refuses_a_fleet():
    """`main` serves on the CPU; a batch beyond the single pool's threads,
    or beyond the fleet's, is refused."""
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "20", "--decode-steps", "3", "--impl", "ref"])
    assert res.prompt.shape == (2, 32)  # padded to whole pages
    assert torch.isfinite(res.logits).all() and res.fleet_stats is None
    with pytest.raises(ValueError, match="single pool's 16"):
        tserve.main(["--device", "cpu", "--batch", "17"])
    with pytest.raises(ValueError, match="fleet's 32"):
        tserve.main(["--device", "cpu", "--fleet-ranks", "2", "--batch",
                     "33"])


def test_serve_fleet_ranks_matches_reference_router(capsys):
    """``--fleet-ranks 2 --batch 32`` (reduced width, on the CPU): the
    decode-time pages go through the port's fleet, whose accounting
    equals the reference's `make_fleet_pool` + `fleet_page_request` fed
    the same need sequence; both sides refuse a sequence beyond the
    fleet."""
    from repro.launch import serve as jserve
    B, S, steps = 32, 16, 20
    res = tserve.main(["--device", "cpu", "--fleet-ranks", "2", "--batch",
                       str(B), "--prompt-len", str(S), "--decode-steps",
                       str(steps), "--impl", "ref"])
    assert "fleet (2 ranks): 2 rounds, 64 page allocs" in \
        capsys.readouterr().out
    cfg = tconfigs.get("granite_3_8b").reduced()
    P = tpaged.pages_per_seq(S + steps + cfg.page_size, cfg.page_size)
    router = jserve.make_fleet_pool(2, max(1 << (B * P - 1).bit_length(),
                                           1 << 16))
    allocs = 0
    for i in range(steps):
        if (res.prompt.shape[1] + i) % cfg.page_size == 0:
            router.route(jserve.fleet_page_request(router,
                                                   np.ones(B, bool)))
            allocs += B
    assert res.page_allocs == allocs == 64
    assert res.fleet_stats == router.stats
    assert res.fleet_stats["per_rank"]["ops"] == [32, 32]
    port = tserve.make_fleet_pool(2, 1 << 16, device="cpu")
    for fn, r in ((tserve.fleet_page_request, port),
                  (jserve.fleet_page_request, router)):
        with pytest.raises(ValueError, match="fleet thread capacity"):
            fn(r, np.ones(33, bool))


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without device="cpu", the serving entry points
    raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("granite_3_8b").reduced()
    for make in (lambda: tserve.serve(cfg, batch=1, prompt_len=16,
                                      decode_steps=1),
                 lambda: tserve.main(["--decode-steps", "1"]),
                 lambda: tpaged.PagePool(1 << 16),
                 lambda: tapi.HeapClient(),
                 lambda: treg.init(cfg),
                 lambda: ttr.init(cfg),
                 lambda: ttr.init_cache(cfg, 1, 32),
                 lambda: treg.make_prompts(cfg, 1, 16),
                 lambda: convert.params_from_reference({"w": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
