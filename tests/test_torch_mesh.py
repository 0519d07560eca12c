"""The heap fleet and sequence-parallel decode across processes.

One group of 4 gloo processes on the CPU (`repro_torch.launch.mesh.spawn`,
once for the file) runs every case of `torch_mesh_workers.run_all`; the
processes import no JAX. The parent holds their results against the
port's one-device runs (``mesh=False``) and the reference:

  * `ShardedHeap` over the rank mesh on all seven kinds at R = 4, 8 and 2
    (R = 2: processes 2 and 3 hold no ranks) with C = 8 / R, so R x C is
    8 cores: every gathered response and state leaf == the fold == the
    reference's `MultiCoreHeap` at 8 cores, bit for bit (the reference's
    own mesh path fails under JAX 0.9, ROADMAP C); the builders with
    [R] / [R, C] / scalar masks == the fold;
  * a FleetServe and a DecodeServe session on the mesh == the same
    sessions with ``mesh=False``: reports, responses, final state;
  * the elastic tier: a session snapshotted on the mesh and restored
    without it, and one snapshotted without it and restored on the mesh,
    each == the uninterrupted run;
  * `write_attend_seqpar` on a 2 x 2 (data, model) mesh against the
    reference's `write_token` + `attend` on tests/test_kvcache_seqpar.py's
    inputs: o within atol = rtol = 3e-5 (the reference's bound), the
    pools exact once the local pages are put back together;
  * granite-3-8b reduced (2 layers), prefill + 4 greedy decode steps on a
    1 x 2 mesh against the reference's decode: logits within 1e-4 of max
    |logit| + 1e-5, tokens and seq_lens exact; and `launch.serve.serve`
    on a 2 x 2 mesh (the batch split over data, the pages over model, the
    decode pages from a 2-rank fleet on the rank mesh) == `serve` on one
    device: tokens, fleet accounting, logits within the same bound.

Without a spawn: the rank mesh's divisor rule against the reference's
`make_rank_mesh`, `init_world` refusing nccl with fewer cards than
processes, and `write_attend_seqpar` without a mesh.
"""
import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro import configs as jconfigs
from repro.core import heap as jheap
from repro.core import system as jsys
from repro.kvcache import paged as jpaged
from repro.models import registry as jreg
from repro.parallel import meshctx as jmeshctx

from repro_torch.core import heap as theap
from repro_torch.kvcache import paged as tpaged
from repro_torch.launch import elastic as telastic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve_decode as tsd
from repro_torch.launch import serve_fleet as tsf
from repro_torch.launch import serving
from repro_torch.parallel import meshctx

WORLD = 4
KINDS = ("strawman", "sw", "hwsw", "sanitizer", "arena", "tlregion",
         "fused")
REF_KIND = {"fused": "pallas"}
T, HEAP, CORES, RANKS, ROUNDS = 4, 1 << 18, 8, (4, 8, 2), 1
FLEET = dict(kind="fused", heap=1 << 19, shape=(4, 2, 16),
             placement="least_loaded",
             traffic=dict(seed=17, rounds=24, arrival_rate=32.0,
                          num_tenants=64, queue_cap=128))
DECODE = dict(kind="fused", heap=1 << 20, shape=(4, 2, 16),
              traffic=dict(seed=29, rounds=24, session_rate=1.5,
                           num_tenants=16, queue_cap=16))
ELASTIC = dict(kind="fused", heap=1 << 19, shape=(4, 2, 16), snap=12,
               traffic=dict(seed=17, rounds=24, arrival_rate=48.0,
                            num_tenants=128, queue_cap=256, zipf_a=2.2),
               migration=dict(ratio=1.3, min_bytes=2048, drain="interval",
                              check_rounds=8, max_moves=2))
GRANITE = dict(batch=2, prompt=32, steps=4)
SERVE = dict(batch=2, prompt_len=32, decode_steps=36, impl="ref", seed=3,
             fleet_ranks=2)
MAIN = ["--arch", "granite_3_8b", "--reduced", "--device", "cpu",
        "--dist-backend", "gloo", "--batch", "2", "--prompt-len", "16",
        "--decode-steps", "20"]


def _sizes():
    """[ROUNDS, CORES, T] malloc sizes, distinct per (core, thread)."""
    rng = np.random.RandomState(7)
    return rng.choice([16, 100, 256, 2048, 3000, 8192],
                      (ROUNDS, CORES, T)).astype(np.int32)


def _seqpar_inputs():
    """tests/test_kvcache_seqpar.py's inputs, as NumPy."""
    B, Pn, page, KVH, hd, H = 4, 8, 16, 2, 32, 4
    rng = np.random.RandomState(0)
    f = np.float32
    x = dict(q=rng.randn(B, H, hd).astype(f) * f(0.3),
             kn=rng.randn(B, KVH, hd).astype(f) * f(0.3),
             vn=rng.randn(B, KVH, hd).astype(f) * f(0.3),
             kp=rng.randn(B, Pn, page, KVH, hd).astype(f) * f(0.3),
             vp=rng.randn(B, Pn, page, KVH, hd).astype(f) * f(0.3))
    x["pt"] = np.asarray([rng.permutation(Pn) for _ in range(B)], np.int32)
    x["pos"] = np.asarray(rng.randint(10, Pn * page - 2, B), np.int32)
    return x


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _granite_spec():
    """granite reduced (2 layers): parameters from the port's init as
    NumPy (the reference's tree: the same nesting, names and dtypes; the
    reference decodes with them too), the prompt and a rotated page table
    over an even page count."""
    from repro_torch import configs as tconfigs
    from repro_torch.models import registry as treg
    cfg = jconfigs.get("granite_3_8b").reduced()
    params = _numpy_tree(treg.init(tconfigs.get("granite_3_8b").reduced(),
                                   seed=0, device="cpu"))
    B, S, steps = GRANITE["batch"], GRANITE["prompt"], GRANITE["steps"]
    max_seq = S + steps + cfg.page_size
    P = jpaged.pages_per_seq(max_seq, cfg.page_size)
    assert P % 2 == 0
    pt = np.stack([(np.arange(P) + b + 1) % P for b in range(B)]).astype(
        np.int32)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    return dict(params=params, tokens=toks, pt=pt, max_seq=max_seq,
                steps=steps, overrides={})


def _seqpar_reference(x):
    kp = jpaged.write_token(jnp.asarray(x["kp"]), jnp.asarray(x["kn"]),
                            jnp.asarray(x["pt"]), jnp.asarray(x["pos"]))
    vp = jpaged.write_token(jnp.asarray(x["vp"]), jnp.asarray(x["vn"]),
                            jnp.asarray(x["pt"]), jnp.asarray(x["pos"]))
    o = jpaged.attend(jnp.asarray(x["q"]), kp, vp, jnp.asarray(x["pt"]),
                      jnp.asarray(x["pos"]) + 1)
    return np.asarray(o), np.asarray(kp), np.asarray(vp)


def _granite_reference(g):
    """The reference's prefill + greedy decode of `_granite_spec`: every
    step's logits, and the final seq_lens and K pool, as NumPy."""
    cfg = jconfigs.get("granite_3_8b").reduced()
    jmod = jreg.get_module(cfg)
    params = jax.tree.map(jnp.asarray, g["params"])
    B = g["tokens"].shape[0]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jmod.cache_spec(cfg, B, g["max_seq"]))
    cache["page_table"] = jnp.asarray(g["pt"])
    prefill = jax.jit(jmod.prefill, static_argnums=0)
    decode = jax.jit(jmod.decode, static_argnums=0)
    cache, log = prefill(cfg, params, {"tokens": jnp.asarray(g["tokens"])},
                         cache)
    want = [np.asarray(log)]
    for _ in range(g["steps"]):
        cache, log = decode(cfg, params, cache, {
            "tokens": jnp.argmax(log, axis=-1)[:, None]})
        want.append(np.asarray(log))
    return want, {k: np.asarray(cache[k]) for k in ("seq_lens", "k_pages")}


def _elastic_engine(spec, mesh):
    return W.elastic_engine(spec, mesh)


def _one_device(kind, sizes):
    """`kind`'s session through the reference's MultiCoreHeap at CORES
    cores and the port's fold (R = 4: at any R it steps the same 8 folded
    cores): (reference responses, reference state, fold responses, fold
    state), every leaf ``[CORES, ...]``."""
    jcfg = jsys.SystemConfig(kind=REF_KIND.get(kind, kind), heap_bytes=HEAP,
                             num_threads=T)
    jm = jheap.MultiCoreHeap(jcfg, num_cores=CORES)
    want = []
    for rnd in range(ROUNDS):
        ra = jm.malloc(jnp.asarray(sizes[rnd]))
        rr = jm.realloc(ra.ptr, jnp.roll(jnp.asarray(sizes[rnd]), 1, -1))
        want += [ra, rr, jm.free(jnp.where(rr.ptr >= 0, rr.ptr, ra.ptr))]
    want = [{f: np.asarray(getattr(r, f)) for f in r._fields} for r in want]
    jstate = [np.asarray(x) for x in jax.tree.leaves(jm.state)]
    fold = theap.ShardedHeap(W.kind_cfg(kind, HEAP, T), 4, 2, mesh=False,
                             device="cpu")
    fresps = []
    for rnd in range(ROUNDS):
        fresps += W.sharded_session(fold, sizes[rnd].reshape(4, 2, T))
    flat = [{f: v.reshape((CORES,) + v.shape[2:]) for f, v in d.items()}
            for d in fresps]
    fstate = [x.reshape((CORES,) + x.shape[2:])
              for x in W.whole_state(fold, fold.state)]
    return want, jstate, flat, fstate


def _one_device_kinds(kinds, sizes):
    return {k: _one_device(k, sizes) for k in kinds}


POOL_KINDS = ("strawman", "sw", "hwsw", "tlregion")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The parent's fold snapshot, then the one spawn, during which one
    more process runs POOL_KINDS on one device and the parent the other
    kinds and the reference's seqpar write + attend and granite decode
    (the reference's compiles take most of the file's time): (spec,
    results by process, the fold's uninterrupted elastic run, {kind:
    `_one_device`}, {"seqpar": ..., "granite": ...})."""
    el = dict(ELASTIC, dir_mesh=str(tmp_path_factory.mktemp("snap_mesh")),
              dir_fold=str(tmp_path_factory.mktemp("snap_fold")))
    shape, tc = el["shape"], el["traffic"]
    el["faults"] = telastic.FaultPlan.generate(
        seed=9, rounds=tc["rounds"], shape=shape, kills=2, stalls=2,
        drops=1).to_json()
    fold = _elastic_engine(el, False)
    fold.start()
    fold.run_until(el["snap"])
    fold.snapshot(el["dir_fold"])
    fold_run = W.elastic_finish(fold)
    spec = dict(
        sharded=dict(kinds=KINDS, ranks=RANKS, cores=CORES, threads=T,
                     heap=HEAP, sizes=_sizes()),
        fleet=FLEET, decode=DECODE, elastic=el, seqpar=_seqpar_inputs(),
        granite=_granite_spec(), serve=SERVE, main=MAIN)
    sizes = spec["sharded"]["sizes"]
    with concurrent.futures.ThreadPoolExecutor(1) as ex, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
        spawned = ex.submit(tmesh.spawn, W.run_all, WORLD, spec,
                            backend="gloo", timeout=300)
        half = pool.submit(_one_device_kinds, POOL_KINDS, sizes)
        one = _one_device_kinds([k for k in KINDS if k not in POOL_KINDS],
                                sizes)
        refs = dict(seqpar=_seqpar_reference(spec["seqpar"]),
                    granite=_granite_reference(spec["granite"]))
        one.update(half.result())
        results = spawned.result()
    return spec, results, fold_run, one, refs


def _same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, dict):
            for f in x:
                np.testing.assert_array_equal(
                    np.asarray(x[f]), np.asarray(y[f]),
                    err_msg=f"{what} [{i}] {f}")
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{what} leaf {i}")


def test_processes_import_no_jax(group):
    _, results, _, _, _ = group
    assert [r["rank"] for r in results] == list(range(WORLD))
    assert all(r["world"] == WORLD for r in results)
    assert all(r["imported"] == [] for r in results)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_heap_on_mesh_equals_fold_and_reference(group, kind):
    """On every R: the ranks each process holds, every process's gathered
    responses alike, and rank 0's responses and gathered state == the
    port's fold == the reference's MultiCoreHeap at R x C cores (the fold
    at any R steps the same 8 folded cores: it runs once, at R = 4)."""
    spec, results, _, one, _ = group
    want, jstate, flat, fstate = one[kind]
    _same(flat, want, f"{kind} fold vs reference")
    _same(fstate, jstate, f"{kind} fold state vs reference")
    for R in RANKS:
        C = CORES // R
        per = R // meshctx.rank_mesh_size(R, WORLD)
        got = [r["sharded"][(kind, R)] for r in results]
        assert {g["mesh_size"] for g in got} == {R // per}
        assert [g["held"] for g in got] == [
            (i * per, (i + 1) * per) if i < R // per else (0, 0)
            for i in range(WORLD)]
        assert len({g["digest"] for g in got}) == 1, (kind, R)
        assert all(v.shape[:3] == (R, C, T) for d in got[0]["resps"]
                   for v in d.values())
        _same([{f: v.reshape((CORES,) + v.shape[2:]) for f, v in d.items()}
               for d in got[0]["resps"]], flat, f"{kind} R={R} mesh vs fold")
        _same([x.reshape((CORES,) + x.shape[2:]) for x in got[0]["state"]],
              fstate, f"{kind} R={R} state")


def test_sharded_builders_and_masks_on_mesh(group):
    spec, results, _, _, _ = group
    got = [r["sharded"]["masks"] for r in results]
    assert len({g["digest"] for g in got}) == 1
    fold = theap.ShardedHeap(W.kind_cfg("sw", HEAP, T), 4, 2, mesh=False,
                             device="cpu")
    want = W.sharded_session(fold, spec["sharded"]["sizes"][0].reshape(
        4, 2, -1), masks=True)
    _same(got[0]["resps"], want, "masks")
    _same(got[0]["state"], W.whole_state(fold, fold.state), "masks state")
    # [R] selected ranks 0 and 2 for the realloc, [R, C] a checkerboard
    assert (want[1]["path"][1::2] == -1).all()
    assert (want[2]["ptr"][0, 1] == -1).all() and \
        (want[2]["ptr"][0, 0] >= 0).all()


def _session_equal(got, engine_cls, traffic_cls, spec, what):
    """Every process's report and fleet health (per-core numbers gathered,
    never the state) equal to the one-device session's, rank 0's
    responses, planned ops and gathered final state too."""
    shape = spec["shape"]
    kw = dict(placement=spec["placement"]) if "placement" in spec else {}
    eng = engine_cls(W.kind_cfg(spec["kind"], spec["heap"], shape[2]),
                     shape[0], shape[1], traffic=traffic_cls(
                         **spec["traffic"]), mesh=False, device="cpu", **kw)
    plan = eng.plan()
    state, resps = eng.run(plan)
    report = eng.report(plan, resps, state)
    health = serving.fleet_health(eng.cfg, state, *shape[:2])
    assert [g["held"] for g in got] == [(i, i + 1) for i in range(WORLD)]
    for g in got:
        assert g["report"] == report, what
        assert g["health"] == health, what
    assert len({g["digest"] for g in got}) == 1
    np.testing.assert_array_equal(got[0]["op"], plan.op)
    _same([got[0]["resps"]], [W.response_arrays(resps)], what)
    _same(got[0]["state"], W.whole_state(eng, state), what + " state")
    assert report["conservation_residual"] == 0
    return report


def test_fleet_serve_on_mesh_equals_one_device(group):
    _, results, _, _, _ = group
    rep = _session_equal([r["fleet"] for r in results], tsf.FleetServe,
                         tsf.TrafficConfig, FLEET, "fleet serve")
    assert rep["dispatched"] > 0


def test_decode_serve_on_mesh_equals_one_device(group):
    _, results, _, _, _ = group
    rep = _session_equal([r["decode"] for r in results], tsd.DecodeServe,
                         tsd.DecodeTraffic, DECODE, "decode serve")
    assert rep["sessions_prefilled"] > 0 and rep["decode_tokens"] > 0


def _elastic_equal(got, want, what):
    assert got["report"] == want["report"], what
    _same([got["resps"]], [want["resps"]], what)
    _same(got["state"], want["state"], what + " state")


def test_elastic_snapshot_on_mesh_restored_without_mesh(group):
    spec, results, fold_run, _, _ = group
    el = spec["elastic"]
    for r in results:
        assert r["elastic"]["mesh_run"]["report"] == fold_run["report"]
    _elastic_equal(results[0]["elastic"]["mesh_run"], fold_run,
                   "uninterrupted on the mesh")
    restored = _elastic_engine(el, False).restore(el["dir_mesh"])
    assert restored.r == el["snap"]
    _elastic_equal(W.elastic_finish(restored), fold_run,
                   "mesh snapshot finished on one device")
    assert fold_run["report"]["kills"]


def test_elastic_snapshot_without_mesh_restored_on_mesh(group):
    _, results, fold_run, _, _ = group
    assert [r["elastic"]["fold_to_mesh"]["held"] for r in results] == [
        (i, i + 1) for i in range(WORLD)]
    for r in results:
        assert r["elastic"]["fold_to_mesh"]["report"] == fold_run["report"]
    _elastic_equal(results[0]["elastic"]["fold_to_mesh"], fold_run,
                   "one-device snapshot finished on the mesh")


def test_write_attend_seqpar_on_mesh_matches_reference(group):
    _, results, _, _, refs = group
    o_r, kp_r, vp_r = refs["seqpar"]
    o = np.zeros_like(o_r)
    kp, vp = np.zeros_like(kp_r), np.zeros_like(vp_r)
    seen = set()
    for r in results:
        s = r["seqpar"]
        rows, pages = slice(*s["rows"]), slice(*s["pages"])
        seen.add((s["rows"], s["pages"]))
        o[rows] = s["o"]
        kp[rows, pages] = s["kp"]
        vp[rows, pages] = s["vp"]
    assert len(seen) == WORLD  # 2 row blocks x 2 page blocks
    np.testing.assert_allclose(o, o_r, atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(kp, kp_r)
    np.testing.assert_array_equal(vp, vp_r)


def test_write_attend_seqpar_without_mesh_matches_reference():
    x = _seqpar_inputs()
    o_r, kp_r, vp_r = _seqpar_reference(x)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    for impl in ("ref", "kernel"):
        kp, vp = t["kp"].clone(), t["vp"].clone()
        o, kp2, vp2 = tpaged.write_attend_seqpar(
            t["q"], t["kn"], t["vn"], kp, vp, t["pt"], t["pos"], impl=impl)
        assert kp2 is kp and vp2 is vp
        np.testing.assert_allclose(o.numpy(), o_r, atol=3e-5, rtol=3e-5)
        np.testing.assert_array_equal(kp.numpy(), kp_r)
        np.testing.assert_array_equal(vp.numpy(), vp_r)


def test_granite_reduced_decode_on_mesh_matches_reference(group):
    spec, results, _, _, refs = group
    g = spec["granite"]
    cfg = jconfigs.get("granite_3_8b").reduced()
    want, cache = refs["granite"]
    got = [r["granite"] for r in results]
    assert got[2] is None and got[3] is None  # outside the 1 x 2 mesh
    P = g["pt"].shape[1]
    assert [x["pages"] for x in got[:2]] == [P // 2, P // 2]
    assert [x["model_index"] for x in got[:2]] == [0, 1]
    for x in got[:2]:
        for step, (a, w) in enumerate(zip(x["logits"], want)):
            tol = 1e-4 * np.abs(w[:, :cfg.vocab]).max() + 1e-5
            np.testing.assert_allclose(a, w, atol=tol, rtol=0,
                                       err_msg=f"step {step}")
            np.testing.assert_array_equal(a.argmax(-1), w.argmax(-1))
        np.testing.assert_array_equal(x["seq_lens"], cache["seq_lens"])
    # the two processes' pages put back together == the reference's pools
    kp = np.concatenate([got[0]["k_pages"], got[1]["k_pages"]], axis=2)
    want_kp = cache["k_pages"]
    np.testing.assert_allclose(kp, want_kp, rtol=0,
                               atol=1e-5 * np.abs(want_kp).max())


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_rank_mesh_rule_matches_reference(monkeypatch, world):
    """`rank_mesh_size` == the mesh size the reference's `make_rank_mesh`
    builds with `world` devices, for R in 1..12."""
    made = []
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names: made.append((shape, names)))
    for R in range(1, 13):
        jmeshctx.make_rank_mesh(R, "ranks")
        assert made[-1] == ((meshctx.rank_mesh_size(R, world),), ("ranks",))
    # without a process group the port's rank mesh is the one-device fold
    assert meshctx.make_rank_mesh(4) is False


def test_init_world_refuses_nccl_with_fewer_cards(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmesh.init_world("nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.init_world("mpi")
    assert not torch.distributed.is_initialized()


def test_serve_on_mesh_equals_one_device(group):
    """Every process: the whole batch's tokens and logits, the fleet's
    accounting equal to one device's; each holding one batch row and half
    of the pages."""
    from repro_torch import configs
    from repro_torch.launch import serve as tserve
    _, results, _, _, _ = group
    cfg = configs.get("granite_3_8b").reduced()
    one = tserve.serve(cfg, device="cpu", **SERVE)
    assert one.fleet_stats["ops"] > 0  # decode pages from the fleet
    for r in results:
        got = r["serve"]
        np.testing.assert_array_equal(got["tokens"], one.tokens.numpy())
        want = one.logits.numpy()
        tol = 1e-4 * np.abs(want[:, :cfg.vocab]).max() + 1e-5
        np.testing.assert_allclose(got["logits"], want, atol=tol, rtol=0)
        assert got["fleet"] == one.fleet_stats
        assert got["page_allocs"] == one.page_allocs and got["finite"]
        assert (got["rows"], 2 * got["pages"]) == (
            1, one.cache["k_pages"].shape[2])


def test_serve_main_joins_the_world_and_equals_one_device(group):
    """`serve --dist-backend gloo` in a world of 4 (a 1 x 4 mesh) keeps
    the process group it found; its tokens == the one-device `main`'s."""
    from repro_torch.launch import serve as tserve
    _, results, _, _, _ = group
    one = tserve.main([a for a in MAIN if a not in ("--dist-backend",
                                                    "gloo")])
    for r in results:
        np.testing.assert_array_equal(r["main"]["tokens"],
                                      one.tokens.numpy())
        assert r["main"]["group_kept"]
