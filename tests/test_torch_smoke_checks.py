"""chip_smoke's full-width flash-attention check, on the host: it passes
an output that differs from the plain version only in summation order and
bf16 rounding, and fails one that misses a KV tile or rounds p to bf16.
tools/flash_mutants.py's broken kernels still apply to the kernel sources
(flash and paged attention), and so do tools/heap_mutants.py's broken
run-carves to the heap-step kernel; phase 6's reading agrees with its
check. Phase 5b's checks fail a doctored sw / hwsw / fused mismatch (and
let sw differ from hwsw in latencies, which the metadata cache sets) and
a nonzero residual. Phase 5c's checks fail a corrupted response field, a
corrupted placement map (``cls_map``) and a miscounted sanitizer tag or
quarantine order. Phase 5d's checks fail a decode session whose "fused"
engine disagrees with hwsw, a doctored report and a miscounted launch;
phase 5e's chaos check each broken guarantee of the elastic tier.
Phase 11's gradient check passes a summation-order difference and fails
a perturbed leaf and a broken `rms_norm`; its FLOP count and kernel
classes are pinned. Phase 12's expected launch counts, kernel 4's bytes
bound at each new head shape, its kernels-line entries and the expert-id
comparison are pinned. Phase 13's FLOP counts of the recurrent families
and the training cut's state plan are pinned; its logit check passes fp32
rounding and fails a broken `rms_norm`. Phase 14's FLOP counts of the moe,
vlm and audio families and their training cuts are pinned; its gradient
check fails a broken gate renormalisation and a broken `rms_norm`.
Phase 15's pimcheck check fails a finding, a missed fixture, a missing
tape, a kernel node that is not there, and a run whose missing fixture is
not the write-race pass's; its dry-run check fails a peak above the
measured one, argument bytes a leaf short and FLOPs outside the band, and
the FLOPs it holds (train_flops less what the checkpointed step does not
recompute) equal a reduced cut's dry-run to the unit. Phase 16's checks
fail a corrupted gathered response, a process holding the wrong rank
slice after a restore, and a flipped decode token at a clear top-2 gap
(and pass one at a near-tie). Phase 17's check of the trainer's lines
passes another straggler count and rounding, and fails a loss off in its
fourth decimal or a missing line; its local shapes of the (2, 2) mesh are
pinned from the placements.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import flash_mutants  # noqa: E402
import heap_mutants  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

B, S, H, KVH, HD = 1, 384, 4, 2, 64


def inputs(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, HD)))
            for h in (H, KVH, KVH)]


def attend64(q, k, v, dtype, drop=None, p_dtype=None):
    """Causal attention in float64, cast to `dtype`; `drop` = (first query
    row, first key) of a 64-key tile those rows do not see; `p_dtype`
    rounds p before the p.v product."""
    G = H // KVH
    k, v = (x.repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q, k) / HD ** 0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    vis = i >= j
    if drop is not None:
        r0, t0 = drop
        vis = vis & ~((i >= r0) & (j >= t0) & (j < t0 + 64))
    s = torch.where(vis, s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).double()
    o = torch.einsum("bhst,bthd->bshd", p / l, v)
    return o.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reading_passes_rounding_and_fails_wrong_outputs(dtype):
    q, k, v = (x.to(dtype) for x in inputs(11))
    want = fa.flash_attention_plain(q, k, v, causal=True)
    exact = [x.double() for x in (q, k, v)]
    _, share = chip_smoke.flash_reading(attend64(*exact, dtype), want)
    assert share <= 1.0
    for kw in (dict(drop=(S - 64, 128)), dict(drop=(128, 64)),
               dict(p_dtype=torch.bfloat16)):
        _, share = chip_smoke.flash_reading(attend64(*exact, dtype, **kw),
                                            want)
        assert share > 1.0, kw
    with pytest.raises(AssertionError):
        chip_smoke.flash_check(attend64(*exact, dtype, drop=(128, 64)),
                               want, "dropped tile")


@pytest.mark.parametrize("name", sorted(flash_mutants.MUTANTS))
def test_flash_mutants_apply_to_the_kernel_source(name):
    src = (ROOT / chip_smoke.FA_SOURCE).read_text()
    assert flash_mutants.mutate(src, name) != src


@pytest.mark.parametrize("name", sorted(flash_mutants.PAGED_MUTANTS))
def test_paged_mutants_apply_to_the_kernel_source(name):
    src = (ROOT / chip_smoke.PA_SOURCE).read_text()
    assert flash_mutants.mutate(src, name) != src


@pytest.mark.parametrize("name", sorted(heap_mutants.MUTANTS))
def test_heap_mutants_apply_to_the_kernel_source(name):
    src = (ROOT / chip_smoke.KERNEL_SOURCE).read_text()
    assert heap_mutants.mutate(src, name) != src


@pytest.mark.parametrize("test_id,refill", [
    ("t.py::test_kernel_matches_plain_on_card[4-262144-True]", True),
    ("t.py::test_kernel_matches_plain_on_card[16-1048576-False]", False),
    ("t.py::test_kernel_takes_every_backend_branch_on_card", None)])
def test_heap_mutants_read_the_refill_setting_of_a_card_test(test_id, refill):
    assert heap_mutants.refill_of(test_id) is refill


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.5, 3.0])
def test_pa_reading_agrees_with_the_phase_6_check(scale):
    """`pa_reading`'s share passes 1 exactly where `assert_close` (phase 6's
    check) raises: |diff| <= tol + tol |want| elementwise."""
    rng = np.random.default_rng(12)
    want = torch.from_numpy(rng.standard_normal((4, 8, 32)))
    tol = 2e-2
    got = want + scale * tol * (1 + want.abs()) * torch.from_numpy(
        rng.uniform(-1, 1, want.shape))
    _, share = chip_smoke.pa_reading(got, want, tol)
    try:
        chip_smoke.assert_close(got, want, tol, "reading")
        raised = False
    except AssertionError:
        raised = True
    assert raised == (share > 1.0), share


def _scan_round():
    """One mixed round through hwsw, fused and sw at a small geometry."""
    from repro_torch.core import heap, pim_malloc, system
    from test_torch_cuda import C, CAP, HEAP, T, mixed_round
    rng = np.random.default_rng(4)
    req = heap.AllocRequest(*(torch.from_numpy(x) for x in mixed_round(
        rng, [[] for _ in range(C)])))
    resps, states = {}, {}
    for k in ("hwsw", "fused", "sw"):
        cfg = system.SystemConfig(
            kind=k, heap_bytes=HEAP, num_threads=T,
            pm=pim_malloc.PimMallocConfig(heap_bytes=HEAP, num_threads=T,
                                          cap=CAP))
        st = heap.init(cfg, num_cores=C, device="cpu")
        states[k], resps[k] = heap.step(cfg, st, req)
    return resps, states


def test_scan_checks_pass_the_kinds_and_fail_a_doctored_mismatch():
    resps, states = _scan_round()
    assert chip_smoke.scan_mismatches(0, resps, states) == []
    # sw may differ from hwsw in what the metadata cache sets
    lat = resps["sw"].latency_cyc + 1
    assert chip_smoke.scan_mismatches(
        0, dict(resps, sw=resps["sw"]._replace(latency_cyc=lat)),
        states) == []
    doctored = [
        ("sw", "ptr", "sw != hwsw on response ptr"),
        ("sw", "path", "sw != hwsw on response path"),
        ("hwsw", "latency_cyc", "hwsw != fused on response latency_cyc"),
        ("fused", "meta_misses", "hwsw != fused on response meta_misses")]
    for kind, field, want in doctored:
        bad = getattr(resps[kind], field).clone()
        bad.view(-1)[0] += 1
        errs = chip_smoke.scan_mismatches(
            3, dict(resps, **{kind: resps[kind]._replace(**{field: bad})}),
            states)
        assert f"round 3: {want}" in errs, (kind, field, errs)
    # a state leaf: sw's allocator, hwsw's cache
    sw = states["sw"]
    counts = sw.alloc.counts.clone()
    counts[0, 0, 0] += 1
    errs = chip_smoke.scan_mismatches(0, resps, dict(
        states, sw=sw._replace(alloc=sw.alloc._replace(counts=counts))))
    assert any(e.startswith("round 0: sw != hwsw on state leaf") for e in
               errs), errs
    hw = states["hwsw"]
    tags = hw.cache.tags.clone()
    tags[1, 0] = 12345
    errs = chip_smoke.scan_mismatches(0, resps, dict(
        states, hwsw=hw._replace(cache=hw.cache._replace(tags=tags))))
    assert any(e.startswith("round 0: hwsw != fused on state leaf") for e in
               errs), errs


def test_scan_residual_check_fails_a_nonzero_residual():
    chip_smoke.check_residuals("sw", np.zeros(512, np.int64))
    with pytest.raises(AssertionError, match="nonzero on 1 of 512 cores"):
        chip_smoke.check_residuals("strawman",
                                   np.eye(1, 512, 7, dtype=np.int64)[0] * 32)


def _region_round():
    """Seven rounds of the closed-loop stream (before its first reset, so
    the placement map holds blocks) through arena over hwsw and over
    fused; returns the last round's responses and states."""
    from repro_torch.core import heap
    from test_torch_cuda import closed_loop, region_cfg
    out = {}
    for inner in ("hwsw", "fused"):
        st = heap.init(region_cfg("arena", inner), num_cores=3,
                       device="cpu")
        for op, size, ptr, live in closed_loop(2, rounds=7):
            req = heap.AllocRequest(*map(torch.from_numpy, (op, size, ptr)))
            st, resp = heap.step(region_cfg("arena", inner), st, req)
        out[inner] = (resp, st)
    return out


def test_region_checks_fail_a_corrupted_response_and_cls_map():
    """Phase 5c's fused-against-hwsw check passes the two spill backends
    and fails a response field or a placement map off by one entry."""
    out = _region_round()
    (rf, sf), (rh, sh) = out["fused"], out["hwsw"]
    assert chip_smoke.pair_mismatches(7, "f", "h", rf, rh, sf, sh) == []
    assert int((sf.cls_map >= 0).sum()) > 0
    for field in ("ptr", "latency_cyc", "ok"):
        bad = getattr(rf, field).clone()
        bad.view(-1)[5] = ~bad.view(-1)[5] if field == "ok" else \
            bad.view(-1)[5] + 16
        errs = chip_smoke.pair_mismatches(
            7, "f", "h", rf._replace(**{field: bad}), rh, sf, sh)
        assert errs == [f"round 7: f != h on response {field}"], errs
    cls_map = sf.cls_map.clone()
    cls_map[2, 77] = 3
    errs = chip_smoke.pair_mismatches(7, "f", "h", rf, rh,
                                      sf._replace(cls_map=cls_map), sh)
    assert len(errs) == 1 and errs[0].startswith(
        "round 7: f != h on state leaf") and "(3, 8192)" in errs[0], errs


def test_sanitizer_checks_fail_a_miscounted_tag():
    """The injected counts match the sanitizer's reports on the CPU; one
    tag counted once too often or too rarely on one core, or a ring out
    of FIFO order, fails."""
    from repro_torch.core import sanitizer
    cfg = chip_smoke.paper_cfg("sanitizer")
    tape, want, targets = chip_smoke.misuse_tape(
        np.random.default_rng(3), 8, 2, 16, cfg.heap_bytes, reset_round=4)
    model = chip_smoke.QuarantineModel(2, sanitizer.quarantine_slots(16))
    state, _ = chip_smoke.run_stream(cfg, tape, torch.device("cpu"), 8,
                                     model=model)
    assert chip_smoke.san_mismatches(state.reports, want) == []
    assert model.check(state) == []
    for key in want:
        for delta in (1, -1):
            bad = {k: v.copy() for k, v in want.items()}
            bad[key][1] += delta
            errs = chip_smoke.san_mismatches(state.reports, bad)
            assert len(errs) == 1 and errs[0].startswith(
                f"{key}: 1 cores differ"), errs
    ring = model.rings[0]
    if len(ring) > 1:
        ring[0], ring[1] = ring[1], ring[0]
        assert model.check(state)[0].startswith("core 0: quarantine")


def test_misuse_stream_predicts_evictions_and_frees_of_evicted_blocks():
    """Over 32 rounds the generator's own quarantine model predicts every
    core's parked and evicted counts, and frees of blocks that left the
    ring (tagged wild) are among the injections: the reports equal its
    counts exactly, and the ring is in FIFO order."""
    from repro_torch.core import sanitizer
    cfg = chip_smoke.paper_cfg("sanitizer")
    tape, want, targets = chip_smoke.misuse_tape(
        np.random.default_rng(5), 32, 2, 16, cfg.heap_bytes, reset_round=24)
    assert want["evicted"].min() > 0 and targets["evicted_free"].sum() > 0
    model = chip_smoke.QuarantineModel(2, sanitizer.quarantine_slots(16))
    state, _ = chip_smoke.run_stream(cfg, tape, torch.device("cpu"), 32,
                                     model=model)
    assert chip_smoke.san_mismatches(state.reports, want) == []
    assert model.check(state) == []


def test_lockstep_raises_on_the_first_disagreeing_round():
    """The lockstep runner holds two runs of one stream to each other
    every round (here MultiCoreHeap against `heap.step` of the same kind)
    and raises on the first round where a response differs."""
    from repro_torch.core import heap
    cfg = chip_smoke.paper_cfg("hwsw")
    tape = chip_smoke.session_tape(np.random.default_rng(6), 4, 2, 16)
    cpu = torch.device("cpu")

    def check(r, reqs, resps, states):
        return chip_smoke.pair_mismatches(r, "a", "b", resps["a"],
                                          resps["b"], states["a"],
                                          states["b"])

    mc = heap.MultiCoreHeap(cfg, num_cores=2, device=cpu)
    runs = {"a": chip_smoke.heap_object_run(mc, (2,), tape, cpu),
            "b": chip_smoke.kind_run(cfg, tape, cpu)}
    chip_smoke.lockstep(runs, 4, cpu, check)
    step = runs["b"][0]

    def doctored(state, req):
        state, resp = step(state, req)
        return state, resp._replace(ptr=resp.ptr + 16 * (req.op == 1))

    runs = {"a": chip_smoke.kind_run(cfg, tape, cpu),
            "b": chip_smoke.kind_run(cfg, tape, cpu)}
    runs["b"][0] = doctored
    with pytest.raises(AssertionError, match="round 0: a != b on response "
                                             "ptr"):
        chip_smoke.lockstep(runs, 4, cpu, check)


def test_decode_checks_fail_a_disagreeing_kind_and_a_miscount():
    """Phase 5d's decode lockstep holds the engine named fused to the one
    named hwsw every round: it passes the two kinds and raises when the
    "fused" engine is really sw (whose latencies differ); the report
    check raises on a doctored report, the launch check on a miscount."""
    from repro_torch.core import system
    from repro_torch.launch.serve_decode import DecodeTraffic
    cpu = torch.device("cpu")
    tc = DecodeTraffic(seed=29, rounds=12, session_rate=1.5, num_tenants=8)

    def cfg_of(kind):
        return system.SystemConfig(kind=kind, heap_bytes=1 << 20,
                                   num_threads=4)

    engines = chip_smoke.decode_engines((2, 2, 4), tc, cpu, cfg_of)
    plan = engines["fused"].plan()
    ran = chip_smoke.engine_lockstep(engines, plan, cpu)
    reps = chip_smoke.engine_reports(engines, plan, ran)
    assert reps["fused"]["conservation_residual"] == 0
    state, resps, *rest = ran["fused"]
    ran["fused"] = (state, resps._replace(
        latency_cyc=resps.latency_cyc + 1), *rest)
    with pytest.raises(AssertionError, match="fused != hwsw on"):
        chip_smoke.engine_reports(engines, plan, ran)
    engines = chip_smoke.decode_engines(
        (2, 2, 4), tc, cpu, lambda k: cfg_of("sw" if k == "fused" else k))
    with pytest.raises(AssertionError, match="fused != hwsw on response "
                                             "latency_cyc"):
        chip_smoke.engine_lockstep(engines, plan, cpu)
    chip_smoke.check_launches(cpu, "cpu", 0, 12)   # the CPU launches none
    with pytest.raises(AssertionError, match="launched 11 times"):
        chip_smoke.check_launches(torch.device("cuda"), "x", 11, 12)


def test_chaos_checks_fail_a_lit_dead_core_and_a_quiet_session():
    """Phase 5e's chaos check passes a real chaos session and names each
    broken guarantee: a killed core that dispatches, no migration, a
    dropped expiry free, a nonzero residual, a missing kill."""
    from repro_torch.core import system
    from repro_torch.launch import elastic
    from repro_torch.launch.serve_fleet import TrafficConfig
    cfg = system.SystemConfig(kind="sw", heap_bytes=1 << 17, num_threads=4)
    plan, rep = elastic.ElasticFleetServe(
        cfg, 2, 2, placement="chunked", device="cpu",
        traffic=TrafficConfig(seed=3, rounds=24, arrival_rate=6.0,
                              num_tenants=8, queue_cap=32),
        faults=elastic.FaultPlan.generate(seed=100, rounds=24,
                                          shape=(2, 2, 4)),
        migration=elastic.MigrationConfig(ratio=1.2, min_bytes=256,
                                          drain="interval",
                                          check_rounds=6)).serve()
    assert chip_smoke.chaos_errors(plan, rep) == []
    (kill,) = rep["kills"]
    (rk, ck), r = kill["core"], kill["round"]
    lit = dataclasses.replace(plan, op=plan.op.copy())
    lit.op[-1, rk, ck, 0] = 1
    assert chip_smoke.chaos_errors(lit, rep) == [
        f"killed core ({rk}, {ck}) dispatched after round {r}"]
    for bad, want in ((dict(migrations=[]), "no migration"),
                      (dict(dropped_frees=1), "dropped_frees 1"),
                      (dict(conservation_residual=16), "residual 16"),
                      (dict(kills=[]), "did not happen")):
        errs = chip_smoke.chaos_errors(plan, dict(rep, **bad))
        assert len(errs) == 1 and want in errs[0], (bad, errs)


def test_train_check_fails_a_perturbed_leaf_and_a_broken_rms_norm(
        monkeypatch):
    """Phase 11 (a)'s reading on the reduced config: the gradients
    recomputed through remat pass, a leaf off by 1 % of its largest
    element fails, and so does the dropped ``1 +`` of `rms_norm`."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import layers, registry
    from repro_torch.models.config import ShapeConfig
    cfg = configs.get("granite_3_8b").reduced()
    params = registry.init(cfg, seed=0, device="cpu")
    batch = registry.make_train_batch(cfg, ShapeConfig("t", 16, 1, "train"),
                                      seed=0, device="cpu")
    grad_fn = steps.make_grad_fn(cfg)
    want = grad_fn(params, batch)
    (l, _), g = steps.make_grad_fn(dataclasses.replace(cfg, remat=True))(
        params, batch)
    rel, worst, bad = chip_smoke.grad_reading((l, g), (want[0][0], want[1]))
    assert rel <= chip_smoke.TRAIN_LOSS_TOL and not bad
    g["blocks"]["w1"] = g["blocks"]["w1"] + 0.01 * float(
        g["blocks"]["w1"].abs().max())
    assert list(chip_smoke.grad_reading((l, g), (want[0][0], want[1]))[2]) \
        == ["blocks/w1"]

    def broken(x, scale, eps=1e-6):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * scale.float()).to(x.dtype)

    monkeypatch.setattr(layers, "rms_norm", broken)
    (lm, _), gm = grad_fn(params, batch)
    rel, _, bad = chip_smoke.grad_reading((lm, gm), (want[0][0], want[1]))
    assert rel > chip_smoke.TRAIN_LOSS_TOL and bad


def test_train_flops_and_kernel_classes():
    """Phase 11's MFU numerator at its configuration (granite-3-8b, 8
    layers, 4 x 4096 tokens): 1.7962 B matmul parameters, 270.62 TFLOP a
    step; kernel names sort into their classes."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("granite_3_8b"), n_layers=8)
    flops, n_mm = chip_smoke.train_flops(cfg, 4 * 4096, 4, 4096)
    assert n_mm == 8 * (4096 * 4096 * 2 + 4096 * 1024 * 2
                        + 3 * 4096 * 12800) + 4096 * 49408
    assert flops == 8 * n_mm * 4 * 4096 + 4 * 4 * 4 * 4096 ** 2 * 4096 * 8
    assert round(flops / 1e12, 2) == 270.62
    got = chip_smoke.kernel_classes([
        (2.0, 1, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128"),
        (1.0, 2, "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN"),
        (0.5, 1, "void at::native::(anonymous namespace)::cunn_SoftMax"),
        (0.25, 3, "void at::native::unrolled_elementwise_kernel<at::nat"),
        (0.125, 1, "void at::native::index_put_with_sort_kernel")])
    assert got == {"fp32 GEMM": (2.0, 1), "bf16 GEMM": (1.0, 2),
                   "softmax": (0.5, 1), "reduce": (0.0, 0),
                   "elementwise": (0.25, 3), "other": (0.125, 1)}


# ------------------------------------------------------------- phase 12 --
FAMILY_LAUNCHES = {"olmoe_1b_7b": 16 * 64, "qwen2_moe_a2_7b": 24 * 64,
                   "paligemma_3b": 18 * 64, "whisper_small": 12 * 64}


@pytest.mark.parametrize("name", chip_smoke.FAMILY_ARCHS)
def test_family_launches_and_kernel_4_bound_at_each_shape(name):
    """Phase 12 (b)'s expected paged-attention launches (decoder layers x
    decode steps) and (c)'s bound at the last decode step's layer-0
    inputs: bytes of the valid K/V rows at full width, as `pa_bound`
    counts them from the tensors (olmoe and qwen2-moe ~11.3 us,
    paligemma ~1.4 us, whisper ~2.4 us)."""
    from repro_torch import configs
    from repro_torch.kvcache import paged
    cfg = configs.get(name)
    steps, B = chip_smoke.FAM_STEPS, chip_smoke.FAM_BATCH
    assert chip_smoke.family_launches(cfg, steps) == FAMILY_LAUNCHES[name]
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    seq = prefix + chip_smoke.FAM_PROMPT[name] + steps
    P = paged.pages_per_seq(seq + cfg.page_size, cfg.page_size)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nbytes, nops = chip_smoke.pa_work(B, H, KVH, D, B * seq, B * P, 2)
    assert nbytes == 2 * B * seq * KVH * D * 2 + 2 * B * H * D * 2 \
        + 4 * B * P + 4 * B
    q = torch.zeros((B, H, D), dtype=torch.bfloat16)
    pool = torch.zeros((B * P, cfg.page_size, KVH, D), dtype=torch.bfloat16)
    lens = torch.full((B,), seq, dtype=torch.int32)
    assert chip_smoke.pa_bound(q, pool, lens, torch.zeros(
        (B, P), dtype=torch.int32)) == (nbytes, nops)
    bytes_us = 1e6 * nbytes / chip_smoke.HBM_BYTES_PER_S
    ops_us = 1e6 * nops / chip_smoke.FP32_OPS_PER_S
    want_us = {"moe": 11.3, "vlm": 1.4, "audio": 2.4}[cfg.family]
    assert abs(bytes_us - want_us) < 0.05 and ops_us < bytes_us


def test_family_entries_and_expert_flips():
    """One kernels-line entry per new head shape, with every key the
    record needs, its launches summed over the archs at that shape; the
    expert-id comparison reports each differing (token, k) with its
    probability gap."""
    reading = dict(err=1e-3, ms=0.02, plain_ms=0.3, sdpa_ms=0.09,
                   bytes_ms=0.011, ops_ms=0.002)
    e = chip_smoke.pa_entry("paged_attention_moe", 2560, 1e-3, reading)
    assert set(e) == {"name", "route", "source", "replaces", "launches",
                      "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms"}
    assert (e["bound_ms"], e["bound_by"], e["route"]) == \
        (0.011, "bytes", "cuda")
    assert e["replaces"] == "src/repro/kernels/paged_attention.py:94"
    assert [n for n, _ in chip_smoke.FAM_PA_ENTRIES] == [
        "paged_attention_moe", "paged_attention_paligemma",
        "paged_attention_whisper"]
    assert sorted(a for _, archs in chip_smoke.FAM_PA_ENTRIES
                  for a in archs) == sorted(chip_smoke.FAMILY_ARCHS)
    probs = torch.tensor([[0.5, 0.25, 0.2500001, 0.0], [0.1, 0.2, 0.3, 0.4]])
    a = torch.tensor([[0, 1], [3, 2]])
    b = torch.tensor([[0, 2], [3, 2]])
    flips = chip_smoke.expert_flips(a, b, probs)
    assert [(t, k) for t, k, _ in flips] == [(0, 1)]
    assert flips[0][2] < chip_smoke.FAM_TIE_GAP
    assert chip_smoke.expert_flips(a, a, probs) == []


# ------------------------------------------------------------- phase 13 --
def test_train_flops_of_the_recurrent_families():
    """Phase 13 (c)'s MFU numerators at 4 x 4096 tokens: the matmul
    parameters of every block tree (not the causal convs' taps or the fp32
    vectors) plus the tied embedding as the head; mamba2's SSD products
    on its 24 layers (32 chunks of 128); recurrentgemma's local attention
    over min(S, window) keys on its one attention layer of 5."""
    from repro_torch import configs
    D, F, V = 4096, 12288, 256000
    hy = dataclasses.replace(configs.get("recurrentgemma_9b"), n_layers=5)
    flops, n_mm = chip_smoke.train_flops(hy, 4 * 4096, 4, 4096)
    rec, attn = 5 * D * D + 3 * D * F, 2 * D * 16 * 256 + 2 * D * 256 \
        + 3 * D * F
    assert n_mm == 4 * rec + attn + V * D
    assert flops == 8 * n_mm * 4 * 4096 + 4 * 4 * 4 * 4096 * 2048 * 16 * 256
    assert round(flops / 1e12, 2) == 287.25
    mb = configs.get("mamba2_130m")
    flops, n_mm = chip_smoke.train_flops(mb, 4 * 4096, 4, 4096)
    d, N, H, P, l = 768, 128, 24, 64, 128
    assert n_mm == 24 * (2 * d * 2 * d + 2 * d * N + d * H + 2 * d * d) \
        + 50432 * d
    ssd = 2 * 4 * 4096 * (l * N + l * H * P + 2 * H * P * N)
    assert flops == 8 * n_mm * 4 * 4096 + 4 * ssd * 24
    assert round(flops / 1e12, 2) == 18.79
    # a sequence that does not fill its last chunk is padded, as the SSD
    # pads it
    assert chip_smoke.train_flops(mb, 4 * 4000, 4, 4000)[0] == \
        8 * n_mm * 4 * 4000 + 4 * ssd * 24


def test_train_flops_of_the_moe_vlm_and_audio_families():
    """Phase 14 (b)'s MFU numerators, by hand at the reduced configs (B=2,
    S=16): a MoE token runs top_k of the real experts (qwen2-moe's dummies
    and the capacity's padded slots uncounted), the router and the shared
    expert whole; the vlm's blocks run over the patch prefix and the text,
    its tied head over the text; the audio's encoder and its decoder's
    cross K / V over the frames, the rest over the text; the attention
    products at their own lengths. granite's and the recurrent families'
    counts stand as they were (the two tests above)."""
    from repro_torch import configs
    B, S = 2, 16
    T = B * S
    for name, over in (("olmoe_1b_7b", {}),
                       ("qwen2_moe_a2_7b", dict(n_experts=6,
                                                pad_experts_to=4))):
        cfg = dataclasses.replace(configs.get(name).reduced(), **over)
        L, D, V, H, KVH, hd = 2, 128, cfg.padded_vocab, 4, 2, 32
        K, Fe, Fs = 2, 64, 64 * cfg.n_shared_experts
        assert (cfg.padded_experts, cfg.top_k, cfg.expert_d_ff) == (8, K, Fe)
        layer = 2 * D * H * hd + 2 * D * KVH * hd + D * 8 + 3 * D * Fe * K \
            + 3 * D * Fs
        n_mm = L * layer + D * V
        flops, got = chip_smoke.train_flops(cfg, T, B, S)
        assert got == n_mm, name
        assert flops == 8 * n_mm * T + 4 * L * 4 * B * S * S * H * hd, name
    vlm = configs.get("paligemma_3b").reduced()
    L, D, V, H, KVH, hd, Fd, P = 2, 128, vlm.padded_vocab, 4, 1, 32, 256, 8
    assert (vlm.n_kv_heads, vlm.n_patches, vlm.tie_embeddings) == (1, P, True)
    layer = 2 * D * H * hd + 2 * D * KVH * hd + 3 * D * Fd   # geglu
    flops, got = chip_smoke.train_flops(vlm, T, B, S)
    assert got == L * layer + V * D
    assert flops == 8 * (L * layer * B * (S + P) + V * D * T) \
        + 4 * L * 4 * B * (S + P) ** 2 * H * hd
    au = configs.get("whisper_small").reduced()
    L, Le, F, V, KVH = 2, 2, 16, au.padded_vocab, 2
    attn_q, attn_kv, mlp = 2 * D * H * hd, 2 * D * KVH * hd, 2 * D * Fd
    assert (au.enc_layers, au.enc_frames) == (Le, F)
    flops, got = chip_smoke.train_flops(au, T, B, S)
    assert got == Le * (attn_q + attn_kv + mlp) \
        + L * (2 * attn_q + 2 * attn_kv + mlp) + V * D
    mm = Le * (attn_q + attn_kv + mlp) * B * F \
        + L * ((2 * attn_q + attn_kv + mlp) * T + attn_kv * B * F) + V * D * T
    seq = 4 * B * H * hd * (Le * F * F + L * (S * S + S * F))
    assert flops == 8 * mm + 4 * seq


def test_recurrent_training_plan_and_cuts():
    """(c)'s cuts: recurrentgemma at one group and its 2-layer tail, 2.175 B
    parameters whose state (bf16 params and grads, fp32 accumulator and
    moments) is 34.8 GB; mamba2 whole."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    assert chip_smoke.REC_TRAIN == {"mamba2_130m": (24, 2),
                                    "recurrentgemma_9b": (5, 4)}
    cfg = dataclasses.replace(configs.get("recurrentgemma_9b"), n_layers=5)
    spec = registry.param_specs(cfg)
    assert sorted(spec) == ["attn", "embed", "ln_f", "rec1", "rec2", "tail"]
    n = sum(t.numel() for t in tree_leaves(spec))
    assert round(n / 1e9, 3) == 2.175
    ospec = steps.opt_state_specs(cfg, adamw.AdamWConfig())
    plan = 2 * chip_smoke.tree_bytes(spec) + 4 * n + \
        chip_smoke.tree_bytes(ospec.m) + chip_smoke.tree_bytes(ospec.v)
    assert round(plan / 1e9, 1) == 34.8
    assert configs.get("mamba2_130m").n_layers == 24


# ------------------------------------------------------------- phase 14 --
def test_family_training_plan_and_cuts():
    """Phase 14 (b)'s cuts at full width: olmoe 4 of 16 layers, qwen2-moe 2
    of 24, paligemma and whisper whole, with their parameters and their
    state (bf16 params and grads, the fp32 router's own, the fp32
    accumulator and moments: ~16 B a parameter)."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    assert chip_smoke.FAM_TRAIN == {
        "olmoe_1b_7b": (4, 2), "qwen2_moe_a2_7b": (2, 2),
        "paligemma_3b": (18, 4), "whisper_small": (12, 2)}
    want = {"olmoe_1b_7b": (1.885, 30.2), "qwen2_moe_a2_7b": (1.833, 29.3),
            "paligemma_3b": (2.509, 40.1), "whisper_small": (0.238, 3.8)}
    for name, (layers, _) in chip_smoke.FAM_TRAIN.items():
        full = configs.get(name)
        assert layers <= full.n_layers
        cfg = dataclasses.replace(full, n_layers=layers)
        spec = registry.param_specs(cfg)
        n = sum(t.numel() for t in tree_leaves(spec))
        ospec = steps.opt_state_specs(cfg, adamw.AdamWConfig())
        plan = 2 * chip_smoke.tree_bytes(spec) + 4 * n + \
            chip_smoke.tree_bytes(ospec.m) + chip_smoke.tree_bytes(ospec.v)
        assert (round(n / 1e9, 3), round(plan / 1e9, 1)) == want[name], name


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "paligemma_3b"])
def test_family_gradient_check_fails_the_broken_layer(name, monkeypatch):
    """Phase 14 (a) on the reduced config, both sides on the CPU: the
    reading is 0 and held; the MoE's gate renormalisation summed over the
    wrong axis (the vlm's rms_norm without ``1 +``) fails the same
    limits on every leaf."""
    from repro_torch import configs
    get = configs.get
    monkeypatch.setattr(configs, "get", lambda n: get(n).reduced())
    monkeypatch.setitem(chip_smoke.FAM_TRAIN_CHECK, name, 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_CHECK_TEXT", 16)
    out = chip_smoke.fam_train_card_vs_cpu(name, 0, torch.device("cpu"))
    held = out["grads"]["flat" if name == "olmoe_1b_7b" else "config"]
    assert held["loss_rel"] == 0 and held["worst"] == 0 and held["flips"] == 0
    assert held["mutant"] == ("route" if name == "olmoe_1b_7b" else
                              "rms_norm")
    assert held["mutant_loss_rel"] > chip_smoke.TRAIN_LOSS_TOL
    assert held["mutant_leaves_past"] == held["leaves"]
    if name == "olmoe_1b_7b":   # the routing of every layer was compared
        assert held["routed"] == 2 * 16 * 2


@pytest.mark.parametrize("name", ["mamba2_130m", "recurrentgemma_9b"])
def test_recurrent_check_passes_rounding_and_fails_a_broken_rms_norm(
        name, monkeypatch):
    """Phase 13 (a)'s logit reading on the reduced config: logits moved by
    a few fp32 roundings pass its limit; a prefill with rms_norm's ``1 +``
    dropped fails it, and so do non-finite logits."""
    from repro_torch import configs
    from repro_torch.models import layers, registry
    cfg = configs.get(name).reduced()
    cpu = torch.device("cpu")
    params = registry.init(cfg, seed=0, device=cpu)
    tokens = registry.make_prompts(cfg, 2, 32, seed=0, device=cpu)
    want, feed, cache = chip_smoke.rec_run(cfg, params, tokens, 3, cpu)
    assert feed.shape == (2, 3) and cache["seq_lens"].tolist() == [35, 35]
    g = torch.Generator().manual_seed(0)
    rounded = [w * (1 + 2.0 ** -21 * torch.randn(w.shape, generator=g))
               for w in want]
    share = chip_smoke.logit_reading(rounded, want, cfg.vocab)
    assert 0 < share <= 1e-5 < chip_smoke.REC_LOGIT_TOL
    monkeypatch.setattr(layers, "rms_norm", chip_smoke.rms_norm_without_one)
    mut, _, _ = chip_smoke.rec_run(cfg, params, tokens, 0, cpu)
    assert chip_smoke.logit_reading(mut, want[:1], cfg.vocab) > \
        chip_smoke.REC_LOGIT_TOL
    bad = [want[0].clone()]
    bad[0][0, 0] = float("nan")
    assert chip_smoke.logit_reading(bad, want, cfg.vocab) == float("inf")


# ---------------------------------------------------------------------------
# phase 15: the analysis tooling
# ---------------------------------------------------------------------------
def _pimcheck_report(tmp_path, *argv):
    import json
    from repro_torch.analysis import pimcheck
    out = tmp_path / f"r{len(list(tmp_path.iterdir()))}.json"
    rc = pimcheck.main([*argv, "--device", "cpu", "--json", str(out)])
    return rc, json.loads(out.read_text())


def test_pimcheck_checks_fail_a_finding_a_missed_fixture_and_a_node(
        tmp_path):
    import copy
    rc, rep = _pimcheck_report(tmp_path, "--kinds", "sw,fused", "--tiers",
                               "single", "--tapes", "--fixtures")
    kinds, tiers = ("sw", "fused"), ("single",)
    chip_smoke.check_pimcheck(rc, rep, kinds, tiers, card=False)
    with pytest.raises(AssertionError, match="heap_step"):
        chip_smoke.check_pimcheck(rc, rep, kinds, tiers, card=True)
    on_card = copy.deepcopy(rep)
    next(r for r in on_card["rows"] if r["target"] == "fused")[
        "kernel_nodes"] = {"repro_torch::heap_step": 1}
    chip_smoke.check_pimcheck(rc, on_card, kinds, tiers, card=True)
    for doctor in (
            lambda r: r["rows"][0].update(findings=1),
            lambda r: next(x for x in r["rows"] if x["target"].startswith(
                "fixture:")).update(flagged_by_expected=False),
            lambda r: next(x for x in r["rows"] if x["target"].startswith(
                "tape:")).update(findings=2),
            lambda r: r["rows"].pop(0)):
        bad = copy.deepcopy(rep)
        doctor(bad)
        with pytest.raises(AssertionError, match="pimcheck"):
            chip_smoke.check_pimcheck(rc, bad, kinds, tiers, card=False)
    with pytest.raises(AssertionError, match="exit code 1"):
        chip_smoke.check_pimcheck(1, rep, kinds, tiers, card=False)


def test_pimcheck_check_fails_unless_the_race_pass_is_what_is_missing(
        tmp_path):
    from repro_torch.analysis import passes
    keep = [p for p in passes.PASS_NAMES if p != chip_smoke.RACE_PASS]
    rc, rep = _pimcheck_report(tmp_path, "--fixtures", "--passes",
                               ",".join(keep))
    chip_smoke.check_pass_disabled(rc, rep)
    for argv in (("--fixtures",), ("--fixtures", "--passes", "donation")):
        rc, rep = _pimcheck_report(tmp_path, *argv)
        with pytest.raises(AssertionError, match="write-race"):
            chip_smoke.check_pass_disabled(rc, rep)


def test_dry_run_check_fails_a_high_peak_a_missing_leaf_and_flops():
    """(b)'s check against phase 11: the dry-run's program FLOPs equal
    train_flops less what the checkpointed step does not recompute, to the
    unit, at a reduced granite cut; a peak above the measured one, argument
    bytes one leaf short, and FLOPs outside the band fail."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(configs.get("granite_3_8b").reduced(),
                              n_layers=2, remat=True, dtype="bfloat16")
    B, S = 4, 64
    ana, _ = dryrun.program(cfg, ShapeConfig("train_4k", S, B, "train"), 2,
                            "cpu")
    tf, _ = chip_smoke.train_flops(cfg, B * S, B, S)
    want = tf - chip_smoke.recompute_skipped(cfg, B * S)
    assert ana["flops"] == want < tf
    plan, peak, args = 3 * ana["argument_bytes"] // 2, \
        ana["peak_bytes"] + 1, ana["argument_bytes"]
    chip_smoke.check_dry_train(ana, args, plan, peak, want)
    leaf = cfg.d_model * 4  # one ln leaf of fp32
    for bad, match in (
            (dict(ana, peak_bytes=peak + 1), "peak"),
            (dict(ana, argument_bytes=args - leaf), "argument"),
            (dict(ana, flops=int(want * (1 + 1.01 * chip_smoke.FLOP_BAND))),
             "FLOPs"),
            (dict(ana, flops=int(want * (1 - 1.01 * chip_smoke.FLOP_BAND))),
             "FLOPs")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_dry_train(bad, args, plan, peak, want)
    with pytest.raises(AssertionError, match="peak"):
        chip_smoke.check_dry_train(ana, args, ana["peak_bytes"] + 1,
                                   peak, want)


# ------------------------------------------------------------ phase 16 --
def _small_fleet():
    """A one-device FleetServe session on the host (R=2, C=2), as phase
    16 digests it: (want, responses)."""
    from repro_torch.core.system import SystemConfig
    from repro_torch.launch.serve_fleet import FleetServe, TrafficConfig
    eng = FleetServe(SystemConfig(kind="sw", heap_bytes=1 << 19,
                                  num_threads=16), 2, 2,
                     traffic=TrafficConfig(seed=17, rounds=8,
                                           arrival_rate=16.0, num_tenants=16,
                                           queue_cap=32), device="cpu")
    plan = eng.plan()
    state, resps = eng.run(plan)
    want = dict(report=eng.report(plan, resps, state),
                resps=chip_smoke.resp_digests(resps),
                state_rows={(r, r + 1): chip_smoke.leaf_digests(
                    state, slice(r, r + 1)) for r in range(2)})
    good = [dict(rank=r, report=want["report"], resps=want["resps"],
                 held=(r, r + 1), state=want["state_rows"][(r, r + 1)])
            for r in range(2)]
    chip_smoke.check_mesh_fleet(good, want, "sound")
    return want, good, resps


def test_mesh_check_fails_a_corrupted_gathered_response():
    want, good, resps = _small_fleet()
    lat = resps.latency_cyc.clone()
    lat.view(-1)[7] = torch.nextafter(lat.view(-1)[7], torch.tensor(1e9))
    bad = dict(good[1], resps=chip_smoke.resp_digests(
        resps._replace(latency_cyc=lat)))
    with pytest.raises(AssertionError, match="process 1's responses.*"
                       "latency_cyc"):
        chip_smoke.check_mesh_fleet([good[0], bad], want, "(a)")


def test_mesh_check_fails_a_wrong_rank_slice_after_a_restore():
    want, good, _ = _small_fleet()
    assert want["state_rows"][(0, 1)] != want["state_rows"][(1, 2)]
    swapped = dict(good[0], state=want["state_rows"][(1, 2)])
    with pytest.raises(AssertionError, match=r"ranks \[0, 1\)"):
        chip_smoke.check_mesh_fleet([swapped, good[1]], want, "(b)")


def test_decode_check_fails_a_flipped_token_and_passes_a_near_tie():
    want = torch.tensor([[5, 6, 7, 8], [1, 2, 3, 4]])   # [B, steps + 1]
    gaps = torch.full((4, 2), 0.5)                      # [steps + 1, B]
    gaps[1, 0] = chip_smoke.SEQPAR_BF16_GAP / 2
    near = want.clone()
    near[0, 1] = 9                   # at a near-tie: allowed
    errs, diff = chip_smoke.near_tie_errors(near, want, gaps, "fed")
    assert errs == [] and diff == [(0, 1)]
    near[0, 2:] = 0                  # a free-running history after it
    errs, diff = chip_smoke.near_tie_errors(near, want, gaps, "free",
                                            free=True)
    assert errs == [] and diff == [(0, 1)]
    flipped = want.clone()
    flipped[1, 2] = 0                # at a clear gap: a fault
    errs, diff = chip_smoke.near_tie_errors(flipped, want, gaps, "fed")
    assert diff == [(1, 2)] and len(errs) == 1 and "request 1 step 2" in \
        errs[0]


def test_decode_gaps_read_the_real_vocabulary():
    """`top2_gaps`: each step's top-2 gap over max |logit|, one row a
    step, the padded columns past the vocabulary left out."""
    step0 = torch.tensor([[4.0, 3.0, -8.0, 99.0], [1.0, 1.0, 0.5, 50.0]])
    step1 = torch.tensor([[0.0, 2.0, 1.0, -1e30], [-10.0, 5.0, 4.0, 7.0]])
    gaps = chip_smoke.top2_gaps([step0, step1], vocab=3)
    torch.testing.assert_close(gaps, torch.tensor([[1 / 8, 0.0],
                                                   [1 / 2, 1 / 10]]))


LINES = ["arch=granite-3-8b params=426,624",
         "step 0: loss=6.6975 gnorm=10.438 lr=1.00e-04",
         "step 5: loss=5.6239 gnorm=9.571 lr=6.00e-04",
         "done: 12 steps, 1 recoveries, 0 straggler events",
         "latest checkpoint: step 11"]


def test_mesh_train_lines_check_passes_rounding_and_fails_a_loss():
    near = list(LINES)
    near[1] = "step 0: loss=6.6976 gnorm=10.438 lr=1.00e-04"
    near[3] = "done: 12 steps, 1 recoveries, 2 straggler events"
    assert chip_smoke.mt_lines_equal(near + ["noise"], LINES, "ok") == 5
    off = list(LINES)
    off[2] = "step 5: loss=5.6259 gnorm=9.571 lr=6.00e-04"
    with pytest.raises(AssertionError, match="step 5"):
        chip_smoke.mt_lines_equal(off, LINES, "(c)")
    with pytest.raises(AssertionError, match="4 lines, want 5"):
        chip_smoke.mt_lines_equal(LINES[:2] + LINES[3:], LINES, "(c)")
    recov = list(LINES)
    recov[3] = "done: 12 steps, 0 recoveries, 0 straggler events"
    with pytest.raises(AssertionError, match="recoveries"):
        chip_smoke.mt_lines_equal(recov, LINES, "(c)")


def test_mesh_train_local_shapes_follow_the_placements():
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("granite_3_8b").reduced(),
                              attn_4d=False)
    got = chip_smoke.mt_want_local(cfg, {"data": 2, "model": 2})
    L, D, V, F = 2, 128, 512, 256
    assert got["embed"] == (V // 2, D // 2)         # vocab / model, D / data
    assert got["head"] == (D // 2, V // 2)          # D / data, vocab / model
    assert got["blocks/wq"] == (L, D // 2, 4 * 32 // 2)
    assert got["blocks/wo"] == (L, 4 * 32 // 2, D // 2)
    assert got["blocks/w2"] == (L, F // 2, D // 2)
    assert got["blocks/ln1"] == (L, D) and got["ln_f"] == (D,)
