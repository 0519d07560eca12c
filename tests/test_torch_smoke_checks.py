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
engine disagrees with hwsw, a doctored report and a miscounted launch.
"""
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
    ran = chip_smoke.decode_lockstep(engines, plan, cpu)
    reps = chip_smoke.decode_reports(engines, plan, ran)
    assert reps["fused"]["conservation_residual"] == 0
    state, resps, *rest = ran["fused"]
    ran["fused"] = (state, resps._replace(
        latency_cyc=resps.latency_cyc + 1), *rest)
    with pytest.raises(AssertionError, match="fused != hwsw on"):
        chip_smoke.decode_reports(engines, plan, ran)
    engines = chip_smoke.decode_engines(
        (2, 2, 4), tc, cpu, lambda k: cfg_of("sw" if k == "fused" else k))
    with pytest.raises(AssertionError, match="fused != hwsw on response "
                                             "latency_cyc"):
        chip_smoke.decode_lockstep(engines, plan, cpu)
    chip_smoke.check_launches(cpu, "cpu", 0, 12)   # the CPU launches none
    with pytest.raises(AssertionError, match="launched 11 times"):
        chip_smoke.check_launches(torch.device("cuda"), "x", 11, 12)
