#!/usr/bin/env python3
"""Show that the heap-step kernel takes its run-carve branch on the card,
on just the core-rounds where the ported helpers say it should, and that
chip_smoke phase 3 and the card tests fail when that branch is broken.

    python3 tools/heap_mutants.py --work DIR [--seed N] [--out F]

Needs one NVIDIA GPU and nvcc. By design the run-carve and the serial walk
give the same outputs bit for bit, so equal outputs cannot tell which one
ran. This script builds broken copies of ``csrc/heap_step.cu`` (under DIR;
the checkout's sources are only read) whose run-carve is wrong:

  carve_no_lru     the run-carve skips the replay of the serial walks' LRU
                   accesses, so the core's LRU clock does not advance;
  carve_row_short  the run-carve's bulk refill leaves each carved row's
                   top entry unwritten.

1. chip_smoke's 512-core session (64 rounds at the paper's geometry, from
   ``--seed``) advances through `heap.step` with the sound kernel; each
   round's inputs also go through the sound kernel and `carve_no_lru`. A
   core whose clock differs between the two carved in that round. With
   the batched refill on, the cores that carved must be exactly those that
   `heap_step.backend_branch` (the plain helpers, on the pre-round state)
   sends to the run-carve, and at least one; with it off, none.
2. Each mutant goes through chip_smoke phase 3's check (kernel against the
   plain version on all 31 outputs, the session's first rounds at C=512)
   and the heap kernel's card tests of ``tests/test_torch_cuda.py``. Phase
   3 and the crafted branch test must fail, and phase 3 and every test
   with the batched refill off must pass; the mixed-stream tests with it
   on are reported (each of their streams carves a few core-rounds, not
   necessarily of the refill flavour that `carve_row_short` breaks).

Prints the counts and the checks' outcomes, and exits non-zero unless all
of the above hold.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CARD_TESTS = ("tests/test_torch_cuda.py::test_kernel_matches_plain_on_card",
              "tests/test_torch_cuda.py::"
              "test_kernel_takes_every_backend_branch_on_card")

# name -> (text of the sound source, its replacement)
MUTANTS = {
    "carve_no_lru": (
        "      lru.access(1, hh, mm);\n"
        "      for (int s = depth - 1; s >= 0; --s) "
        "lru.access(leaf >> s, hh, mm);\n"
        "      lru.up(leaf, depth, fast_up, hh, mm);\n",
        "      (void)leaf;\n"),
    "carve_row_short": (
        "        row[i] = i < sub ? off_t + i * csize : kInvalid;\n",
        "        row[i] = i < sub - 1 ? off_t + i * csize : kInvalid;\n"),
}


def mutate(text: str, name: str) -> str:
    old, new = MUTANTS[name]
    if text.count(old) != 1:
        raise RuntimeError(f"mutant {name}: its anchor is not in the source "
                           f"exactly once")
    return text.replace(old, new)


def session(seed, device):
    """(cfg, initial state, tape) of chip_smoke's main-path session."""
    import numpy as np
    import chip_smoke as cs
    from repro_torch.configs.paper_upmem import CONFIG
    from repro_torch.core import heap, system as sysm
    from repro_torch.core.pim_malloc import PimMallocConfig
    cfg = sysm.SystemConfig(
        kind="fused", heap_bytes=CONFIG.heap_bytes,
        num_threads=CONFIG.num_threads,
        pm=PimMallocConfig(heap_bytes=CONFIG.heap_bytes,
                           num_threads=CONFIG.num_threads,
                           size_classes=CONFIG.size_classes,
                           block_bytes=CONFIG.block_bytes))
    tape = cs.session_tape(np.random.default_rng(seed), cs.ROUNDS, cs.CORES,
                           cfg.num_threads)
    fresh = heap.init(cfg, num_cores=cs.CORES, device=device)
    return cfg, fresh, tape


def carved_cores(cfg, fresh, tape, device, sound, mutant, refill):
    """(core-rounds where the kernel carved, where the helpers say it
    should, core-rounds where the two differ) over the session."""
    import torch
    import chip_smoke as cs
    from repro_torch.core import heap
    from repro_torch.kernels import _build, heap_step
    state = cs.clone_state(fresh)
    sess = cs.slot_file(tape, device)
    kw = dict(cs.geometry(cfg), batch_refill=refill)
    n_kernel = n_helpers = n_apart = 0
    for r in range(cs.ROUNDS):
        req = sess.request(r)
        leaves = cs.state_args(state)
        outs = {}
        for name, lib in (("sound", sound), ("mutant", mutant)):
            _build._LOADED["heap_step"] = lib
            outs[name] = heap_step.fused_heap_step(
                *req, *(x.clone() for x in leaves), **kw)
        _build._LOADED["heap_step"] = sound
        kernel = outs["sound"].clock != outs["mutant"].clock
        helpers = cs.round_branches(cfg, req, outs["sound"], leaves[0]) == 1
        if not refill:  # the kernel may not carve at all
            helpers = torch.zeros_like(helpers)
        n_kernel += int(kernel.sum())
        n_helpers += int(helpers.sum())
        n_apart += int((kernel != helpers).sum())
        state, resp = heap.step(cfg, state, req)
        sess.record(r, req, resp)
    return n_kernel, n_helpers, n_apart


class Outcomes:
    """A pytest plugin that keeps each test's outcome."""

    def __init__(self):
        self.seen = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.seen[report.nodeid] = report.outcome


def card_tests():
    """{test id: outcome} of the heap kernel's card tests, run in this
    process with whatever library is bound to `heap_step`."""
    import pytest
    plugin = Outcomes()
    pytest.main(["-q", "-p", "no:cacheprovider", "--rootdir", str(ROOT),
                 *(str(ROOT / t) for t in CARD_TESTS)], plugins=[plugin])
    return plugin.seen


def refill_of(test_id):
    """The batched refill setting a card test runs with (None: both)."""
    if "[" not in test_id:
        return None
    return "True" in test_id.split("[", 1)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True, type=Path,
                    help="directory for the broken sources and libraries")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write results as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("heap_mutants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    args.work.mkdir(parents=True, exist_ok=True)
    sound_src = (_build.CSRC / "heap_step.cu").read_text()
    srcs = {}
    for name in MUTANTS:
        srcs[name] = args.work / f"heap_step_{name}.cu"
        srcs[name].write_text(mutate(sound_src, name))
    with ThreadPoolExecutor(max_workers=len(srcs) + 1) as ex:
        futs = [ex.submit(_build.build, "heap_step")]
        futs += [ex.submit(_build.compile_source, src,
                           src.with_suffix(".so")) for src in srcs.values()]
        for f in futs:
            f.result()
    sound = _build.load("heap_step")
    libs = {n: _build.bind(src.with_suffix(".so"), "heap_step")
            for n, src in srcs.items()}

    device = torch.device("cuda", 0)
    cfg, fresh, tape = session(args.seed, device)
    res, ok = {}, True
    try:
        for refill in (True, False):
            got, want, apart = carved_cores(cfg, fresh, tape, device, sound,
                                            libs["carve_no_lru"], refill)
            res[f"carved core-rounds, batch_refill {refill}"] = dict(
                kernel=got, helpers=want, apart=apart)
            good = apart == 0 and (got > 0 if refill else got == 0)
            ok &= good
            print(f"batch_refill {refill}: of {cs.ROUNDS * cs.CORES} "
                  f"core-rounds the kernel carved {got}, the helpers say "
                  f"{want}, {apart} apart -> {'ok' if good else 'FAILED'}")
        res["sound card tests"] = card_tests()
        ok &= all(v == "passed" for v in res["sound card tests"].values())
        for name, lib in libs.items():
            _build._LOADED["heap_step"] = lib
            phase3 = {}
            for refill in (True, False):
                try:
                    cs.phase_kernel_vs_plain(cfg, cs.clone_state(fresh), tape,
                                             cs.CHECK_ROUNDS, device,
                                             batch_refill=refill)
                    phase3[str(refill)] = "passed"
                except AssertionError as e:
                    phase3[str(refill)] = f"failed: {e}"
            tests = card_tests()
            _build._LOADED["heap_step"] = sound
            res[name] = dict(phase3=phase3, card_tests=tests)
            crafted = [t for t in tests if refill_of(t) is None]
            good = (phase3["True"] != "passed" and phase3["False"] == "passed"
                    and len(crafted) == 1 and tests[crafted[0]] == "failed"
                    and all(v == "passed" for t, v in tests.items()
                            if refill_of(t) is False))
            ok &= good
            mixed_on = [v for t, v in tests.items() if refill_of(t)]
            print(f"{name}: phase 3 with the batched refill on "
                  f"{phase3['True'].split(':')[0]}, off {phase3['False']}; "
                  f"crafted branch test {tests[crafted[0]] if crafted else '?'}"
                  f"; mixed-stream tests with the refill on failed "
                  f"{mixed_on.count('failed')} of {len(mixed_on)}, with it "
                  f"off passed {sum(v == 'passed' for t, v in tests.items() if refill_of(t) is False)}"
                  f" -> {'ok' if good else 'FAILED'}")
    finally:
        _build._LOADED["heap_step"] = sound
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print("the kernel carves on just the helpers' core-rounds, and the checks "
          "fail every broken run-carve" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
