"""pimcheck through the port: recorded rounds, passes, fixtures, tape lint,
CLI, against the reference's.

* every port fixture is flagged by the pass that flags the reference's
  fixture of the same name, and leaving that pass out misses it;
* every registered kind records clean on all three tiers, with no
  suppression doing the work;
* `lint_tapes` gives the reference's verdicts on the committed tapes and
  on racy tapes;
* the CLI is green on real kinds, red on a bad tape, red when a pass is
  disabled for its fixture, and writes the step summary;
* the recorder keeps values by storage and version (views, in-place
  writes), and descends into a kernel operator's plain version: ``fused``
  recorded through ``repro_torch::heap_step`` (a CPU implementation is
  registered here for the test: the plain version written back in place)
  is one node a round with the plain version's ops under it, and clean.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from repro.analysis import fixtures as rfixtures  # noqa: E402
from repro.analysis import passes as rpasses  # noqa: E402
from repro.analysis import pimcheck as rpimcheck  # noqa: E402
from repro.workloads.trace import Trace as RTrace  # noqa: E402
from repro_torch.analysis import fixtures, passes, pimcheck  # noqa: E402
from repro_torch.analysis import trace_utils as tu  # noqa: E402
from repro_torch.core import heap  # noqa: E402
from repro_torch.kernels import heap_step  # noqa: E402
from repro_torch.workloads.trace import Trace, trace_lint  # noqa: E402

CPU = "cpu"
FUSED = heap_step.fused_heap_step  # the wrapper: the plain version on CPU


# ---------------------------------------------------------------- fixtures
def test_every_fixture_is_flagged_by_the_reference_pass():
    rows, failures = pimcheck.check_fixtures(device=CPU)
    assert failures == []
    assert {r["target"] for r in rows} == {
        f"fixture:{n}" for n in rfixtures.FIXTURES}
    for name, (_fn, expect) in fixtures.FIXTURES.items():
        assert rfixtures.FIXTURES[name][1] == expect
        ref, _ = rpasses.run_passes(rpimcheck.trace_fixture(name))
        port, _ = passes.run_passes(pimcheck.trace_fixture(name, CPU))
        assert expect in {f.pass_name for f in ref}
        assert expect in {f.pass_name for f in port}, \
            [f.fmt() for f in port]
        assert all(f.severity in ("error", "warn") for f in port)


@pytest.mark.parametrize("left_out", passes.PASS_NAMES)
def test_leaving_out_a_pass_misses_its_fixture(left_out):
    keep = tuple(p for p in passes.PASS_NAMES if p != left_out)
    _, failures = pimcheck.check_fixtures(keep, device=CPU)
    missed = [n for n, (_f, p) in fixtures.FIXTURES.items()
              if p == left_out]
    assert len(failures) == len(missed) == 1
    assert f"fixture {missed[0]}:" in failures[0]


# ----------------------------------------------------- real kinds are green
@pytest.mark.parametrize("tier", pimcheck.TIERS)
def test_all_registered_kinds_are_clean(tier):
    rows, active, suppressed = pimcheck.check_kinds(
        heap.kinds(), (tier,), device=CPU)
    assert active == [], [f.fmt() for f in active]
    assert suppressed == []
    assert len(rows) == len(heap.kinds()) == 7
    assert all(r["ops"] > 0 and r["kernel_nodes"] == {} for r in rows)


def test_trace_kind_exposes_calling_convention():
    tr = pimcheck.trace_kind("hwsw", "single", device=CPU)
    assert tr.target == "hwsw" and tr.tier == "single"
    assert [tu.sig(t) for t in tr.state_in] == \
        [tu.sig(t) for t in tr.state_out]
    assert len(tr.req_in) == 3 and tr.threads == 4
    # the state is updated in place: every large leaf comes back on its
    # own storage
    big = [(a, b) for a, b in zip(tr.state_in, tr.state_out)
           if a.numel >= 64]
    assert big and all(a.val[0] == b.val[0] for a, b in big)


def test_suppression_mechanism(monkeypatch):
    import dataclasses
    f = passes.Finding("int-width", "hwsw", "single", "error",
                       "synthetic 64-bit dtype for the mechanism test")
    assert passes.suppression_for(f) is None
    monkeypatch.setattr(passes, "SUPPRESSIONS", (
        ("int-width", "hw*", "64-bit", "mechanism test entry"),))
    assert passes.suppression_for(f) == "mechanism test entry"
    for change in (dict(pass_name="donation"), dict(target="sw"),
                   dict(message="no match here")):
        assert passes.suppression_for(dataclasses.replace(f, **change)) \
            is None


def test_shipped_suppression_list_is_empty():
    assert passes.SUPPRESSIONS == () == rpasses.SUPPRESSIONS


# ---------------------------------------------------------- the recorder
def test_recorder_values_follow_storages_and_versions():
    def fn(x):
        v = x[0]             # a view: x's value
        v.add_(1)            # the next version of x's storage
        y = torch.arange(4).clamp(0, 2)
        return x[:, y]

    rec, _ = tu.record(fn, torch.zeros(3, 4))
    (arg,) = rec.arguments
    names = [op.name for op in rec.ops]
    assert names[:2] == ["aten::select", "aten::add_"]
    sel, add = rec.ops[:2]
    assert sel.outputs[0].val == arg.val          # a view reads its base
    assert add.writes[0].val == (arg.val[0], 1)   # in place: version 1
    prods = tu.producers(rec.ops)
    idx = next(op for op in rec.ops if op.kind == "index")
    assert tu.derives_from(idx.args["indices"][1].val,
                           lambda o: o.kind == "arange", prods)
    assert rec.creator[idx.fresh[0].val[0]] is idx


@pytest.fixture
def heap_step_on_cpu(monkeypatch):
    """`repro_torch::heap_step` with a CPU implementation (the plain
    version, written back in place, as the kernel updates its state), and
    `fused_heap_step` routed through the operator on CPU tensors."""
    def cpu_impl(op, size, ptr, *rest):
        out = heap_step._plain(op, size, ptr, *rest)
        for dst, src in zip(rest[:heap_step.N_STATE], out):
            dst.copy_(src)
        return out[-1]

    def via_op(op, size, ptr, *state, heap_bytes, block_bytes, size_classes,
               batch_refill=None):
        rec = heap_step._OP(op, size, ptr, *state, heap_bytes, block_bytes,
                            list(size_classes), batch_refill is not False)
        return heap_step.FusedRoundOut(*state, *rec.unbind(0))

    lib = torch.library.Library("repro_torch", "IMPL")
    lib.impl("heap_step", cpu_impl, "CPU")
    monkeypatch.setattr(heap_step, "fused_heap_step", via_op)
    yield
    lib._destroy()


@pytest.mark.parametrize("tier", pimcheck.TIERS)
def test_fused_through_the_operator_is_one_node_checked_by_its_plain_version(
        heap_step_on_cpu, tier):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(heap_step, "fused_heap_step", FUSED)
        plain = pimcheck.trace_kind("fused", tier, device=CPU)
    rows, active, _ = pimcheck.check_kinds(("fused",), (tier,), device=CPU)
    assert active == [] and rows[0]["kernel_nodes"] == {
        "repro_torch::heap_step": 1}
    tr = pimcheck.trace_kind("fused", tier, device=CPU)
    (node,) = [op for op in tr.ops if op.name == "repro_torch::heap_step"]
    assert len(node.writes) == heap_step.N_STATE and node.sub
    assert len(node.sub_out) == len(node.results) == heap_step.N_STATE + 1
    # the node's plain version is the round the CPU runs: the same ops,
    # but the node and its records' unbind (the plain version returns them
    # apart), the records' stack, and the CPU wrapper's copies into the
    # state
    from collections import Counter
    assert node.sub[-1].kind == "stack"
    top = Counter(op.name for op in tr.ops) + Counter(
        op.name for op in node.sub)
    top -= Counter({"repro_torch::heap_step": 1, "aten::unbind": 1,
                    "aten::stack": 1})
    top["aten::copy_"] += heap_step.N_STATE
    assert top == Counter(op.name for op in plain.ops)
    # every state leaf the node writes is updated in place
    assert {t.val[0] for t in node.writes} <= {t.val[0]
                                                for t in tr.state_in}


# ---------------------------------------------------------------- tape lint
def _tapes(op, size, ptr_ref, ptr_raw, T=4):
    kw = dict(name="synthetic", heap_bytes=1 << 18, num_threads=T,
              recorded_kind="hwsw", description="lint unit tape",
              op=np.asarray(op, np.int32), size=np.asarray(size, np.int32),
              ptr_ref=np.asarray(ptr_ref, np.int32),
              ptr_raw=np.asarray(ptr_raw, np.int32))
    return Trace(**kw), RTrace(**kw)


@pytest.mark.parametrize("case", [
    ([[1, 1, 0, 0], [2, 2, 0, 0]], [[64, 64, 0, 0], [0] * 4],
     [[-1] * 4, [0, 1, -1, -1]], [[-1] * 4, [0, 64, -1, -1]]),
    ([[1, 0, 0, 0], [2, 3, 0, 0]], [[64, 0, 0, 0], [0, 128, 0, 0]],
     [[-1] * 4, [0, 0, -1, -1]], [[-1] * 4, [0, 0, -1, -1]]),
    ([[2, 1, 0, 0]], [[0, 64, 0, 0]], [[-1] * 4],
     [[12345, -1, -1, -1]]),
    ([[9, 0, 0, 0]], [[0] * 4], [[-1] * 4], [[-1] * 4]),
], ids=["clean", "race-A", "race-B", "unknown-op"])
def test_lint_matches_reference_on_synthetic_tapes(case, tmp_path):
    port, ref = _tapes(*case)
    from repro.workloads.trace import trace_lint as rlint
    assert trace_lint(port) == rlint(ref)
    path = tmp_path / "t.json"
    port.save(str(path))
    rows, errors = pimcheck.lint_tapes([str(path)])
    rrows, rerrors = rpimcheck.lint_tapes([str(path)])
    assert rows == rrows and errors == rerrors


def test_lint_tapes_matches_reference_on_committed_tapes():
    import glob
    paths = sorted(glob.glob(pimcheck.DEFAULT_TAPES))
    assert len(paths) == 4
    rows, errors = pimcheck.lint_tapes(paths)
    assert (rows, errors) == rpimcheck.lint_tapes(paths)
    assert errors == [] and all(r["findings"] == 0 for r in rows)


# ----------------------------------------------------------------- the CLI
def test_cli_green_on_real_kinds(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = pimcheck.main(["--kinds", "strawman,sw", "--tiers", "single",
                        "--device", CPU, "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["findings"] == [] and len(report["rows"]) == 2
    assert "pimcheck" in capsys.readouterr().out


def test_cli_red_on_bad_tape(tmp_path):
    bad, _ = _tapes([[2, 1, 0, 0]], [[0, 64, 0, 0]], [[-1] * 4],
                    [[777, -1, -1, -1]])
    path = tmp_path / "bad.json"
    bad.save(str(path))
    assert pimcheck.main(["--tiers", "single", "--device", CPU,
                          "--tapes", str(path)]) == 1


def test_cli_red_when_a_pass_is_disabled_for_its_fixture():
    assert pimcheck.main(["--tiers", "single", "--fixtures", "--device",
                          CPU, "--passes", "donation"]) == 1
    assert pimcheck.main(["--fixtures", "--device", CPU]) == 0


def test_cli_step_summary_written(tmp_path, monkeypatch):
    summary = tmp_path / "summary.md"
    monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(summary))
    rc = pimcheck.main(["--kinds", "strawman", "--tiers", "single",
                        "--device", CPU])
    assert rc == 0
    text = summary.read_text()
    assert "## pimcheck" in text and "✅" in text
    assert "| strawman | single | 0 | 0 |" in text
