"""The port's user surface against the reference's, on the CPU.

  * `repro_torch.core` re-exports what `repro.core` does, `__all__` in the
    same order; `system.KINDS` is the registry's `heap.kinds()` (the port's
    ``fused`` where the reference says ``pallas``), `heap.OP_NAMES` the
    reference's, `system.telemetry_init` zeroed int32 counters on the
    device asked for;
  * the six `examples/*_torch.py` run with ``--device cpu`` at smoke size:
    quickstart's facade and mixed-round lines (its pointers) equal the
    reference example's output, graph_update's rows at fig16's smoke
    partition equal the reference's committed fig16 rows, serve_decode's
    output equals the reference example's under ``--kind pallas``;
    serve_fleet (also under ``--chaos``), serve_paged and train_lm run
    their sessions to their last lines;
  * without a GPU each example raises unless asked for the CPU.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

import repro.core as jcore
from repro.core import heap as jheap
from repro.core import system as jsystem

import repro_torch.core as tcore
from repro_torch.core import heap as theap
from repro_torch.core import system as tsystem
from repro_torch.optim.adamw import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "graph_update", "serve_paged", "serve_decode",
            "serve_fleet", "train_lm")
GRAPH = dict(n_nodes=96, n_edges_pre=320, n_edges_new=160)  # fig16 smoke


def _example(name):
    """The module of examples/NAME.py (not a package: loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv):
    """(return value, stdout lines) of examples/NAME.py's main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _example(name).main(argv)
    return out, buf.getvalue().splitlines()


# ------------------------------------------------------------ core exports --
def test_core_exports_match_reference():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    from repro_torch.core import (Allocator, MultiCoreHeap, initAllocator,
                                  malloc_round, system_init)
    assert issubclass(Allocator, tcore.api.HeapClient)
    assert initAllocator is tcore.api.initAllocator
    assert MultiCoreHeap is theap.MultiCoreHeap
    assert system_init is tsystem.system_init
    assert malloc_round is tsystem.malloc_round
    for op in ("OP_NOOP", "OP_MALLOC", "OP_FREE", "OP_REALLOC", "OP_CALLOC"):
        assert getattr(tcore, op) == getattr(jcore, op), op


def test_kinds_op_names_and_telemetry_init():
    """`KINDS` is read from the registry on access; the reference's kinds
    are the port's with ``pallas`` -> ``fused`` (its registration order
    differs: it registers from two modules)."""
    assert tsystem.KINDS == theap.kinds()
    assert sorted(tsystem.KINDS) == sorted(
        "fused" if k == "pallas" else k for k in jsystem.KINDS)
    with pytest.raises(AttributeError):
        tsystem.NO_SUCH_NAME
    assert theap.OP_NAMES == jheap.OP_NAMES
    t = tsystem.telemetry_init("cpu")
    want = jsystem.telemetry_init()
    assert t._fields == want._fields
    for got, w in zip(t, want):
        assert got.device.type == "cpu" and got.dtype == torch.int32
        assert got.shape == () and int(got) == int(w) == 0
    assert t.live_bytes is not t.hwm_bytes


# ---------------------------------------------------------------- examples --
def test_quickstart_matches_reference_example():
    """The facade's and the mixed round's lines (pointers, stats, paths)
    equal the reference example's; the race prints one row a kind, fused
    == hwsw == sw, the straw-man slowest."""
    _, got = _run("quickstart_torch", ["--device", "cpu", "--cores", "2",
                                       "--rounds", "4"])
    ref = _example("quickstart")
    jsystem.KINDS = ()           # the race's kinds: none (it is the slow part)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.main()
    finally:
        del jsystem.KINDS        # back to the module's __getattr__
    want = buf.getvalue().splitlines()
    head = want.index("")
    assert got[:head] == want[:head]
    assert got[head + 1] == ("4 rounds x 2 cores x 16 threads x 32 B (DPU "
                             "cost model):")
    rows = {ln.split(":")[0].strip(): ln.split(":", 1)[1]
            for ln in got[head + 2:-1]}
    assert list(rows) == list(theap.kinds())
    assert rows["fused"] == rows["hwsw"] == rows["sw"]
    mean = {k: float(v.split()[1]) for k, v in rows.items()}
    assert mean["strawman"] == max(mean.values())
    assert got[-1] == "heap-step kernel launches: 0"


def test_graph_update_reproduces_the_references_fig16_rows():
    """At fig16's smoke partition the example's rows are the reference's
    committed `compare_all` output (BENCH_BASELINE.json's fig16 rows,
    ``pallas`` there for ``fused``): us/edge, edges/s, metadata bytes per
    new edge; and its table prints them."""
    rows, lines = _run("graph_update_torch", [
        "--device", "cpu", "--nodes", str(GRAPH["n_nodes"]), "--edges-pre",
        str(GRAPH["n_edges_pre"]), "--edges-new", str(GRAPH["n_edges_new"])])
    want = {r["name"].split("/")[1]: r for r in json.loads(
        (ROOT / "BENCH_BASELINE.json").read_text())["figs"]["fig16"]
        ["records"] if r["name"].startswith("fig16/")}
    assert list(rows) == ["static_csr", *theap.kinds()]
    for kind, got in rows.items():
        w = want["pallas" if kind == "fused" else kind]
        assert got["us_per_edge"] == pytest.approx(w["us_per_call"],
                                                   rel=1e-12, abs=0), kind
        assert got["edges_per_s"] == pytest.approx(w["allocs_per_sec"],
                                                   rel=1e-12, abs=0), kind
        if "dram_bytes" in got:
            assert got["dram_bytes"] / GRAPH["n_edges_new"] == \
                w["metadata_bytes_per_op"], kind
        row = f"{kind:22s} {w['us_per_call']:9.3f} " \
              f"{w['allocs_per_sec']:12.0f}"
        assert any(ln.startswith(row) for ln in lines), kind
    assert lines[0] == ("partition: 96 nodes, 320 pre-edges, 160 new edges "
                        "(1:2, paper methodology)")
    assert lines[-1] == "heap-step kernel launches: 0"


def test_serve_decode_matches_reference_example(monkeypatch):
    """At the reference example's defaults but 24 rounds (kind ``fused``
    against the reference's ``pallas``): the port's lines == the
    reference's."""
    rep, got = _run("serve_decode_torch", ["--device", "cpu", "--rounds",
                                           "24"])
    monkeypatch.setattr("sys.argv", ["serve_decode", "--kind", "pallas",
                                     "--rounds", "24"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("serve_decode").main()
    want = buf.getvalue().replace("kind=pallas", "kind=fused")
    assert got[:-1] == want.splitlines()
    assert got[-1] == "heap-step kernel launches: 0"
    assert rep["conservation_residual"] == 0


@pytest.mark.parametrize("chaos", [False, True])
def test_serve_fleet_serves_its_session(chaos):
    """The FleetServe session (and the elastic one under ``--chaos``):
    conservation holds, no free is dropped, the session's counters add
    up."""
    rep, got = _run("serve_fleet_torch", ["--device", "cpu", "--rounds",
                                          "24"] + (["--chaos"] if chaos
                                                   else []))
    assert rep["conservation_residual"] == 0 and rep["dropped_frees"] == 0
    assert rep["offered"] >= rep["dropped"] + rep["external_dispatched"]
    assert got[0].startswith("fleet [2 ranks x 2 cores x 4 threads] "
                             "kind=fused placement=round_robin")
    assert any(ln.startswith("chaos: ") for ln in got) == chaos
    assert got[-1] == "heap-step kernel launches: 0"


def test_serve_paged_serves_at_smoke_size():
    res, lines = _run("serve_paged_torch", ["--device", "cpu",
                                            "--decode-steps", "8"])
    assert res.logits_finite and res.stats["fails"] == 0
    assert res.tokens.shape == (4, 9)
    assert lines[-2].startswith("fleet (2 ranks): ")
    assert lines[-1] == "paged-attention kernel launches: 0"


def test_train_lm_recovers_from_its_injected_failure(tmp_path):
    (params, _), hist = _run("train_lm_torch", [
        "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)])[0]
    assert hist["recoveries"] == 1 and hist["steps"][-1] == 3
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_run_on_the_card_by_default(name, tmp_path):
    """No GPU here: each example raises instead of falling back."""
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(f"{name}_torch").main(argv)

