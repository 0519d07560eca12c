"""The port's dynamic-graph workload (`repro_torch.graphupd.workload`)
against the reference, on the CPU.

`DynamicGraph`'s serial splice (two threads inserting at one node in one
round chain in thread order; failed allocations write nothing) and its
host-mirror deletions are held to the reference's cells and list heads;
`compare_all` at the ``fig16`` smoke config to the reference's live output
and, through the reference's own benchmark code, to the 12 ``fig16`` rows
of BENCH_BASELINE.json (read, never written). The tolerance is exact
equality against the live reference and 1e-12 relative against the
committed rows.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graphupd import workload as jg

from repro_torch.core import api
from repro_torch.graphupd import workload as tg

BASELINE = Path(__file__).resolve().parents[1] / "BENCH_BASELINE.json"
SMOKE = dict(n_nodes=96, n_edges_pre=320, n_edges_new=160)


def _graphs(kind="sw", heap_bytes=1 << 19, n_nodes=24):
    kw = dict(n_nodes=n_nodes, n_edges_pre=0, n_edges_new=0, num_threads=4,
              heap_bytes=heap_bytes)
    return (jg.DynamicGraph(jg.GraphConfig(**kw), kind=kind),
            tg.DynamicGraph(tg.GraphConfig(**kw), kind=kind, device="cpu"))


def _same(jgraph, tgraph):
    np.testing.assert_array_equal(tgraph.heap.numpy(),
                                  np.asarray(jgraph.heap))
    np.testing.assert_array_equal(tgraph.head.numpy(),
                                  np.asarray(jgraph.head))
    for u in range(tgraph.cfg.n_nodes):
        assert tgraph.neighbors(u) == jgraph.neighbors(u), u


def _resp_equal(jr, tr):
    for f in jr._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)


def test_insert_and_delete_match_reference():
    """Same-node inserts in one round chain in thread order; deletions
    unlink the first match and free its cell; a miss frees nothing."""
    jgr, tgr = _graphs()
    rounds = [([1, 1, 2, 1], [2, 3, 3, 4]), ([3, 1, 1, 1], [1, 2, 5, 6]),
              ([0, 2], [7, 8])]
    for srcs, dsts in rounds:
        _resp_equal(jgr.insert_round(srcs, dsts),
                    tgr.insert_round(srcs, dsts))
        _same(jgr, tgr)
    assert tgr.neighbors(1) == [6, 5, 2, 4, 3, 2]
    for srcs, dsts in (([1, 2, 1], [3, 3, 6]), ([5], [9])):
        _resp_equal(jgr.delete_round(srcs, dsts),
                    tgr.delete_round(srcs, dsts))
        _same(jgr, tgr)
    assert tgr.neighbors(1) == [5, 2, 4, 2]


def test_failed_allocations_write_nothing():
    """A heap too small for every cell: threads whose malloc fails leave
    the cells and heads untouched (the exhausted tail of the stream)."""
    jgr, tgr = _graphs(kind="strawman", heap_bytes=1 << 9, n_nodes=4)
    rng = np.random.default_rng(1)
    fails = 0
    for _ in range(12):
        srcs, dsts = rng.integers(0, 4, 4), rng.integers(0, 4, 4)
        jr = jgr.insert_round(srcs, dsts)
        _resp_equal(jr, tgr.insert_round(srcs, dsts))
        fails += int((np.asarray(jr.ptr) < 0).sum())
        _same(jgr, tgr)
    assert fails > 0


def test_static_cost_and_edges_match_reference():
    for kw in (SMOKE, {}):
        jc, tc = jg.GraphConfig(**kw), tg.GraphConfig(**kw)
        for a, b in zip(jg.synth_edges(jc), tg.synth_edges(tc)):
            np.testing.assert_array_equal(a, b)
        (jl, ju), (tl, tu) = (jg.static_update_cost_us(jc),
                              tg.static_update_cost_us(tc))
        np.testing.assert_array_equal(tl, jl)
        assert tu == ju


def test_deprecated_alloc_hook_warns_once_and_serves():
    cfg = tg.GraphConfig(n_nodes=8, n_edges_pre=0, n_edges_new=0,
                         num_threads=4, heap_bytes=1 << 19)
    client = api.HeapClient(heap_bytes=cfg.heap_bytes, num_threads=4,
                            kind="sw", device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        g = tg.DynamicGraph(cfg, alloc=client)
    assert len([x for x in w if issubclass(x.category,
                                           DeprecationWarning)]) == 1
    assert g.client is client and g.alloc is client
    g.insert_round([1, 1], [2, 3])
    assert g.neighbors(1) == [3, 2]
    with pytest.raises(TypeError):
        tg.DynamicGraph(cfg, client=client, alloc=client)


def test_compare_all_smoke_matches_reference_live():
    got = tg.compare_all(tg.GraphConfig(**SMOKE), device="cpu")
    want = jg.compare_all(jg.GraphConfig(**SMOKE))
    assert set(got) == {"fused" if k == "pallas" else k for k in want}
    for k, v in want.items():
        assert got["fused" if k == "pallas" else k] == v, k


def test_compare_all_smoke_reproduces_the_fig16_baseline_rows(monkeypatch):
    """The reference's own fig16 benchmark code over the port's functions
    (``fused`` reported as ``pallas``) gives the 12 committed rows."""
    from benchmarks import fig16_graph

    def compare_all(cfg):
        out = tg.compare_all(cfg, device="cpu")
        return {("pallas" if k == "fused" else k): v for k, v in out.items()}

    monkeypatch.setattr(fig16_graph, "GraphConfig", tg.GraphConfig)
    monkeypatch.setattr(fig16_graph, "compare_all", compare_all)
    monkeypatch.setattr(fig16_graph, "run_dynamic",
                        lambda cfg, kind: tg.run_dynamic(cfg, kind, "cpu"))
    got = {r["name"]: r for r in fig16_graph.bench(smoke=True)}
    rows = json.loads(BASELINE.read_text())["figs"]["fig16"]["records"]
    assert len(rows) == 12 and set(got) == {r["name"] for r in rows}
    for row in rows:
        rec = got[row["name"]]
        assert rec["derived"] == row["derived"], row["name"]
        for key, want in row.items():
            if isinstance(want, float):
                assert rec[key] == pytest.approx(want, rel=1e-12, abs=0), \
                    (row["name"], key)


def test_graph_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.DynamicGraph(tg.GraphConfig(n_nodes=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.compare_all(tg.GraphConfig(**SMOKE))
