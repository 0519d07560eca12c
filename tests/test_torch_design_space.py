"""The design-space model (Table 1 / Fig 5) and the rest of the DPU cost
model against the reference, on the CPU.

The 14 ``fig5`` rows of BENCH_BASELINE.json (read, never written) are a
JAX-free oracle: the port's `design_space.sweep` reproduces each row's
``us_per_call`` (and the winner's flat ratio) to 1e-9 relative, and the
qualitative shape of Fig 5 holds. `round_latency_cyc` and `cyc_to_us`
equal the reference's (float32, bitwise).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm

from repro_torch.core import cost_model as tcm
from repro_torch.core import design_space as ds

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9


def fig5_rows():
    doc = json.loads((ROOT / "BENCH_BASELINE.json").read_text())
    return doc["figs"]["fig5"]["records"]


def test_fig5_has_fourteen_rows():
    assert len(fig5_rows()) == 14


@pytest.mark.parametrize("row", fig5_rows(), ids=lambda r: r["name"])
def test_fig5_row_matches_baseline(row):
    """Each row as benchmarks/fig5_design_space.py derives it, with the
    core counts of the committed baseline (1, 8, 64)."""
    n_cores = (1, 8, 64)
    sweep = ds.sweep(n_cores_list=n_cores)
    name = row["name"]
    top = n_cores[-1]
    red = sweep["pim_meta_pim_exec"]
    if name.startswith("fig5/winner_scaling"):
        got = red[top]["total"]
        assert red[top]["total"] / red[1]["total"] == pytest.approx(
            row["flat_ratio"], rel=REL)
    elif name.startswith("fig5/worst_vs_winner"):
        got = max(sweep[s][top]["total"] for s in ds.STRATEGIES)
    else:
        _, strat, cores = name.split("/")
        r = sweep[strat][int(cores.split("=")[1])]
        got = r["total"]
        assert f"exec={r['exec']:.2f}us;xfer={r['xfer']:.2f}us" == \
            row["derived"]
        assert int(cores.split("=")[1]) * 1e6 / got == pytest.approx(
            row["allocs_per_sec"], rel=REL)
    assert got == pytest.approx(row["us_per_call"], rel=REL)


def test_fig5_qualitative_shape():
    sweep = ds.sweep(n_cores_list=(1, 64, 512))
    red = sweep["pim_meta_pim_exec"]
    # winner: flat in N
    assert abs(red[512]["total"] - red[1]["total"]) / red[1]["total"] < 1e-6
    # all others grow with N and are worse at 512 cores
    for s in ds.STRATEGIES:
        if s == "pim_meta_pim_exec":
            continue
        assert sweep[s][512]["total"] > sweep[s][1]["total"]
        assert sweep[s][512]["total"] > red[512]["total"], s
    # metadata movers are transfer-dominated at 512 cores (Fig 5b)
    for s in ("host_meta_pim_exec", "pim_meta_host_exec"):
        assert sweep[s][512]["xfer"] > sweep[s][512]["exec"] * 0.5, s


def test_round_latency_and_cyc_to_us_match_reference():
    rng = np.random.default_rng(0)
    C, T = 5, 16
    path = rng.integers(-1, 4, size=(C, T)).astype(np.int32)
    bpos = np.full((C, T), -1, np.int32)
    for c in range(C):
        users = np.nonzero(rng.random(T) < 0.5)[0]
        bpos[c, rng.permutation(users)] = np.arange(len(users))
    cyc = np.where(bpos >= 0, rng.integers(100, 4000, (C, T)), 0) \
        .astype(np.float32) + 0.5
    dpu = jcm.DPUCost()
    want = np.stack([np.asarray(jcm.round_latency_cyc(
        dpu, jnp.asarray(path[c]), jnp.asarray(bpos[c]),
        jnp.asarray(cyc[c]))) for c in range(C)])
    got = tcm.round_latency_cyc(tcm.DPUCost(), torch.from_numpy(path),
                                torch.from_numpy(bpos),
                                torch.from_numpy(cyc))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcm.cyc_to_us(tcm.DPUCost(), torch.from_numpy(want)).numpy(),
        np.asarray(jcm.cyc_to_us(dpu, jnp.asarray(want))))
    assert tcm.DPUCost() == tcm.DPUCost(**{
        f: getattr(dpu, f) for f in tcm.DPUCost.__dataclass_fields__})
    for cls in ("HostCost", "XferCost"):
        j, t = getattr(jcm, cls)(), getattr(tcm, cls)()
        assert vars(j) == vars(t)
    x = tcm.XferCost()
    assert x.h2p_s(1e6, 8) == jcm.XferCost().h2p_s(1e6, 8)
    assert x.p2h_s(1e6, 64) == jcm.XferCost().p2h_s(1e6, 64)
