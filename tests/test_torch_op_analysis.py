"""Op-level accounting (`repro_torch.launch.op_analysis`) against the
reference's loop-aware HLO accounting (`repro.launch.hlo_analysis`).

The port counts what a recorded call runs, so its Python loops are
unrolled: a chain of products, a loop of N and nested loops equal the
reference's loop-scaled counts of the same programs (a scan of trip count
N, nested scans) exactly, and so does granite-3-8b reduced (2 layers):
its forward loss has the reference's FLOPs to the unit. Collective bytes
come from the ``_c10d_functional`` ops (a one-rank gloo group), live
bytes from the storages the recorder saw allocated and freed, and the
attention kernels' operators count their two products.
"""
import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import trace_utils  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

def _ref_flops(f, *sds):
    return H.analyze(jax.jit(f).lower(*sds).compile().as_text())[
        "flops_scaled"]


def _flops(fn, *args):
    rec, _ = trace_utils.record(fn, *args, descend=False)
    return op_analysis.analyze(rec)["flops"]


def test_dot_chain_equals_reference():
    def ref(x, w):
        for _ in range(3):
            x = jnp.tanh(x @ w)
        return x

    def port(x, w):
        for _ in range(3):
            x = torch.tanh(x @ w)
        return x

    want = _ref_flops(ref, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                      jax.ShapeDtypeStruct((128, 128), jnp.float32))
    got = _flops(port, torch.randn(64, 128), torch.randn(128, 128))
    assert got == want == 3 * 2 * 64 * 128 * 128


def test_loop_equals_reference_scan_trip_count():
    def body(x, w):
        return jnp.tanh(x @ w), None

    def ref(x, ws):
        return lax.scan(body, x, ws)[0]

    def port(x, ws):
        for i in range(5):
            x = torch.tanh(x @ ws[i])
        return x

    want = _ref_flops(ref, jax.ShapeDtypeStruct((32, 64), jnp.float32),
                      jax.ShapeDtypeStruct((5, 64, 64), jnp.float32))
    got = _flops(port, torch.randn(32, 64), torch.randn(5, 64, 64))
    assert got == want == 5 * 2 * 32 * 64 * 64


def test_nested_loops_equal_reference_multipliers():
    def body(x, w):
        return jnp.tanh(x @ w), None

    def ref(x, ws):
        def outer(c, _):
            return lax.scan(body, c, ws)[0], None
        return lax.scan(outer, x, None, length=3)[0]

    def port(x, ws):
        for _ in range(3):
            for i in range(4):
                x = torch.tanh(x @ ws[i])
        return x

    want = _ref_flops(ref, jax.ShapeDtypeStruct((32, 64), jnp.float32),
                      jax.ShapeDtypeStruct((4, 64, 64), jnp.float32))
    got = _flops(port, torch.randn(32, 64), torch.randn(4, 64, 64))
    assert got == want == 12 * 2 * 32 * 64 * 64


def test_granite_reduced_loss_flops_match_reference():
    cfg = dataclasses.replace(configs.get("granite_3_8b").reduced(),
                              n_layers=2)
    rcfg = dataclasses.replace(rconfigs.get("granite_3_8b").reduced(),
                               n_layers=2)
    B, S = 2, 64
    from repro.models import registry as rregistry
    p_sds = rregistry.param_sds(rcfg)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    want = _ref_flops(lambda p, b: rtransformer.loss(rcfg, p, b)[0], p_sds,
                      {"tokens": tok, "labels": tok})
    params = registry.init(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32)
    got = _flops(lambda p, b: transformer.loss(cfg, p, b)[0], params,
                 {"tokens": toks, "labels": toks.clone()})
    assert got == want


def test_collective_bytes_on_a_one_rank_group(tmp_path):
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x = torch.randn(8, 128)
        rec, y = trace_utils.record(
            lambda t: fc.wait_tensor(fc.all_reduce(t * 2, "sum",
                                                   dist.group.WORLD)), x)
        ana = op_analysis.analyze(rec)
        assert torch.equal(y, x * 2)
        assert ana["collective_bytes"] == 8 * 128 * 4
        assert ana["collective_bytes_by_op"] == {"all_reduce": 8 * 128 * 4}
        sched = op_analysis.collective_schedule(rec)
        assert ana["collective_bytes_by_axis"] == {"group of 1": 8 * 128 * 4}
        assert sched == [{"op": "all_reduce", "shape": ((8, 128),),
                          "axis": "group of 1", "times": 1,
                          "bytes": 8 * 128 * 4}]
        axes = {dist.group.WORLD.group_name: "world"}
        assert op_analysis.collective_schedule(rec, axes=axes)[0][
            "axis"] == "world"
    finally:
        dist.destroy_process_group()


def test_live_and_memory_bytes():
    """Argument, output and peak bytes follow the storages; views and
    expand produce no bytes; an in-place update writes its view."""
    def fn(x):
        y = x * 2          # 4 KiB
        v = y.t()          # a view: nothing
        e = v[:1].expand(32, 32)  # nothing
        z = v + e          # 4 KiB
        del y, v, e
        z[0].add_(1)       # writes 128 B in place
        return z

    x = torch.randn(32, 32)
    rec, _ = trace_utils.record(fn, x)
    ana = op_analysis.analyze(rec)
    kb = 32 * 32 * 4
    assert ana["argument_bytes"] == kb
    assert ana["output_bytes"] == kb
    assert ana["peak_bytes"] == 3 * kb
    assert ana["memory_bytes"] == 2 * (kb + kb + 32 * 4)
    assert ana["flops"] == 0


def test_attention_kernel_nodes_count_their_products():
    """A paged-attention operator node counts 4 B H D over the page
    table's positions (its CPU implementation registered here for the
    test: the plain version)."""
    lib = torch.library.Library("repro_torch", "IMPL")
    lib.impl("paged_attention", pa.paged_attention_plain, "CPU")
    try:
        B, H, KVH, D, N, page, P = 2, 4, 2, 16, 6, 8, 3
        q = torch.randn(B, H, D)
        kp = torch.randn(N, page, KVH, D)
        pt = torch.arange(B * P, dtype=torch.int32).reshape(B, P) % N
        sl = torch.tensor([5, 20], dtype=torch.int32)
        rec, out = trace_utils.record(pa._OP, q, kp, kp, pt, sl,
                                      descend=False)
        ana = op_analysis.analyze(rec)
        assert ana["kernel_nodes"] == {"repro_torch::paged_attention": 1}
        assert ana["flops"] == 4 * B * H * D * P * page
        assert torch.equal(out, pa.paged_attention_plain(q, kp, kp, pt, sl))
    finally:
        lib._destroy()
    assert op_analysis.attention_pairs(4, 4, True, 0) == 10
    assert op_analysis.attention_pairs(4, 4, True, 2) == 7
    assert op_analysis.attention_pairs(3, 5, False, 0) == 15
